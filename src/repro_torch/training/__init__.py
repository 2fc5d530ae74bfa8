"""Training on one device, mirroring ``repro.training``: AdamW, checkpoints
in the reference's layout, and the train, serve and prefill step
factories."""
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.train import make_prefill_step, make_serve_step, make_train_step

__all__ = ["checkpoint", "make_prefill_step", "make_serve_step", "make_train_step", "optimizer"]
