"""Step factories of the port, mirroring ``repro.training``: so far the
inference prefill step on one device."""
from repro_torch.training.train import make_prefill_step

__all__ = ["make_prefill_step"]
