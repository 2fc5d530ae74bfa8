"""mistral-nemo-12b [dense]: 128k ctx, explicit head_dim=128
[hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1e6,
)
