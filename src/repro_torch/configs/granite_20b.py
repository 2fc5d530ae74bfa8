"""granite-20b [dense]: llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,          # MQA
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    rope_theta=1e4,
)
