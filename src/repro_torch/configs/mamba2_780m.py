"""mamba2-780m [ssm]: attention-free SSD backbone [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,       # d_inner = 3072 → 48 SSD heads
    ssm_expand=2,
    ssm_chunk=128,
    conv_kernel=4,
)
