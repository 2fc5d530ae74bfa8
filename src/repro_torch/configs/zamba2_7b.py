"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block applied
every 6 layers [arXiv:2411.15242].  The shared block's sliding window makes
long_500k decode natural (window cache is O(window))."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,       # d_inner = 7168 → 112 SSD heads
    ssm_expand=2,
    ssm_chunk=128,
    attn_period=6,
    sliding_window=4096,
)
