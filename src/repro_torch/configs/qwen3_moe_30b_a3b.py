"""qwen3-moe-30b-a3b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=0,                # all-MoE FFN
    vocab=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    rope_theta=1e6,
)
