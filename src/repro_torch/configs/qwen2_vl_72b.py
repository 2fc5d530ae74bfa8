"""qwen2-vl-72b [vlm]: M-RoPE, dynamic-resolution ViT frontend (stub)
[arXiv:2409.12191].  input_specs() supplies patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    use_mrope=True,
    mrope_sections=(16, 24, 24),
    n_vision_tokens=1024,
    rope_theta=1e6,
)
