"""deepseek-v2-236b [moe]: MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # MLA: per-head K/V reconstructed from the latent
    d_ff=0,
    vocab=102400,
    head_dim=128,          # nope head dim
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1536,
)
