"""whisper-medium [audio]: enc-dec, mel/conv frontend is a stub supplying
frame embeddings [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,           # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    head_dim=64,
    n_encoder_layers=24,
    n_audio_frames=1500,
)
