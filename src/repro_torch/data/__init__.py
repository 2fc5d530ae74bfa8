"""The synthetic token pipeline, a copy of ``repro.data``."""
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticTokens, make_pipeline

__all__ = ["DataConfig", "Prefetcher", "SyntheticTokens", "make_pipeline"]
