"""Model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / MLA / SSM / hybrid / VLM / audio
backbones; family-specific fields are ignored by other families.  Exact
assigned configs live in ``repro/configs/<arch>.py``; reduced smoke
variants are derived with ``reduced()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0  # per-expert FFN width (d_ff is the dense-block width)

    # -- MLA (DeepSeek-V2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64  # decoupled RoPE key dimension
    nope_head_dim: int = 0   # defaults to head_dim

    # -- SSM (Mamba2 / SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4
    ssm_groups: int = 1    # B/C projections shared across heads (Mamba2)

    # -- hybrid (Zamba2-style) ----------------------------------------------------
    attn_period: int = 6  # shared attention block applied every N ssm blocks

    # -- VLM ----------------------------------------------------------------------
    use_mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2
    n_vision_tokens: int = 0  # prefix patch embeddings provided by the stub

    # -- audio (Whisper-style enc-dec) ------------------------------------------------
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500  # 30 s of 10 ms frames after conv stub

    # -- serving -----------------------------------------------------------------------
    sliding_window: Optional[int] = None  # ring-buffer decode window

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.arch_type not in (
            "dense", "moe", "ssm", "hybrid", "vlm", "audio"
        ):
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def group_size(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    # -- parameter counting (roofline MODEL_FLOPS) --------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; ``active_only`` counts only the
        parameters touched per token (MoE: top_k + shared experts)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.use_mla:
                q = d * self.n_heads * (self.hd + self.rope_head_dim)
                kv_a = d * (self.kv_lora_rank + self.rope_head_dim)
                kv_b = self.kv_lora_rank * self.n_heads * (self.hd + self.hd)
                o = self.n_heads * self.hd * d
                return q + kv_a + kv_b + o
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(width: int) -> int:
            return 3 * d * width  # SwiGLU: gate+up+down

        def moe_params() -> int:
            router = d * self.n_experts
            experts = self.n_experts * mlp_params(self.d_ff_expert)
            shared = self.n_shared_experts * mlp_params(self.d_ff_expert)
            if active_only:
                experts = self.top_k * mlp_params(self.d_ff_expert)
            return router + experts + shared

        def ssm_params() -> int:
            di = self.d_inner
            gn = self.ssm_groups * self.ssm_state
            in_proj = d * (2 * di + 2 * gn + self.n_ssm_heads)
            conv = (di + 2 * gn) * self.conv_kernel
            out = di * d
            return in_proj + conv + out + di

        per_layer = 0
        if self.arch_type in ("dense", "vlm"):
            per_layer = attn_params() + mlp_params(self.d_ff)
            total = self.n_layers * per_layer
        elif self.arch_type == "moe":
            total = self.n_layers * (attn_params() + moe_params())
        elif self.arch_type == "ssm":
            total = self.n_layers * ssm_params()
        elif self.arch_type == "hybrid":
            n_shared_applications = self.n_layers // self.attn_period
            shared_block = attn_params() + mlp_params(self.d_ff)
            total = self.n_layers * ssm_params() + shared_block  # weights shared
            del n_shared_applications
        elif self.arch_type == "audio":
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff))
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff))
            total = enc + dec
        else:  # pragma: no cover
            raise AssertionError
        return int(total + emb)

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
        kw = dataclasses.asdict(self)
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        if heads and (kv == 0 or heads % kv):
            kv = 1
        hd = d // heads if heads else None
        sections = (
            (hd // 4, hd // 8, hd // 8) if heads else self.mrope_sections
        )
        kw.update(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_ff_expert=min(self.d_ff_expert, 128),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            q_lora_rank=min(self.q_lora_rank, 32),
            rope_head_dim=min(self.rope_head_dim, 16),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=16,
            attn_period=2,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            n_audio_frames=32 if self.arch_type == "audio" else self.n_audio_frames,
            mrope_sections=sections,
            sliding_window=(64 if self.sliding_window else None),
        )
        kw.update(overrides)
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
