"""Serving DFGs whose vertices are the assigned architectures, copied from
the JAX package onto the port's configs; R(t) is priced at the rate the
port reaches on an H100 instead of a TPU's.

This closes the loop between the two halves of the repo: Navigator
schedules *workflows of models*, and the assigned-architecture zoo
provides the models.  Each pipeline mirrors a realistic multi-model
serving pattern; profiles (runtime, model bytes) derive from the configs
so the scheduler sees the real size/compute asymmetries (e.g. the MoE
model is huge to cache but cheap to run — exactly the regime where
Navigator's cache-aware placement matters most; DESIGN.md §4).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import ARCHS
from repro_torch.core.types import DFG, MB, MLModel, TaskSpec

# model-id assignments within the SST's 0..63 space
ARCH_MODEL_IDS: Dict[str, int] = {
    name: i for i, name in enumerate(sorted(ARCHS))
}

# Serving runtime estimate: ~2·N_active·D / (utilized flops); coarse but
# keeps relative magnitudes right for the scheduler.  The rate is the bf16
# rate an H100 reaches in a dense prefill: 2·N·tokens of mistral-nemo-12b
# (N = 12,247,367,680) at B=2, S=2048, 1.0033e14 FLOP, over the wall time
# of its second ``make_prefill_step`` call in ``chip_smoke.py`` phase 3b,
# 0.1944 s on an "NVIDIA H100 80GB HBM3, 700.00 W" card; phase 5b fails
# when a run's reading strays more than 25 % from it.
_UTILIZED_FLOPS = 5.16e14


def _serve_runtime_s(arch: str, tokens: int = 256) -> float:
    cfg = ARCHS[arch]
    n = cfg.param_count(active_only=cfg.arch_type == "moe")
    return max(2.0 * n * tokens / _UTILIZED_FLOPS, 1e-3)


def arch_models() -> Dict[int, MLModel]:
    out = {}
    for name, mid in ARCH_MODEL_IDS.items():
        cfg = ARCHS[name]
        out[mid] = MLModel(mid, name, float(cfg.param_count() * 2))  # bf16
    return out


def _task(tid: str, arch: str, tokens: int = 256, out_mb: float = 0.05,
          in_mb: float = 0.05) -> TaskSpec:
    return TaskSpec(
        tid,
        _serve_runtime_s(arch, tokens),
        model_id=ARCH_MODEL_IDS[arch],
        output_bytes=out_mb * MB,
        input_bytes=in_mb * MB,
    )


def speculative_pipeline() -> DFG:
    """Draft (mamba2, O(1)-state) → verify (llama3) → safety (nemo)."""
    return DFG(
        "spec_decode",
        tasks=[
            _task("draft", "mamba2-780m", tokens=512),
            _task("verify", "llama3-405b", tokens=64),
            _task("safety", "mistral-nemo-12b", tokens=64),
        ],
        edges=[("draft", "verify"), ("verify", "safety")],
    )


def multimodal_pipeline() -> DFG:
    """Transcribe (whisper) ∥ perceive (qwen2-vl) → reason (deepseek MoE)."""
    return DFG(
        "multimodal_assist",
        tasks=[
            _task("transcribe", "whisper-medium", tokens=128, in_mb=2.0),
            _task("perceive", "qwen2-vl-72b", tokens=256, in_mb=4.0),
            _task("reason", "deepseek-v2-236b", tokens=256),
        ],
        edges=[("transcribe", "reason"), ("perceive", "reason")],
    )


def code_pipeline() -> DFG:
    """Route (qwen3 MoE) → generate (granite code) → review (mistral-large)."""
    return DFG(
        "code_assist",
        tasks=[
            _task("route", "qwen3-moe-30b-a3b", tokens=64),
            _task("generate", "granite-20b", tokens=512),
            _task("review", "mistral-large-123b", tokens=256),
        ],
        edges=[("route", "generate"), ("generate", "review")],
    )


def longdoc_pipeline() -> DFG:
    """Skim (zamba2 hybrid, long-context) → answer (mistral-large)."""
    return DFG(
        "longdoc_qa",
        tasks=[
            _task("skim", "zamba2-7b", tokens=2048, in_mb=8.0),
            _task("answer", "mistral-large-123b", tokens=256),
        ],
        edges=[("skim", "answer")],
    )


def arch_dfgs() -> List[DFG]:
    return [
        speculative_pipeline(),
        multimodal_pipeline(),
        code_pipeline(),
        longdoc_pipeline(),
    ]
