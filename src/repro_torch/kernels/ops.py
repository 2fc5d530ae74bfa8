"""Wrappers that dispatch between the hand-written kernels and the plain
PyTorch oracles.

``impl`` semantics (the reference's vocabulary, plus ``kernel``):
  "ref"         — :mod:`repro_torch.kernels.ref`, the mirror of the JAX oracle.
  "ref_grouped" — the grouped-query oracle (attention only; others use ref).
  "kernel"      — the kernel's wrapper: it launches the CUDA kernel for a
                  CUDA tensor (or raises) and runs the kernel's plain twin
                  for a CPU tensor.
  "auto"        — the same as "kernel": the tensor's device decides.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref as _ref

IMPLS = ("ref", "ref_grouped", "kernel", "auto")


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    if impl == "ref":
        return _ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
    if impl == "ref_grouped":
        return _ref.decode_attention_grouped_ref(q, k_cache, v_cache, cache_len)
    if impl in ("kernel", "auto"):
        return _da.decode_attention(q, k_cache, v_cache, cache_len)
    raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def ssd_decode(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step SSD (no kernel: elementwise work and a small matvec)."""
    return _ref.ssd_decode_ref(x, dt, a, b, c, state)
