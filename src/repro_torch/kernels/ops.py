"""Wrappers that dispatch between the hand-written kernels and the plain
PyTorch oracles.

``impl`` semantics (the reference's vocabulary, plus ``kernel``):
  "ref"            — :mod:`repro_torch.kernels.ref`, the mirror of the JAX
                     oracle (for ``ssd_scan``: the chunked dual form).
  "ref_grouped"    — the grouped-query oracle (decode attention; the
                     others treat it as "ref").
  "ref_chunked"    — the online-softmax oracle over KV chunks (flash
                     attention; the others treat it as "ref").
  "ref_sequential" — the per-step SSD recurrence (``ssd_scan`` only; the
                     others treat it as "ref").
  "kernel"         — the kernel's wrapper: it launches the CUDA kernel for
                     a CUDA tensor (or raises) and runs the kernel's plain
                     twin for a CPU tensor.
  "auto"           — the same as "kernel": the tensor's device decides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd

IMPLS = ("ref", "ref_grouped", "ref_chunked", "ref_sequential", "kernel", "auto")


def _unknown(impl: str) -> ValueError:
    return ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D) → (B, Sq, H, D)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if impl in ("ref", "ref_grouped", "ref_sequential"):
        return _ref.attention_ref(q, k, v, **kw)
    if impl == "ref_chunked":
        return _ref.attention_chunked_ref(q, k, v, **kw)
    if impl in ("kernel", "auto"):
        return _fa.flash_attention(q, k, v, **kw)
    raise _unknown(impl)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    if impl in ("ref", "ref_chunked", "ref_sequential"):
        return _ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
    if impl == "ref_grouped":
        return _ref.decode_attention_grouped_ref(q, k_cache, v_cache, cache_len)
    if impl in ("kernel", "auto"):
        return _da.decode_attention(q, k_cache, v_cache, cache_len)
    raise _unknown(impl)


def decode_attention_partials(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """One slice of a cache split along T → its fp32 record (B, H, D + 4)
    of (acc, m, l); every ``ref*`` impl is the plain version."""
    if impl in ("ref", "ref_grouped", "ref_chunked", "ref_sequential"):
        return _da.decode_attention_partials_plain(q, k_cache, v_cache, cache_len)
    if impl in ("kernel", "auto"):
        return _da.decode_attention_partials(q, k_cache, v_cache, cache_len)
    raise _unknown(impl)


def combine_partials(
    rec: torch.Tensor,
    dtype: torch.dtype,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """n slices' records stacked on dim 0 → the output in ``dtype``."""
    if impl in ("ref", "ref_grouped", "ref_chunked", "ref_sequential"):
        return _da.combine_partials_plain(rec, dtype)
    if impl in ("kernel", "auto"):
        return _da.combine_partials(rec, dtype)
    raise _unknown(impl)


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


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    chunk: int = 64,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H); a: (H,); b/c: (B,T,H,N) →
    (y (B,T,H,P), final state (B,H,P,N) fp32)."""
    if impl in ("ref", "ref_grouped", "ref_chunked"):
        return _ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)
    if impl == "ref_sequential":
        return _ref.ssd_ref(x, dt, a, b, c, initial_state=initial_state)
    if impl in ("kernel", "auto"):
        return _ssd.ssd_scan(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)
    raise _unknown(impl)


def moe_gmm(
    x: torch.Tensor,
    w: torch.Tensor,
    group_sizes: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """x: (T, d_in) rows sorted by expert; w: (E, d_in, d_out); group_sizes:
    (E,) int32 summing to T → (T, d_out).  Every ``ref*`` impl is the
    oracle, as the reference's ``_resolve_nonattn`` has it."""
    if impl in ("ref", "ref_grouped", "ref_chunked", "ref_sequential"):
        return _ref.moe_gmm_ref(x, w, group_sizes)
    if impl in ("kernel", "auto"):
        return _gmm.moe_gmm(x, w, group_sizes)
    raise _unknown(impl)
