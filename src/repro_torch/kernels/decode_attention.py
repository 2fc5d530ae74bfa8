"""One-token GQA decode attention: the hand-written Hopper kernel
(``csrc/decode_attention.cu``) and its plain PyTorch twin.

The kernel replaces ``repro/kernels/decode_attention.py::decode_attention``.
It is bound by reading the KV cache, 2·B·len·KH·D·itemsize bytes; see the
note at the top of the CUDA source for what its design does about that.

``decode_attention`` launches the kernel for CUDA tensors and counts each
launch in the module-level ``launches``; for CPU tensors it runs
``decode_attention_plain``.  There is no fallback: a CUDA input that the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: Kernel launches since import (or since the caller last reset it).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
) -> torch.Tensor:
    """What the kernel computes, in PyTorch: queries grouped per KV head,
    fp32 scores, softmax and weighted sum over the valid prefix
    ``cache_len`` (clamped to [0, T]), 0 for a row with no valid slot,
    output in q's dtype.  That is the grouped oracle's arithmetic."""
    return _ref.decode_attention_grouped_ref(q, k_cache, v_cache, cache_len)


def _check(q, k_cache, v_cache, cache_len) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q (B,H,D) and caches (B,T,KH,D); got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    b, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % k_cache.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}"
        )
    if cache_len.shape != (b,) or cache_len.dtype != torch.int32:
        raise ValueError("cache_len must be a (B,) int32 tensor")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"kernel takes fp32 or bf16 q/k/v of one dtype; got {q.dtype}, "
            f"{k_cache.dtype}, {v_cache.dtype}"
        )
    if d > 256 or d % 2 or (d * q.element_size()) % 16:
        raise ValueError(
            f"kernel takes head dims up to 256 that are whole 16-byte vectors; got {d}"
        )
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_len", cache_len)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
) -> torch.Tensor:
    """q: (B, H, D); k_cache/v_cache: (B, T, KH, D); cache_len: (B,) int32
    → (B, H, D) in q's dtype.  CUDA tensors launch the kernel on the
    current stream; CPU tensors take :func:`decode_attention_plain`."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU, not {q.device}")
    _check(q, k_cache, v_cache, cache_len)
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:  # nothing to compute: no launch
        return out
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(), b, h, kh, t, d,
                _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {rc}")
    launches += 1
    return out
