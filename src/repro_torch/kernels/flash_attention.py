"""Blocked (flash) attention for prefill: the hand-written Hopper kernel
(``csrc/flash_attention.cu``) and its plain PyTorch twin.

The kernel replaces ``repro/kernels/flash_attention.py::flash_attention``.
Causal prefill is bound by its arithmetic, 4·B·H·D flops per visible
(query, key) pair; see the note at the top of the CUDA source for what its
design does about that.

``flash_attention`` launches the kernel for CUDA tensors and counts each
launch in the module-level ``launches``; for CPU tensors it runs
``flash_attention_plain``.  There is no fallback: a CUDA input that the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: Kernel launches since import (or since the caller last reset it).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """What the kernel computes, in PyTorch: fp32 scores, an online softmax
    over KV chunks and fp32 P·V, 0 for a query that sees no key, output in
    q's dtype.  That is the chunked oracle's arithmetic."""
    return _ref.attention_chunked_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q (B,Sq,H,D) and k/v (B,Sk,KH,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"kernel takes fp32 or bf16 q/k/v of one dtype; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if d > 256 or (d * q.element_size()) % 16:
        raise ValueError(
            f"kernel takes head dims up to 256 that are whole 16-byte vectors; got {d}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D) → (B, Sq, H, D) in q's dtype.
    CUDA tensors launch the kernel on the current stream; CPU tensors take
    :func:`flash_attention_plain`."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:  # nothing to compute: no launch
        return out
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, sk, h, kh, d, int(causal), int(window is not None),
                int(window or 0), int(q_offset), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    launches += 1
    return out
