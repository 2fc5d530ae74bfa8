"""Blocked (flash) attention for prefill: the hand-written Hopper kernel
(``csrc/flash_attention.cu``) and its plain PyTorch twin.

The kernel replaces ``repro/kernels/flash_attention.py::flash_attention``.
Causal prefill is bound by its arithmetic, 4·B·H·D flops per visible
(query, key) pair; see the note at the top of the CUDA source for what its
design does about that.

The kernel has three bodies (see the CUDA source): ``wgmma`` (bf16 with
D in {64, 128, 192, 256}, on Hopper's warpgroup products fed by TMA),
``mma`` (bf16 with D a multiple of 16, on mma.sync) and ``fp32`` (the CUDA
cores, any dtype and head dim the kernel takes).  :func:`body_for` picks
one from the dtype, the head dim and the alignment; a caller may name one
with ``body=`` to time or test it.

``flash_attention`` launches the kernel for CUDA tensors and counts each
launch in the module-level ``launches`` and, by body, in
``launches_by_body``; for CPU tensors it runs ``flash_attention_plain``.
There is no fallback: a CUDA input that the kernel does not take, or a
named body that cannot take it, raises.

Under grad mode, when q, k or v requires grad, the call goes through
:class:`FlashAttention`, a ``torch.autograd.Function``: its forward is the
same kernel, which then also writes each query's log-sum-exp, and its
backward is the hand-written backward kernel
(:mod:`repro_torch.kernels.flash_attention_bwd`); on CPU tensors, the
plain forward (with its LSE) and the plain backward.  Otherwise the call
builds no graph and launches exactly as it did before.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention_bwd as _bwd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._autograd import wants_grad

#: Kernel launches since import (or since the caller last reset it).
launches = 0
#: The same launches by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"fp32": 0, "mma": 1, "wgmma": 2}
#: Head dims whose rows are whole 128-byte swizzle rows (64 bf16 each).
WGMMA_HEAD_DIMS = (64, 128, 192, 256)


def bodies_for(dtype: torch.dtype, d: int, aligned: bool) -> Tuple[str, ...]:
    """The bodies that take these inputs, the preferred one first.
    ``aligned``: q, k, v and the output start on 16-byte boundaries."""
    if dtype == torch.float32:
        return ("fp32",)
    if dtype != torch.bfloat16:
        return ()
    found = ("fp32",)
    if d % 16 == 0:
        found = ("mma",) + found
    if d in WGMMA_HEAD_DIMS and aligned:
        found = ("wgmma",) + found
    return found


def body_for(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The body a call with these inputs runs when it names none."""
    found = bodies_for(dtype, d, aligned)
    if not found:
        raise TypeError(f"kernel takes fp32 or bf16; got {dtype}")
    return found[0]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """What the kernel computes, in PyTorch: fp32 scores, an online softmax
    over KV chunks and fp32 P·V, 0 for a query that sees no key, output in
    q's dtype.  That is the chunked oracle's arithmetic.  With
    ``return_lse``: (out, lse (B, H, Sq) fp32, -inf where no key is seen)."""
    return _ref.attention_chunked_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, return_lse=return_lse)


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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    return fn


def _launch(q, k, v, causal, window, q_offset, body, with_lse):
    """The kernel on CUDA tensors: (out, lse or None)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v, out))
    found = bodies_for(q.dtype, d, aligned)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {q.dtype} at head dim {d}"
                         f"{'' if aligned else ' (unaligned)'}; bodies that do: {found}")
    if out.numel() == 0:  # nothing to compute: no launch
        return out, lse
    if lse is not None and sk == 0:  # no key: out 0, lse -inf, no launch
        return out.zero_(), lse.fill_(float("-inf"))
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                b, sq, sk, h, kh, d, int(causal), int(window is not None),
                int(window or 0), int(q_offset), _DTYPES[q.dtype], BODIES[body], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({body}) launch failed: cudaError {rc}")
    launches += 1
    launches_by_body[body] = launches_by_body.get(body, 0) + 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: on CUDA tensors the forward
    kernel (through ``body``, writing the LSE) and the backward kernel
    (through the body :func:`flash_attention_bwd.body_for` picks), on CPU
    tensors their plain twins."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, body):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                             q_offset=q_offset, return_lse=True)
        else:
            out, lse = _launch(q, k, v, causal, window, q_offset, body, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd.flash_attention_bwd(q, k, v, out, do, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    body: Optional[str] = None,
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D) → (B, Sq, H, D) in q's dtype.
    CUDA tensors launch the kernel on the current stream, through ``body``
    (one of ``BODIES``) or, when it is None, the body :func:`body_for`
    picks; CPU tensors take :func:`flash_attention_plain`.  Under grad mode
    with an input that requires grad, the result is differentiable
    (:class:`FlashAttention`)."""
    if wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, q_offset, body)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return _launch(q, k, v, causal, window, q_offset, body, False)[0]
