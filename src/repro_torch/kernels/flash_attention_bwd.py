"""The backward of blocked (flash) attention: the hand-written Hopper
kernel (``csrc/flash_attention_bwd.cu``) and its plain PyTorch twin.

The TPU side has no such kernel: the reference differentiates
``repro/kernels/flash_attention.py::flash_attention`` (no ``custom_vjp``)
by XLA's compiled gradient.  Here the forward kernel runs on the card's
main path, so its gradient is a kernel too (the ``torch.autograd.Function``
in :mod:`repro_torch.kernels.flash_attention`).  Given q, k, v, the
forward's output o and log-sum-exp lse (B, H, Sq) fp32, and dO, it computes

    δ  = rowsum(dO ⊙ O)                      (fp32, per (b, h, query))
    P  = exp(Q Kᵀ·D^-½ − lse)                (0 where masked or lse = -inf)
    dV = Σ_group Pᵀ dO,   dP = dO Vᵀ,   dS = P ⊙ (dP − δ)
    dK = Σ_group dSᵀ Q·D^-½,   dQ = dS K·D^-½

for the forward's masks (causal, window, ``q_offset``, Sk) and GQA by
``h // G``; dq, dk and dv come back in their inputs' dtype.  It is bound
by operations: about 2.5 times the forward's 4·H·D flops per visible
(query, key) pair (10·H·D: S and dP recomputed in the dK/dV pass and again
in the dQ pass, and the three products dV, dK, dQ).

Three bodies: ``wgmma`` (bf16 with D 64 or 128, on Hopper's warpgroup
products fed by TMA), ``mma`` (bf16, D a multiple of 16 up to 128, on
mma.sync; zamba2's D = 112) and ``fp32`` (the CUDA cores; fp32, and bf16
inputs the other two do not take).  ``wgmma`` and ``mma`` need q, k, v, o
and dO on 16-byte boundaries.  :func:`body_for` picks one; ``body=``
names one.  Where a KV head's group gives too few key tiles to fill the
card (MQA), the ``wgmma`` body splits each group's heads over
:func:`splits_for` CTAs, which write fp32 partial dK and dV to scratch that
a second kernel sums in split order; :func:`flash_attention_bwd_plain`
with ``splits=`` sums its partials in the same order.
``flash_attention_bwd`` launches the kernel for CUDA tensors (one call
counts one launch in ``launches`` and ``launches_by_body``, whatever
passes the body runs) and runs :func:`flash_attention_bwd_plain` for CPU
tensors.  There is no fallback: a CUDA input that the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import sm_count
from repro_torch.kernels.ref import _gqa_expand, _visible

#: Kernel calls since import (or since the caller last reset it).
launches = 0
#: The same calls by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"fp32": 0, "mma": 1, "wgmma": 2}
#: The widest head dim of the mma body (its dK and dV sums stay in registers).
MMA_MAX_D = 128
#: Head dims of the wgmma body: rows of one or two 128-byte swizzle rows.
WGMMA_HEAD_DIMS = (64, 128)
#: Keys of one warpgroup of the wgmma body's dK/dV pass.
KEY_TILE = 64
#: Key tiles a CTA of that pass holds (``KV_WGS`` in the CUDA source).
KV_WGS = 1
#: The key tiles per SM that :func:`splits_for` aims for: two of that
#: pass's CTAs are resident on an SM, so a wave and a half (granite's MQA
#: on an H100 ran fastest at 8 shares of its 48 heads, 512 tiles for 132
#: SMs, against 4 to 24 shares in turns: ``tools/bwd_splits.py``).
TILES_PER_SM = 3


def bodies_for(dtype: torch.dtype, d: int, aligned: bool = True) -> Tuple[str, ...]:
    """The bodies that take these inputs, the preferred one first.
    ``aligned``: q, k, v, o and dO start on 16-byte boundaries (TMA's
    sources and mma's 16-byte loads; the fp32 body loads elements)."""
    if dtype == torch.float32:
        return ("fp32",)
    if dtype != torch.bfloat16:
        return ()
    found = ("fp32",)
    if d % 16 == 0 and d <= MMA_MAX_D and aligned:
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


def splits_for(b: int, sk: int, kh: int, g: int, sms: int) -> int:
    """CTAs that share each KV head's group of ``g`` query heads in the
    wgmma body's dK/dV pass: 1 where the (key tile, KV head, batch row)
    tiles already reach ``TILES_PER_SM`` per SM, else the least divisor of
    ``g`` that brings them there (or ``g``).  A function of the shape and
    the card's SM count only."""
    tiles = -(-sk // KEY_TILE) * kh * b
    target = TILES_PER_SM * sms
    if tiles >= target:
        return 1
    for n in range(2, g + 1):
        if g % n == 0 and tiles * n >= target:
            return n
    return g


def dkdv_ctas(b: int, sk: int, kh: int, splits: int) -> int:
    """CTAs of the wgmma body's dK/dV pass."""
    return -(-sk // (KEY_TILE * KV_WGS)) * kh * b * splits


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk_k: int = 1024,
    splits: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's dq, dk, dv by the explicit formulas, in fp32, over
    chunks of keys (as ``flash_attention_plain`` runs its forward); P is
    rounded to v's dtype before dV = Pᵀ dO, as the forward rounds it
    before P·V.  A query that sees no key (lse = -inf) gives dq = 0 and
    adds nothing to dk and dv.  ``splits`` (a divisor of H / KH): each
    group's heads are summed in that many consecutive shares, and the
    shares' fp32 partials added in share order, as the wgmma body's split
    CTAs and their sum kernel do."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    if splits < 1 or g % splits:
        raise ValueError(f"splits must divide the group of {g} heads; got {splits}")
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)             # (B, H, Sq)
    lse = torch.where(torch.isinf(lse), torch.zeros_like(lse), lse.float())
    mask = _visible(sq, sk, causal, window, q_offset, q.device)
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, sk, kh, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, max(1, chunk_k)):
        kc = _gqa_expand(k[:, k0:k0 + chunk_k], h).float()
        vc = _gqa_expand(v[:, k0:k0 + chunk_k], h).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        s = s.masked_fill(~mask[None, None, :, k0:k0 + chunk_k], float("-inf"))
        p = torch.exp(s - lse[..., None])                          # 0 where masked
        pv = p.to(v.dtype).float()
        dv_h = torch.einsum("bhqk,bqhd->bkhd", pv, dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vc)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kc) * scale
        dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
        n = kc.shape[1]
        dk[:, k0:k0 + n] += _split_sum(dk_h.reshape(b, n, kh, splits, g // splits, d))
        dv[:, k0:k0 + n] += _split_sum(dv_h.reshape(b, n, kh, splits, g // splits, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _split_sum(x: torch.Tensor) -> torch.Tensor:
    """x (B, n, KH, splits, G / splits, D): each share's heads summed, then
    the shares' partials added in order."""
    part = x.sum(4)
    out = part[:, :, :, 0]
    for i in range(1, part.shape[3]):
        out = out + part[:, :, :, i]
    return out


def _check(q, k, v, o, do, lse) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q (B,Sq,H,D) and k/v (B,Sk,KH,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must be shaped as q "
                         f"{tuple(q.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"want lse (B, H, Sq) = {(b, h, sq)} fp32; got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in (k, v, o, do)):
        raise TypeError(f"kernel takes fp32 or bf16 q/k/v/o/dO of one dtype; got "
                        f"{[x.dtype for x in (q, k, v, o, do)]}")
    if d > 256 or (d * q.element_size()) % 16:
        raise ValueError(
            f"kernel takes head dims up to 256 that are whole 16-byte vectors; got {d}"
        )
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("dO", do), ("lse", lse)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    return fn


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    body: Optional[str] = None,
    splits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention at (q, k, v), given its output o,
    its lse (B, H, Sq) fp32 and dO.  CUDA tensors launch the kernel on the
    current stream (three passes: δ, dK/dV, dQ), through ``body`` or, when
    it is None, the body :func:`body_for` picks; the wgmma body shares each
    group's heads among ``splits`` CTAs (None: :func:`splits_for` at the
    card's SM count).  CPU tensors take :func:`flash_attention_bwd_plain`
    (with ``splits``, 1 when None).  dO is made contiguous first: autograd
    hands over strided gradients."""
    global launches
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, splits=splits or 1, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU, not {q.device}")
    do = do.contiguous()
    _check(q, k, v, o, do, lse)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v, o, do))
    found = bodies_for(q.dtype, d, aligned)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {q.dtype} at head dim {d}"
                         f"{'' if aligned else ' (unaligned)'}; bodies that do: {found}")
    g = h // kh
    if body != "wgmma":
        if splits not in (None, 1):
            raise ValueError(f"only the wgmma body splits a group; the {body!r} body got "
                             f"splits={splits}")
        splits = 1
    elif splits is None:
        splits = splits_for(b, sk, kh, g, sm_count(q.device))
    elif splits < 1 or g % splits:
        raise ValueError(f"splits must divide the group of {g} heads; got {splits}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:  # nothing to compute: no launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # the split CTAs' partial dK and dV (2, splits, B, Sk, KH, D)
    part = (torch.empty((2, splits) + tuple(k.shape), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                part.data_ptr() if part is not None else None,
                b, sq, sk, h, kh, d, int(causal), int(window is not None), int(window or 0),
                int(q_offset), _DTYPES[q.dtype], BODIES[body], splits, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel ({body}) launch failed: cudaError {rc}")
    launches += 1
    launches_by_body[body] = launches_by_body.get(body, 0) + 1
    return dq, dk, dv
