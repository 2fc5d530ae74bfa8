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

Two bodies: ``mma`` (bf16, D a multiple of 16 up to 128, on mma.sync) and
``fp32`` (the CUDA cores; fp32, and bf16 head dims ``mma`` does not take).
:func:`body_for` picks one; ``body=`` names one.  ``flash_attention_bwd``
launches the kernel for CUDA tensors (one call counts one launch in
``launches`` and ``launches_by_body``, whatever passes the body runs) and
runs :func:`flash_attention_bwd_plain` for CPU tensors.  There is no
fallback: a CUDA input that the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _gqa_expand, _visible

#: Kernel calls since import (or since the caller last reset it).
launches = 0
#: The same calls by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"fp32": 0, "mma": 1}
#: The widest head dim of the mma body (its dK and dV sums stay in registers).
MMA_MAX_D = 128


def bodies_for(dtype: torch.dtype, d: int) -> Tuple[str, ...]:
    """The bodies that take these inputs, the preferred one first."""
    if dtype == torch.float32:
        return ("fp32",)
    if dtype != torch.bfloat16:
        return ()
    return ("mma", "fp32") if d % 16 == 0 and d <= MMA_MAX_D else ("fp32",)


def body_for(dtype: torch.dtype, d: int) -> str:
    """The body a call with these inputs runs when it names none."""
    found = bodies_for(dtype, d)
    if not found:
        raise TypeError(f"kernel takes fp32 or bf16; got {dtype}")
    return found[0]


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's dq, dk, dv by the explicit formulas, in fp32, over
    chunks of keys (as ``flash_attention_plain`` runs its forward); P is
    rounded to v's dtype before dV = Pᵀ dO, as the forward rounds it
    before P·V.  A query that sees no key (lse = -inf) gives dq = 0 and
    adds nothing to dk and dv."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
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
        dk[:, k0:k0 + n] += dk_h.reshape(b, n, kh, g, d).sum(3)
        dv[:, k0:k0 + n] += dv_h.reshape(b, n, kh, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention at (q, k, v), given its output o,
    its lse (B, H, Sq) fp32 and dO.  CUDA tensors launch the kernel on the
    current stream (three passes: δ, dK/dV, dQ), through ``body`` or, when
    it is None, the body :func:`body_for` picks; CPU tensors take
    :func:`flash_attention_bwd_plain`.  dO is made contiguous first:
    autograd hands over strided gradients."""
    global launches
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU, not {q.device}")
    do = do.contiguous()
    _check(q, k, v, o, do, lse)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    found = bodies_for(q.dtype, d)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {q.dtype} at head dim {d}; "
                         f"bodies that do: {found}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:  # nothing to compute: no launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, sq, sk, h, kh, d, int(causal), int(window is not None), int(window or 0),
                int(q_offset), _DTYPES[q.dtype], BODIES[body], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel ({body}) launch failed: cudaError {rc}")
    launches += 1
    launches_by_body[body] = launches_by_body.get(body, 0) + 1
    return dq, dk, dv
