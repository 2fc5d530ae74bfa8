"""The gradient of the Mamba-2 SSD chunked scan: the hand-written Hopper
kernel (``csrc/ssd_scan_bwd.cu``) and its plain PyTorch twin.

The Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan`` has no backward:
the reference differentiates its plain path (``ref.py::ssd_chunked_ref``)
with XLA.  This computes that gradient chunk by chunk from the states the
forward leaves.  Per chunk of L steps of each (b, h), with s the chunk's
cumulative sum of a·dt (in fp64, as the forward sums it), Γ_ij =
exp(s_i − s_j) for j ≤ i, ȳ the gradient of y, S_in the state entering the
chunk and S̄ the gradient of the state leaving it:

    S̄_in  = exp(s_L)·S̄ + Σ_i exp(s_i)·ȳ_i c_iᵀ          (chunks in reverse)
    dx_j  = dt_j·[Σ_{i≥j} (c_i·b_j)·Γ_ij·ȳ_i + exp(s_L − s_j)·S̄ b_j]
    db_j  = dt_j·[Σ_{i≥j} Γ_ij·(ȳ_i·x_j)·c_i + exp(s_L − s_j)·S̄ᵀ x_j]
    dc_i  = Σ_{j≤i} Γ_ij·dt_j·(ȳ_i·x_j)·b_j + exp(s_i)·S_inᵀ ȳ_i

and d(dt) a direct term plus a·(the reverse cumulative sum of s̄, the
gradient of s), da the sum over batch rows and steps of dt times that
reverse sum.  The gradient of the initial state is S̄_in of chunk 0.

The kernel mirrors the forward's three steps in reverse (see the note at
the top of the CUDA source): (a′) each chunk's own Σ_i exp(s_i)·ȳ_i c_iᵀ,
(b′) the pass over the chunks in reverse for the S̄ leaving each, (c′)
each chunk's dx, db, dc and d(dt) from the dual form, by rows and by
columns; da is summed in the wrapper from per-(b, chunk, h) partials, in
a fixed order (no atomics).  :func:`ssd_scan_bwd_plain` writes out the
same arithmetic in PyTorch, for the CPU and to hold the kernel to on the
card.

Two bodies (:func:`bodies_for`): ``mma`` (bf16: the products on mma.sync
with fp32 sums; C Bᵀ and dY Xᵀ from the exact bf16 operands, every product
with an fp32 operand as two, its bf16 high part and its bf16 rest) and
``fp32`` (both dtypes: fp32 arithmetic on the CUDA cores; fp32 inputs stay
on it, as the reference's SSD tolerance rules out TF32).
:func:`ssd_scan_bwd_plain` takes ``operand=``, which stands in for each fp32
operand of a product, so that the CPU tests can round them as the mma body
holds them and see what those roundings cost.

``ssd_scan_bwd`` launches the kernel for CUDA tensors and counts each call
in the module-level ``launches`` (one per call, whatever it launches) and
``launches_by_body``; for CPU tensors it runs :func:`ssd_scan_bwd_plain`.
There is no fallback: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import in_chunks

#: Kernel calls since import (or since the caller last reset it).
launches = 0
#: The same calls by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"fp32": 0, "mma": 1}
#: The longest chunk the kernel takes (the forward's chunked body's).
MAX_CHUNK = 128


def bodies_for(dtype: torch.dtype) -> Tuple[str, ...]:
    """The bodies that take inputs of ``dtype``, the preferred one first
    (every width and chunk the kernel takes, either body)."""
    if dtype == torch.bfloat16:
        return ("mma", "fp32")
    if dtype == torch.float32:
        return ("fp32",)
    return ()


def body_for(dtype: torch.dtype) -> str:
    """The body a call with inputs of ``dtype`` runs when it names none."""
    found = bodies_for(dtype)
    if not found:
        raise TypeError(f"kernel takes fp32 or bf16; got {dtype}")
    return found[0]

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              Optional[torch.Tensor]]


def ssd_scan_bwd_plain(x, dt, a, b, c, initial_state, states_in, dy, dstate, *,
                       chunk: int = 128,
                       operand: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                       ) -> Grads:
    """The gradient of ``ssd_scan`` in PyTorch, chunk by chunk in fp32 (s
    in fp64).  ``states_in``: (B, n_chunks, H, P, N) fp32, the state
    entering each chunk (the forward's); ``dy`` the gradient of y,
    ``dstate`` of the final state (None: zero).  Returns fp32 (dx, d(dt),
    da, db, dc, d(initial_state)); the last is None where
    ``initial_state`` is.  ``operand(kind, v)``, where given, stands in for
    each fp32 operand v of a product: kind "own" for exp(s_i)·ȳ_i in the
    chunk's own S̄ term, "tile" for the masked, weighted L × L tiles that
    multiply B, C or ȳ, "state" for S_in and S̄ (the products of exact bf16
    inputs, C Bᵀ and ȳ Xᵀ, take none)."""
    if operand is None:
        operand = lambda kind, v: v  # noqa: E731
    bs, t, h, p = x.shape
    length = max(1, min(chunk, t))
    dtc = in_chunks(dt, length)                                      # (B, C, L, H)
    xc, bc, cc, dyc = (in_chunks(z, length) for z in (x, b, c, dy))
    nc = dtc.shape[1]
    s = torch.cumsum(a.double()[None, None, None, :] * dtc.double(), dim=2)
    s_last = s[:, :, -1:, :]
    es = torch.exp(s).float()                                      # exp(s_i)
    el = torch.exp(s_last - s).float()                             # exp(s_L − s_j)
    decay = torch.exp(s_last[:, :, 0]).float()                     # (B, C, H)
    # (a′) each chunk's own S̄ term, (b′) the chunks in reverse
    own = torch.einsum("bclhp,bclhn->bchpn", operand("own", es[..., None] * dyc), cc)
    sbar = (torch.zeros((bs, h, p, b.shape[3]), device=x.device) if dstate is None
            else dstate.float())
    sbar_out = [None] * nc
    for ci in reversed(range(nc)):
        sbar_out[ci] = sbar
        sbar = decay[:, ci, :, None, None] * sbar + own[:, ci]
    d_init = sbar if initial_state is not None else None
    sbar_out = (torch.stack(sbar_out, dim=1) if nc else own)      # (B, C, H, P, N)
    # (c′) the dual form: Γ_ij = exp(s_i − s_j) for j ≤ i
    li = torch.arange(length, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    gamma = torch.exp(torch.where(causal, s[:, :, :, None, :] - s[:, :, None, :, :],
                                  torch.full((), float("-inf"), dtype=s.dtype,
                                             device=x.device))).float()
    cb = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)                # c_i·b_j
    dm = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)               # ȳ_i·x_j
    g_dt = gamma * dtc[:, :, None, :, :]                           # Γ_ij·dt_j
    sbar_op, sin_op = operand("state", sbar_out), operand("state", states_in)
    sb = torch.einsum("bchpn,bcjhn->bcjhp", sbar_op, bc)           # S̄ b_j
    dx = (torch.einsum("bcijh,bcihp->bcjhp", operand("tile", cb * g_dt), dyc)
          + (el * dtc)[..., None] * sb)
    e = operand("tile", dm * g_dt)
    db = (torch.einsum("bcijh,bcihn->bcjhn", e, cc)
          + (el * dtc)[..., None] * torch.einsum("bchpn,bcjhp->bcjhn", sbar_op, xc))
    dc = (torch.einsum("bcijh,bcjhn->bcihn", e, bc)
          + es[..., None] * torch.einsum("bchpn,bcihp->bcihn", sin_op, dyc))
    # d(dt): the direct term, then the term through s
    h_ij = cb * gamma * dm
    r = el * (xc * sb).sum(-1)                                     # exp(s_L − s_j)·x_j·S̄ b_j
    q = h_ij * dtc[:, :, None, :, :]
    sin_c = torch.einsum("bchpn,bcihn->bcihp", sin_op, cc)
    s_bar = q.sum(3) - q.sum(2) + es * (dyc * sin_c).sum(-1) - dtc * r
    s_bar[:, :, -1] += (dtc * r).sum(2) + decay * (sbar_out * states_in).sum((-2, -1))
    rev = torch.flip(torch.cumsum(torch.flip(s_bar.double(), (2,)), dim=2), (2,))
    ddt = h_ij.sum(2) + r + (a.double() * rev).float()
    da = (dtc.double() * rev).sum((0, 1, 2)).float()

    def whole(z):
        return z.reshape(bs, nc * length, *z.shape[3:])[:, :t]

    return whole(dx), whole(ddt), da, whole(db), whole(dc), d_init


def smem_bytes(chunk: int, p: int, n: int, body: str = "fp32") -> int:
    """Shared memory (bytes) the largest CTA of ``body`` takes."""
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_smem_bytes
    if fn.argtypes is None:
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_int] * 4
    return fn(chunk, p, n, BODIES[body])


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn


def _check(x, dt, a, b, c, initial_state, states_in, dy, dstate, length) -> None:
    bs, t, h, p = x.shape
    n = b.shape[3]
    nc = -(-t // length)
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"kernel takes fp32 or bf16 x, b, c and dy of one dtype; got {x.dtype}, "
                        f"{b.dtype}, {c.dtype}, {dy.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be fp32; got {dt.dtype}, {a.dtype}")
    if (b.shape != (bs, t, h, n) or c.shape != b.shape or dt.shape != (bs, t, h)
            or a.shape != (h,) or dy.shape != x.shape):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b/c {tuple(b.shape)}, dy {tuple(dy.shape)}")
    if (p * x.element_size()) % 16 or (n * x.element_size()) % 16 or p % 4 or n % 4:
        raise ValueError(f"kernel takes P and N that are whole 16-byte vectors; got P={p}, N={n}")
    if length > MAX_CHUNK or p > 128 or n > 128:
        raise ValueError(f"kernel takes chunks of at most {MAX_CHUNK} steps and P, N up to 128; "
                         f"got chunk {length}, P={p}, N={n}")
    tensors = [("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c), ("dy", dy),
               ("states_in", states_in)]
    if states_in.shape != (bs, nc, h, p, n) or states_in.dtype != torch.float32:
        raise ValueError(f"states_in must be a ({bs},{nc},{h},{p},{n}) fp32 tensor")
    for name, z in (("initial_state", initial_state), ("dstate", dstate)):
        if z is not None:
            if z.shape != (bs, h, p, n) or z.dtype != torch.float32:
                raise ValueError(f"{name} must be a (B,H,P,N) fp32 tensor")
            tensors.append((name, z))
    for name, z in tensors:
        if z.device != x.device:
            raise ValueError(f"{name} is on {z.device}, x on {x.device}")
        if not z.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_scan_bwd(x, dt, a, b, c, initial_state, states_in, dy, dstate, *,
                 chunk: int = 128, body: Optional[str] = None) -> Grads:
    """The gradient of ``ssd_scan`` from the forward's inputs, the fp32
    states entering each chunk (B, n_chunks, H, P, N), the gradient of y
    and of the final state (None: zero) → (dx in x's dtype, d(dt) fp32, da
    fp32, db and dc in b's dtype, the initial state's gradient in fp32 or
    None where ``initial_state`` is).  CUDA tensors launch the kernel on
    the current stream, through ``body`` (one of ``BODIES``) or the one
    :func:`body_for` picks; CPU tensors take :func:`ssd_scan_bwd_plain`.
    x, b, c and dy off a 16-byte boundary are copied before the launch."""
    global launches
    if x.device.type == "cpu":
        dx, ddt, da, db, dc, d_init = ssd_scan_bwd_plain(
            x, dt, a, b, c, initial_state, states_in, dy, dstate, chunk=chunk)
        return dx.to(x.dtype), ddt, da, db.to(b.dtype), dc.to(c.dtype), d_init
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on CUDA or CPU, not {x.device}")
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"want x (B,T,H,P) and b/c (B,T,H,N); got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    bs, t, h, p = x.shape
    n = b.shape[3]
    length = max(1, min(chunk, t))
    _check(x, dt, a, b, c, initial_state, states_in, dy, dstate, length)
    found = bodies_for(x.dtype)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {x.dtype}; bodies that do: {found}")
    x, b, c, dy = (_build.aligned(z) for z in (x, b, c, dy))
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    d_init = (torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
              if initial_state is not None else None)
    if bs == 0 or h == 0 or t == 0:  # nothing to compute: no launch
        for z in (dx, ddt, db, dc):
            z.zero_()
        if d_init is not None:
            d_init.copy_(dstate) if dstate is not None else d_init.zero_()
        return dx, ddt, torch.zeros_like(a), db, dc, d_init
    need = smem_bytes(length, p, n, body)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"the {body} backward at chunk {length}, P={p}, N={n} needs {need} "
                         f"bytes of shared memory, more than the {limit} a block may use on "
                         f"this card")
    nc = -(-t // length)
    lq = -(-length // 32) * 32

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    sbar, decays, srow, da_part = (scratch(bs, nc, h, p, n), scratch(bs, nc, h),
                                   scratch(bs, nc, h, lq), scratch(bs, nc, h))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      dy.data_ptr(), states_in.data_ptr(),
                      dstate.data_ptr() if dstate is not None else None,
                      dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
                      d_init.data_ptr() if d_init is not None else None,
                      sbar.data_ptr(), decays.data_ptr(), srow.data_ptr(), da_part.data_ptr(),
                      bs, t, h, p, n, length, _DTYPES[x.dtype], BODIES[body], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel ({body}) launch failed: cudaError {rc}")
    launches += 1
    launches_by_body[body] = launches_by_body.get(body, 0) + 1
    return dx, ddt, da_part.sum((0, 1)), db, dc, d_init
