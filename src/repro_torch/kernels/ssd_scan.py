"""Mamba-2 SSD chunked scan for prefill: the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) and its plain PyTorch twin.

The kernel replaces ``repro/kernels/ssd_scan.py::ssd_scan``.  It is bound
by the causal chunk products, L(L+1)(N+P) + 4LPN flops per chunk and head;
see the note at the top of the CUDA source for what its design does about
that.

The kernel has two bodies: ``chunked`` (the Mamba-2 paper's chunked
algorithm in three launches: every chunk's own state in parallel, a short
pass over the chunks for the states entering them, then every chunk's
output in parallel; bf16 on the tensor cores) and ``serial`` (one CTA per
(batch row, head) over its chunks in sequence, fp32 on the CUDA cores).
Their steps are written out in PyTorch too: :func:`ssd_chunk_states_plain`,
:func:`ssd_state_pass_plain` and :func:`ssd_chunk_out_plain`, which
composed give ``ssd_chunked_ref``'s result.  :func:`body_for` picks a body
from the dtype, P, N, the chunk and B·H against the card's SMs; a caller
may name one with ``body=``.

``ssd_scan`` launches the kernel for CUDA tensors and counts each call in
the module-level ``launches`` (one per call, whatever the body launches)
and, by body, in ``launches_by_body``; for CPU tensors it runs
``ssd_scan_plain``.  There is no fallback: a CUDA input that the kernel
does not take, or a named body that cannot take it, raises, and so does a
CUDA call under grad mode with an input that requires grad (the kernel
has no backward yet).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import refuse_grad
from repro_torch.kernels import ref as _ref

#: Kernel calls since import (or since the caller last reset it).
launches = 0
#: The same calls by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"serial": 0, "chunked": 1}
#: The longest chunk the chunked body takes, and the widest bf16 head dim.
CHUNKED_MAX_CHUNK = 128
CHUNKED_MAX_P = 128


def chunk_length(chunk: int, t: int) -> int:
    """The chunk a call runs with: ``chunk``, or T when T is shorter."""
    return max(1, min(chunk, t))


def bodies_for(dtype: torch.dtype, p: int, n: int, chunk: int, bh: int,
               sms: int) -> Tuple[str, ...]:
    """The bodies that take head dim ``p``, state dim ``n`` and chunks of
    ``chunk`` steps (already cut to T), for ``bh`` = B·H (batch rows times
    heads) on a card of ``sms`` SMs, the preferred one first.  bf16 prefers
    ``chunked``.  In fp32 both bodies do the same arithmetic on the CUDA
    cores and the chunked one does more of it, so fp32 prefers ``chunked``
    only where the serial body's B·H CTAs (one an SM at mamba2's width)
    fill at most two thirds of the SM waves they take, and wins there by
    1.35–2×; where they fill more, as B·H = 96 on 132 SMs does, the two
    are within about 2 % of each other and ``serial`` does less (PERF.md)."""
    if dtype not in _DTYPES or (p * dtype.itemsize) % 16 or (n * dtype.itemsize) % 16:
        return ()
    if chunk > CHUNKED_MAX_CHUNK or (dtype == torch.bfloat16 and p > CHUNKED_MAX_P):
        return ("serial",)
    waves = -(-bh // max(1, sms))
    if dtype == torch.float32 and 3 * bh > 2 * waves * sms:
        return ("serial", "chunked")
    return ("chunked", "serial")


def body_for(dtype: torch.dtype, p: int, n: int, chunk: int, bh: int, sms: int) -> str:
    """The body a call with these inputs runs when it names none."""
    found = bodies_for(dtype, p, n, chunk, bh, sms)
    if not found:
        raise TypeError(f"kernel takes fp32 or bf16 with P and N whole 16-byte vectors; "
                        f"got {dtype}, P={p}, N={n}")
    return found[0]


def _in_chunks(z: torch.Tensor, length: int) -> torch.Tensor:
    """(B, T, ...) → (B, n_chunks, length, ...) in fp32, zeros past T."""
    t = z.shape[1]
    pad = -(-t // length) * length - t
    z = F.pad(z.float(), (0, 0) * (z.dim() - 2) + (0, pad))
    return z.reshape(z.shape[0], -1, length, *z.shape[2:])


def _cumsum(dt: torch.Tensor, a: torch.Tensor, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt in chunks (B, n_chunks, L, H) and s = cumsum(a dt) within each."""
    dtc = _in_chunks(dt, length)
    return dtc, torch.cumsum(a[None, None, None, :] * dtc, dim=2)


def ssd_chunk_states_plain(x, dt, a, b, *, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step (a) of the chunked body: every chunk's own state
    S_c = Σ_j exp(s_L − s_j)·dt_j·x_j ⊗ b_j, (B, n_chunks, H, P, N), and its
    decay exp(s_L), (B, n_chunks, H), both fp32 (padded steps have dt = 0)."""
    length = chunk_length(chunk, x.shape[1])
    dtc, s = _cumsum(dt, a, length)
    w = torch.exp(s[:, :, -1:, :] - s) * dtc
    xc, bc = _in_chunks(x, length), _in_chunks(b, length)
    states = torch.einsum("bclhp,bclhn->bchpn", xc * w[..., None], bc)
    return states, torch.exp(s[:, :, -1, :])


def ssd_state_pass_plain(states, decays, initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step (b): the state entering each chunk, S_in[0] = the initial state
    (or 0) and S_in[c + 1] = exp(s_L[c])·S_in[c] + S_c, in sequence; returns
    (S_in (B, n_chunks, H, P, N), the final state (B, H, P, N))."""
    bs, nc, h, p, n = states.shape
    st = (torch.zeros((bs, h, p, n), device=states.device) if initial_state is None
          else initial_state.float())
    s_in = []
    for c in range(nc):
        s_in.append(st)
        st = decays[:, c, :, None, None] * st + states[:, c]
    s_in = torch.stack(s_in, dim=1) if s_in else states.new_zeros(states.shape)
    return s_in, st


def ssd_chunk_out_plain(x, dt, a, b, c, s_in, *, chunk: int = 128) -> torch.Tensor:
    """Step (c): every chunk's output from the state entering it,
    y = ((C Bᵀ)⊙Γ) X + exp(s)⊙(C S_inᵀ), in fp32, returned in x's dtype."""
    bs, t, h, p = x.shape
    length = chunk_length(chunk, t)
    dtc, s = _cumsum(dt, a, length)
    xc, bc, cc = (_in_chunks(z, length) for z in (x, b, c))
    li = torch.arange(length, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    gamma = torch.where(causal, torch.exp(s[:, :, :, None, :] - s[:, :, None, :, :]),
                        torch.zeros((), device=x.device)) * dtc[:, :, None, :, :]
    cb = torch.einsum("bclhn,bcmhn->bclmh", cc, bc)
    y = torch.einsum("bclmh,bcmhp->bclhp", cb * gamma, xc)
    y = y + torch.exp(s)[..., None] * torch.einsum("bchpn,bclhn->bclhp", s_in, cc)
    return y.reshape(bs, -1, h, p)[:, :t].to(x.dtype)


def ssd_scan_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in PyTorch: the chunked dual form in fp32
    (``ssd_chunked_ref``), y in x's dtype and the final state in fp32."""
    return _ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)


def _check(x, dt, a, b, c, chunk, initial_state) -> None:
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(
            f"want x (B,T,H,P) and b/c (B,T,H,N); got {tuple(x.shape)}, "
            f"{tuple(b.shape)}, {tuple(c.shape)}"
        )
    bs, t, h, p = x.shape
    n = b.shape[3]
    if b.shape[:3] != (bs, t, h) or dt.shape != (bs, t, h) or a.shape != (h,):
        raise ValueError(
            f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, b/c {tuple(b.shape)}"
        )
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(
            f"kernel takes fp32 or bf16 x/b/c of one dtype; got {x.dtype}, "
            f"{b.dtype}, {c.dtype}"
        )
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be fp32; got {dt.dtype}, {a.dtype}")
    if (p * x.element_size()) % 16 or (n * x.element_size()) % 16:
        raise ValueError(
            f"kernel takes P and N that are whole 16-byte vectors; got P={p}, N={n}"
        )
    if chunk < 1:
        raise ValueError(f"chunk must be positive; got {chunk}")
    tensors = [("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)]
    if initial_state is not None:
        if initial_state.shape != (bs, h, p, n) or initial_state.dtype != torch.float32:
            raise ValueError("initial_state must be a (B,H,P,N) fp32 tensor")
        tensors.append(("initial_state", initial_state))
    for name, z in tensors:
        if z.device != x.device:
            raise ValueError(f"{name} is on {z.device}, x on {x.device}")
        if not z.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry():
    """The C entry points, built and typed at first use: the launcher and
    the shared memory (bytes) the largest CTA of a body takes for
    (L, P, N, dtype, body)."""
    lib = _build.load("ssd_scan")
    fn, smem_bytes = lib.ssd_scan_launch, lib.ssd_scan_smem_bytes
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        smem_bytes.restype = ctypes.c_size_t
        smem_bytes.argtypes = [ctypes.c_int] * 5
    return fn, smem_bytes


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    body: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H) fp32; a: (H,) fp32; b/c: (B,T,H,N) →
    (y (B,T,H,P) in x's dtype, final state (B,H,P,N) fp32).  CUDA tensors
    launch the kernel on the current stream, through ``body`` (one of
    ``BODIES``) or, when it is None, the body :func:`body_for` picks; CPU
    tensors take :func:`ssd_scan_plain`."""
    global launches
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU, not {x.device}")
    refuse_grad("ssd_scan", x, dt, a, b, c, initial_state)
    _check(x, dt, a, b, c, chunk, initial_state)
    bs, t, h, p = x.shape
    n = b.shape[3]
    length = chunk_length(chunk, t)
    props = torch.cuda.get_device_properties(x.device)
    found = bodies_for(x.dtype, p, n, length, bs * h, props.multi_processor_count)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {x.dtype} with P={p}, N={n} and "
                         f"chunk {length}; bodies that do: {found}")
    y = torch.empty_like(x)
    state = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    if bs == 0 or h == 0:  # nothing to compute: no launch
        return y, state
    fn, smem_bytes = _entry()
    need = smem_bytes(length, p, n, _DTYPES[x.dtype], BODIES[body])
    limit = props.shared_memory_per_block_optin
    if need > limit:
        raise ValueError(
            f"the {body} body at chunk {length}, P={p}, N={n} needs {need} bytes of shared "
            f"memory, more than the {limit} a block may use on this card"
        )
    # the chunked body's scratch: chunk states and decays in fp32 and, in
    # bf16, the states entering each chunk as a bf16 high part and the rest
    scratch = [None, None, None]
    if body == "chunked" and t > 0:
        nc = -(-t // length)
        scratch[:2] = [torch.empty(shape, dtype=torch.float32, device=x.device)
                       for shape in ((bs, nc, h, p, n), (bs, nc, h))]
        if x.dtype == torch.bfloat16:
            scratch[2] = torch.empty((bs, nc, h, 2, p, n), dtype=torch.bfloat16, device=x.device)
    init = initial_state.data_ptr() if initial_state is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                init, y.data_ptr(), state.data_ptr(),
                *(z.data_ptr() if z is not None else None for z in scratch),
                bs, t, h, p, n, length, _DTYPES[x.dtype], BODIES[body], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel ({body}) launch failed: cudaError {rc}")
    launches += 1
    launches_by_body[body] = launches_by_body.get(body, 0) + 1
    return y, state
