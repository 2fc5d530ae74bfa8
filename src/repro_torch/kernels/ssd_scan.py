"""Mamba-2 SSD chunked scan for prefill: the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) and its plain PyTorch twin.

The kernel replaces ``repro/kernels/ssd_scan.py::ssd_scan``.  It is bound
by the causal chunk products, L(L+1)(N+P) + 4LPN flops per chunk and head;
see the note at the top of the CUDA source for what its design does about
that.

``ssd_scan`` launches the kernel for CUDA tensors and counts each launch
in the module-level ``launches``; for CPU tensors it runs
``ssd_scan_plain``.  There is no fallback: a CUDA input that the kernel
does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: Kernel launches since import (or since the caller last reset it).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    the shared memory (bytes) one CTA takes for (L, P, N)."""
    lib = _build.load("ssd_scan")
    fn, smem_bytes = lib.ssd_scan_launch, lib.ssd_scan_smem_bytes
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        smem_bytes.restype = ctypes.c_size_t
        smem_bytes.argtypes = [ctypes.c_int] * 3
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H) fp32; a: (H,) fp32; b/c: (B,T,H,N) →
    (y (B,T,H,P) in x's dtype, final state (B,H,P,N) fp32).  CUDA tensors
    launch the kernel on the current stream; CPU tensors take
    :func:`ssd_scan_plain`."""
    global launches
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU, not {x.device}")
    _check(x, dt, a, b, c, chunk, initial_state)
    bs, t, h, p = x.shape
    n = b.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    if bs == 0 or h == 0:  # nothing to compute: no launch
        return y, state
    fn, smem_bytes = _entry()
    length = max(1, min(chunk, t))
    need = smem_bytes(length, p, n)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(
            f"chunk {length}, P={p}, N={n} need {need} bytes of shared memory, "
            f"more than the {limit} a block may use on this card"
        )
    init = initial_state.data_ptr() if initial_state is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                init, y.data_ptr(), state.data_ptr(), bs, t, h, p, n,
                length, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc}")
    launches += 1
    return y, state
