"""Grouped expert matmul for sorted MoE dispatch: the hand-written Hopper
kernel (``csrc/moe_gmm.cu``) and its plain PyTorch twin.

The kernel replaces ``repro/kernels/moe_gmm.py::moe_gmm`` (the Pallas
kernel body ``_gmm_kernel``).  Rows of x (T, d_in) are sorted by expert;
``group_sizes[e]`` consecutive rows are multiplied by ``w[e]`` (d_in,
d_out), in fp32, and the product is rounded once to x's dtype.  The group
sizes stay on the device: the kernel works out each group's offsets
itself, so a call never waits for the card.  At Qwen3-MoE's prefill it is
bound by bytes (x, the non-empty experts' weights, and the output, each
moved once); see the note at the top of the CUDA source.

``moe_gmm`` launches the kernel for CUDA tensors and counts each launch in
the module-level ``launches``; for CPU tensors it runs ``moe_gmm_plain``.
There is no fallback: a CUDA input that the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_product

#: Kernel launches since import (or since the caller last reset it).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Rows past this would overflow the kernel's 32-bit row sums.
MAX_ROWS = 1 << 25


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in PyTorch: one fp32 matmul per non-empty
    group, rounded once to x's dtype.  Rows are assigned to groups as the
    JAX oracle assigns them (:func:`repro_torch.kernels.ref.group_bounds`
    reads the sizes on the host)."""
    def product(rows: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
        return (rows.float() @ we.float()).to(x.dtype)

    return grouped_product(x, w, group_sizes, product)


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    """Shapes, dtypes, devices and layout; reads no value of any tensor."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(
            f"want x (T, d_in) and w (E, d_in, d_out); got {tuple(x.shape)}, {tuple(w.shape)}"
        )
    if group_sizes.shape != (w.shape[0],) or group_sizes.dtype != torch.int32:
        raise ValueError(
            f"group_sizes must be an int32 tensor of shape ({w.shape[0]},); got "
            f"{group_sizes.dtype} {tuple(group_sizes.shape)}"
        )
    if w.shape[0] == 0:
        raise ValueError("w has no expert")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"kernel takes fp32 or bf16 x and w of one dtype; got {x.dtype}, {w.dtype}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"kernel takes at most {MAX_ROWS} rows; got {x.shape[0]}")
    for name, z in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if z.device != x.device:
            raise ValueError(f"{name} is on {z.device}, x on {x.device}")
        if not z.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("moe_gmm").moe_gmm_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def moe_gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (T, d_in) rows sorted by expert; w: (E, d_in, d_out); group_sizes:
    (E,) int32 summing to T → (T, d_out) in x's dtype.  CUDA tensors launch
    the kernel on the current stream without reading ``group_sizes`` on the
    host; CPU tensors take :func:`moe_gmm_plain`."""
    global launches
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on CUDA or CPU, not {x.device}")
    _check(x, w, group_sizes)
    t, d_in = x.shape
    e, _, d_out = w.shape
    out = x.new_empty((t, d_out))
    if out.numel() == 0:  # nothing to compute: no launch
        return out
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
                t, e, d_in, d_out, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError {rc}")
    launches += 1
    return out
