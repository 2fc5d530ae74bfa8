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

The kernel has five bodies (see the CUDA source): ``wgmma`` (bf16 on
Hopper's warpgroup products fed by TMA), ``decode`` (the same for a few
rows: the weights on wgmma's M side, a group's rows on its N), ``mma``
(bf16 on mma.sync), ``mma_elem`` (bf16 with element loads, for ragged
widths) and ``fp32``.  :func:`body_for` picks one from the dtype, the
widths, the alignment, the expert count and the rows (``decode`` at up to
``DECODE_MAX_ROWS``, never for the input gradient); a caller may name one
with ``body=`` to time or test it.

``moe_gmm`` launches the kernel for CUDA tensors and counts each launch in
the module-level ``launches`` and, by body, in ``launches_by_body``; for CPU
tensors it runs ``moe_gmm_plain``.  There is no fallback: a CUDA input that
no body takes, or a named body that cannot take it, raises.

Under grad mode, when x or w requires grad, the call goes through
:class:`MoeGmm`, a ``torch.autograd.Function`` whose backward is the
hand-written gradient (:mod:`repro_torch.kernels.moe_gmm_bwd`: dx on this
kernel with w read as its transpose, dw on a kernel of its own); on CPU
tensors, the plain twins.  The result is differentiable either way.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import wants_grad
from repro_torch.kernels.ref import grouped_matmul

#: Kernel launches since import (or since the caller last reset it).
launches = 0
#: The same launches by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"fp32": 0, "mma_elem": 1, "mma": 2, "wgmma": 3, "decode": 4}
#: Rows past this would overflow the kernel's 32-bit row sums.
MAX_ROWS = 1 << 25
#: The wgmma body keeps three int32 tables per expert in shared memory.
WGMMA_MAX_EXPERTS = 1024
#: The decode body takes at most one row tile of x: decode's token replicas
#: (B · top_k), not prefill's or training's.
DECODE_MAX_ROWS = 64


def bodies_for(dtype: torch.dtype, d_in: int, d_out: int, aligned: bool,
               n_experts: int, rows: Optional[int] = None,
               trans_w: bool = False) -> Tuple[str, ...]:
    """The bodies that take these inputs, the preferred one first.
    ``aligned``: x, w and the output start on 16-byte boundaries; ``rows``:
    x's (None where the caller does not say, and then no ``decode``);
    ``trans_w``: w read as each block's transpose (the input gradient)."""
    if dtype == torch.float32:
        return ("fp32",)
    if dtype != torch.bfloat16:
        return ()
    if not (d_in % 8 == 0 and d_out % 8 == 0 and aligned):  # whole 16-byte vectors
        return ("mma_elem",)
    found = ("mma", "mma_elem") if n_experts > WGMMA_MAX_EXPERTS else ("wgmma", "mma", "mma_elem")
    if rows is not None and rows <= DECODE_MAX_ROWS and not trans_w:
        return ("decode",) + found
    return found


def body_for(dtype: torch.dtype, d_in: int, d_out: int, aligned: bool = True,
             n_experts: int = 1, rows: Optional[int] = None, trans_w: bool = False) -> str:
    """The body a call with these inputs runs when it names none."""
    found = bodies_for(dtype, d_in, d_out, aligned, n_experts, rows, trans_w)
    if not found:
        raise TypeError(f"kernel takes fp32 or bf16; got {dtype}")
    return found[0]


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in PyTorch: one fp32 matmul per non-empty
    group, rounded once to x's dtype.  Rows are assigned to groups as the
    JAX oracle assigns them (:func:`repro_torch.kernels.ref.group_bounds`
    reads the sizes on the host, inside the op
    :func:`~repro_torch.kernels.ref.grouped_matmul`)."""
    return grouped_matmul(x, w, group_sizes, True)


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
           trans_w: bool = False) -> None:
    """Shapes, dtypes, devices and layout; reads no value of any tensor.
    ``trans_w``: w is read as each block's transpose, (E, d_out, d_in)."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[2 if trans_w else 1]:
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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, body: Optional[str],
           trans_w: bool = False) -> Tuple[torch.Tensor, Optional[str]]:
    """The kernel on CUDA tensors: (x @ w[e] for each group, or with
    ``trans_w`` x @ w[e]ᵀ, the body that ran or None where nothing was
    launched).  It counts nothing: its callers do."""
    _check(x, w, group_sizes, trans_w)
    t, d_in = x.shape
    e = w.shape[0]
    d_out = w.shape[1 if trans_w else 2]
    out = x.new_empty((t, d_out))
    aligned = all(z.data_ptr() % 16 == 0 for z in (x, w, out))
    found = bodies_for(x.dtype, d_in, d_out, aligned, e, t, trans_w)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {t} rows of {x.dtype} {d_in}->{d_out} "
                         f"over {e} experts{'' if aligned else ' (unaligned)'}"
                         f"{', w transposed' if trans_w else ''}; bodies that do: {found}")
    if out.numel() == 0:  # nothing to compute: no launch
        return out, None
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
                t, e, d_in, d_out, _DTYPES[x.dtype], BODIES[body], int(trans_w), stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel ({body}{', w transposed' if trans_w else ''}) "
                           f"launch failed: cudaError {rc}")
    return out, body


def _forward(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
             body: Optional[str]) -> torch.Tensor:
    """The kernel, counted, on CUDA tensors; the plain twin on CPU ones."""
    global launches
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on CUDA or CPU, not {x.device}")
    out, ran = launch(x, w, group_sizes, body)
    if ran is not None:
        launches += 1
        launches_by_body[ran] = launches_by_body.get(ran, 0) + 1
    return out


class MoeGmm(torch.autograd.Function):
    """The grouped matmul with its gradient: on CUDA tensors the forward
    kernel and the backward kernels of :mod:`moe_gmm_bwd`, on CPU tensors
    their plain twins."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, body):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes, body)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels import moe_gmm_bwd as _bwd  # it imports this module

        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _bwd.moe_gmm_dx(dy, w, group_sizes) if ctx.needs_input_grad[0] else None
        dw = (_bwd.moe_gmm_dw(x, dy, group_sizes, w.shape[0]) if ctx.needs_input_grad[1]
              else None)
        return dx, dw, None, None


def moe_gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
            body: Optional[str] = None) -> torch.Tensor:
    """x: (T, d_in) rows sorted by expert; w: (E, d_in, d_out); group_sizes:
    (E,) int32 summing to T → (T, d_out) in x's dtype.  CUDA tensors launch
    the kernel on the current stream without reading ``group_sizes`` on the
    host, through ``body`` (one of ``BODIES``) or, when it is None, the body
    :func:`body_for` picks; CPU tensors take :func:`moe_gmm_plain`.  Under
    grad mode with x or w requiring grad, the result is differentiable
    (:class:`MoeGmm`)."""
    if wants_grad(x, w):
        return MoeGmm.apply(x, w, group_sizes, body)
    return _forward(x, w, group_sizes, body)
