"""The gradient of the grouped expert matmul: hand-written Hopper kernels
(``csrc/moe_gmm.cu``) and their plain PyTorch twins.

The Pallas kernel ``repro/kernels/moe_gmm.py::moe_gmm`` has no backward:
the reference differentiates its plain path (``ref.py::moe_gmm_ref``) with
XLA.  For out = x_e · w[e] on each expert's group of rows:

* ``moe_gmm_dx``: dx = dy_e · w[e]ᵀ, the same expert-sorted rows and group
  sizes.  It is the forward kernel (:func:`repro_torch.kernels.moe_gmm.launch`)
  with a layout flag that reads w[e] as its transpose, with no transposed
  copy of w: on the ``wgmma`` body w's slices arrive K-major by TMA and the
  B operand's transpose bit is off; the ``mma`` bodies stage w n-major and
  load B without ``ldmatrix``'s transpose; ``fp32`` stages it transposed.
  Bound by bytes at Qwen3-MoE's shapes, as the forward is.
* ``moe_gmm_dw``: dw[e] = x_eᵀ · dy_e, one (d_in, d_out) sum per expert over
  its rows, in fp32, written in w's dtype; an empty group writes zeros.  The
  kernel works out each group's rows on the device from the sizes (no host
  read).  Bodies ``wgmma`` (bf16 on Hopper's warpgroup products: a
  persistent grid, a TMA ring of 64-row slices, the tile stored by TMA),
  ``mma`` (bf16 on mma.sync, a two-stage cp.async ring), ``mma_elem``
  (bf16, element loads, any widths) and ``fp32``.  Bound by bytes: it must
  read x and dy once and write every expert's dw.  The sums keep one order
  (no split over rows, no atomics): a repeat is bit for bit.

The plain twins are :func:`~repro_torch.kernels.ref.grouped_matmul` on w's
transpose and :func:`~repro_torch.kernels.ref.grouped_matmul_wgrad` (the
backward of the ``ref`` path's op), in fp32 rounded once.  Each wrapper
takes them for CPU tensors and launches its kernel for CUDA tensors,
counting each launch in ``dx_launches``/``dx_by_body`` or
``dw_launches``/``dw_by_body``; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import moe_gmm as _fwd
from repro_torch.kernels.ref import grouped_matmul, grouped_matmul_wgrad

#: Launches of each kernel since import (or since the caller last reset them).
dx_launches = 0
dw_launches = 0
#: The same launches by body (reset them with the counts).
dx_by_body: Dict[str, int] = {}
dw_by_body: Dict[str, int] = {}

#: The C entry's number of each body of the weight gradient.
DW_BODIES = {"fp32": 0, "mma_elem": 1, "mma": 2, "wgmma": 3}


def dw_bodies_for(dtype: torch.dtype, d_in: int, d_out: int, aligned: bool,
                  n_experts: int = 1) -> Tuple[str, ...]:
    """The weight gradient's bodies that take these inputs, the preferred
    one first.  ``aligned``: x, dy and dw start on 16-byte boundaries;
    ``wgmma`` keeps two int32 rows per expert in shared memory, as the
    forward's does (at most ``WGMMA_MAX_EXPERTS``)."""
    if dtype == torch.float32:
        return ("fp32",)
    if dtype != torch.bfloat16:
        return ()
    if not (d_in % 8 == 0 and d_out % 8 == 0 and aligned):
        return ("mma_elem",)
    if n_experts > _fwd.WGMMA_MAX_EXPERTS:
        return ("mma", "mma_elem")
    return ("wgmma", "mma", "mma_elem")


def moe_gmm_dx_plain(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """dy (T, d_out) · w[e]ᵀ per group → (T, d_in) in dy's dtype, each group's
    product in fp32 rounded once."""
    return grouped_matmul(dy, w.transpose(1, 2), group_sizes, True)


def moe_gmm_dw_plain(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
                     n_experts: int) -> torch.Tensor:
    """x_eᵀ · dy_e per expert → (E, d_in, d_out) in x's dtype, zeros for an
    empty group, each product in fp32 rounded once."""
    return grouped_matmul_wgrad(x, dy, group_sizes, n_experts, True)


def moe_gmm_dx(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
               body: Optional[str] = None) -> torch.Tensor:
    """dy: (T, d_out) rows sorted by expert; w: (E, d_in, d_out) → dx (T,
    d_in) in dy's dtype.  CUDA tensors launch the forward kernel with w read
    as its transpose, through ``body`` (one of the forward's ``BODIES``) or
    the one its ``body_for`` picks; CPU tensors take :func:`moe_gmm_dx_plain`."""
    global dx_launches
    if dy.device.type == "cpu":
        return moe_gmm_dx_plain(dy, w, group_sizes)
    if dy.device.type != "cuda":
        raise ValueError(f"moe_gmm_dx runs on CUDA or CPU, not {dy.device}")
    dx, ran = _fwd.launch(dy, w, group_sizes, body, trans_w=True)
    if ran is not None:
        dx_launches += 1
        dx_by_body[ran] = dx_by_body.get(ran, 0) + 1
    return dx


def _dw_entry():
    """The weight gradient's C entry, built and typed at first use."""
    fn = _build.load("moe_gmm").moe_gmm_wgrad_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def moe_gmm_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor, n_experts: int, *,
               body: Optional[str] = None) -> torch.Tensor:
    """x: (T, d_in) and dy: (T, d_out), rows sorted by expert; group_sizes:
    (E,) int32 → dw (E, d_in, d_out) in x's dtype.  CUDA tensors launch the
    kernel on the current stream without reading ``group_sizes`` on the
    host, through ``body`` (one of ``DW_BODIES``) or the one
    :func:`dw_bodies_for` prefers; CPU tensors take :func:`moe_gmm_dw_plain`."""
    global dw_launches
    if x.device.type == "cpu":
        return moe_gmm_dw_plain(x, dy, group_sizes, n_experts)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm_dw runs on CUDA or CPU, not {x.device}")
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"want x (T, d_in) and dy (T, d_out); got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    if n_experts < 1 or group_sizes.shape != (n_experts,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be an int32 tensor of shape ({n_experts},); got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    if x.dtype not in _fwd._DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"kernel takes fp32 or bf16 x and dy of one dtype; got {x.dtype}, "
                        f"{dy.dtype}")
    if x.shape[0] > _fwd.MAX_ROWS:
        raise ValueError(f"kernel takes at most {_fwd.MAX_ROWS} rows; got {x.shape[0]}")
    for name, z in (("x", x), ("dy", dy), ("group_sizes", group_sizes)):
        if z.device != x.device:
            raise ValueError(f"{name} is on {z.device}, x on {x.device}")
        if not z.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t, d_in = x.shape
    d_out = dy.shape[1]
    dw = x.new_empty((n_experts, d_in, d_out))
    aligned = all(z.data_ptr() % 16 == 0 for z in (x, dy, dw))
    found = dw_bodies_for(x.dtype, d_in, d_out, aligned, n_experts)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {x.dtype} {d_in}x{d_out}"
                         f"{'' if aligned else ' (unaligned)'}; bodies that do: {found}")
    if dw.numel() == 0:  # nothing to compute: no launch
        return dw
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _dw_entry()(x.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(), dw.data_ptr(),
                         t, n_experts, d_in, d_out, _fwd._DTYPES[x.dtype], DW_BODIES[body],
                         stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm weight-gradient kernel ({body}) launch failed: cudaError {rc}")
    dw_launches += 1
    dw_by_body[body] = dw_by_body.get(body, 0) + 1
    return dw
