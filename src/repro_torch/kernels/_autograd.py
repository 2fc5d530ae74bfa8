"""What a kernel wrapper does with autograd on a CUDA tensor.

A kernel fills its output through ctypes, so the tensor it returns has no
``grad_fn``.  Flash attention, the SSD scan and the grouped matmul go
through ``torch.autograd.Function``s whose backward is a kernel too,
where :func:`wants_grad` holds.  Decode attention (and its partials and
their combine) serves inference only and has no backward: its wrappers
call :func:`refuse_grad` first, which raises rather than return a result
cut off from the graph.
"""

from __future__ import annotations

from typing import Optional

import torch


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Grad mode is on and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``NotImplementedError`` where :func:`wants_grad` holds."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{name} is decode attention for inference and has no backward: run it under "
            f"torch.no_grad(), on the CPU, or with impl='ref'"
        )
