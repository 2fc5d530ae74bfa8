"""What a kernel wrapper does with autograd on a CUDA tensor.

A kernel fills its output through ctypes, so the tensor it returns has no
``grad_fn``.  A wrapper whose kernel has no backward yet calls
:func:`refuse_grad` first: while grad mode is on and an input requires
grad, it raises rather than return a result cut off from the graph.
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
            f"{name} has no backward kernel on the card yet (ROADMAP Queue 2): run it "
            f"under torch.no_grad(), on the CPU, or with impl='ref'"
        )
