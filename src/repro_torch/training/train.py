"""Step factories on one device, mirroring ``repro.training.train``.

``make_prefill_step`` is the inference prefill: the full-sequence forward
from (params, batch) to logits.  The reference also builds a sharded,
jitted step over a mesh; the port runs eagerly on one device, and the
mesh and shardings come with the multi-GPU work (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from repro_torch.device import Device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ParamTree, forward


def make_prefill_step(
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    device: Device = "cuda",
) -> Callable[[ParamTree, Mapping[str, torch.Tensor]], torch.Tensor]:
    """Full-sequence forward (inference prefill) on ``device``:
    ``step(params, batch) → logits (B, S, V)``.  ``batch["tokens"]`` (B, S)
    is moved to the device; the params must already be there.  With
    ``impl="auto"`` attention, the SSD scan and the sorted MoE dispatch's
    grouped matmul run the hand-written kernels on a card and their plain
    twins on the CPU.  Asking for a card where there is none raises."""
    dev = resolve_device(device)

    def step(params: ParamTree, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        where = params["embed"].device
        if where != dev:
            raise ValueError(f"params are on {where}, the step runs on {dev}")
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        logits, _ = forward(params, {"tokens": tokens}, cfg, impl=impl,
                            moe_dispatch=moe_dispatch)
        return logits

    return step
