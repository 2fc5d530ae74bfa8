"""Step factories on one device, mirroring ``repro.training.train``.

* ``make_train_step``: (params, opt_state, batch) → (params, opt_state,
  metrics): the gradient of ``next_token_loss`` by autograd (attention's
  through the flash kernel and its hand-written backward on a card),
  optional microbatch accumulation and per-layer rematerialisation, and
  an AdamW step.
* ``make_serve_step``: the one-token decode step, (params, cache, tokens)
  → (logits, cache).
* ``make_prefill_step``: the inference prefill, (params, batch) → logits.

The reference builds sharded, jitted steps over a mesh; the port runs
eagerly on one device, and the mesh and shardings come with the
multi-GPU work (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.device import Device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ParamTree, decode_step, forward, next_token_loss
from repro_torch.training import optimizer as opt

#: The impls under which every op of the step is plain PyTorch.
PLAIN_IMPLS = ("ref", "ref_grouped", "ref_chunked", "ref_sequential")
#: The families whose kernels have no backward on the card yet.
NO_CARD_BACKWARD = ("ssm", "hybrid", "moe")


def _batch_on(batch: Mapping[str, torch.Tensor], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _check_params(params: ParamTree, dev: torch.device) -> None:
    where = params["embed"].device
    if where != dev:
        raise ValueError(f"params are on {where}, the step runs on {dev}")


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: Optional[opt.AdamWConfig] = None,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    remat: bool = True,
    accum_steps: int = 1,
    device: Device = "cuda",
) -> Callable[[ParamTree, opt.AdamWState, Mapping[str, torch.Tensor]],
              Tuple[ParamTree, opt.AdamWState, Dict[str, torch.Tensor]]]:
    """One training step on ``device``: ``step(params, opt_state, batch) →
    (params, opt_state, metrics)`` with ``loss``, ``grad_norm`` and ``lr``.

    The params must be on the device; the step turns on their
    ``requires_grad``, takes the gradient of ``next_token_loss`` by
    autograd, and updates params and moments in place (the same objects
    come back).  ``accum_steps`` splits the batch into that many
    microbatches along its first axis; their gradients are summed in fp32
    and divided, as the reference's ``lax.scan`` does.  ``remat=True``
    checkpoints each layer and saves only its matmuls' outputs (the
    counterpart of ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``),
    so attention runs again in the backward pass.

    On a card, with ``impl`` "auto" or "kernel", the SSM, hybrid and MoE
    families raise ``NotImplementedError``: the SSD scan and the grouped
    matmul have no backward kernel yet (ROADMAP Queue 2).  A ``ref*`` impl
    is plain PyTorch on any device."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1; got {accum_steps}")
    opt_cfg = opt_cfg or opt.AdamWConfig()
    dev = resolve_device(device)
    if dev.type == "cuda" and impl not in PLAIN_IMPLS and cfg.arch_type in NO_CARD_BACKWARD:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}) cannot train on the card yet: the backward "
            f"kernels of ssd_scan and moe_gmm are ROADMAP Queue 2; pass device='cpu' or "
            f"impl='ref'"
        )

    def loss_and_grads(params: ParamTree, batch: Dict[str, torch.Tensor]):
        loss = next_token_loss(params, batch, cfg, impl=impl, moe_dispatch=moe_dispatch,
                               remat=remat)
        loss.backward()
        return loss.detach()

    def step(params: ParamTree, opt_state: opt.AdamWState, batch: Mapping[str, torch.Tensor]):
        _check_params(params, dev)
        batch = _batch_on(batch, dev)
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if accum_steps == 1:
                loss = loss_and_grads(params, batch)
                grads = opt.map_tree(_grad_of, params)
            else:
                micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
                         for k, v in batch.items()}
                total = opt.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                           device=p.device), params)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(accum_steps):
                    loss = loss + loss_and_grads(params, {k: v[i] for k, v in micro.items()})
                    for path, p in opt.leaves(params):
                        _leaf(total, path).add_(_grad_of(p))
                        p.grad = None
                grads = opt.map_tree(lambda g: g / accum_steps, total)
                loss = loss / accum_steps
        params, opt_state, metrics = opt.apply(opt_cfg, grads, opt_state, params)
        params.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    """A param's gradient; zeros where the loss did not reach it, as
    ``jax.grad`` gives them."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _leaf(tree, path: str) -> torch.Tensor:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def make_serve_step(
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    cache_update: str = "scatter",
    device: Device = "cuda",
) -> Callable[[ParamTree, Dict[str, torch.Tensor], torch.Tensor],
              Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """One-token decode step on ``device``: ``step(params, cache, tokens) →
    (logits (B, V), cache)``, the cache (from ``init_cache``) updated in
    place.  Asking for a card where there is none raises."""
    dev = resolve_device(device)

    def step(params: ParamTree, cache: Dict[str, torch.Tensor], tokens: torch.Tensor):
        _check_params(params, dev)
        return decode_step(params, cache, torch.as_tensor(tokens, device=dev), cfg, impl=impl,
                           moe_dispatch=moe_dispatch, cache_update=cache_update)

    return step


def make_prefill_step(
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    device: Device = "cuda",
) -> Callable[[ParamTree, Mapping[str, torch.Tensor]], torch.Tensor]:
    """Full-sequence forward (inference prefill) on ``device``:
    ``step(params, batch) → logits (B, S, V)``, under ``torch.no_grad()``
    (it builds no autograd graph).  Every entry of ``batch``
    (``tokens`` (B, S), and a VLM's ``vision_embeds`` or an audio model's
    ``audio_frames``) is moved to the device and handed to ``forward``; the
    params must already be there.  With
    ``impl="auto"`` attention, the SSD scan and the sorted MoE dispatch's
    grouped matmul run the hand-written kernels on a card and their plain
    twins on the CPU.  Asking for a card where there is none raises."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params: ParamTree, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        _check_params(params, dev)
        logits, _ = forward(params, _batch_on(batch, dev), cfg, impl=impl,
                            moe_dispatch=moe_dispatch)
        return logits

    return step
