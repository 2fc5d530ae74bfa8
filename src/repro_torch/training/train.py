"""Step factories, mirroring ``repro.training.train``.

* ``make_train_step``: (params, opt_state, batch) → (params, opt_state,
  metrics): the gradient of ``next_token_loss`` by autograd (on a card
  through the hand-written kernels and their backward kernels: flash
  attention, the SSD scan and the grouped matmul),
  optional microbatch accumulation and per-layer rematerialisation, and
  an AdamW step.
* ``make_serve_step``: the one-token decode step, (params, cache, tokens)
  → (logits, cache).
* ``make_prefill_step``: the inference prefill, (params, batch) → logits.

Each runs eagerly on one device, or, given a ``mesh`` (a ``DeviceMesh``
from :mod:`repro_torch.launch.mesh`), on every rank of it, as the
reference's jitted steps run over its mesh:

* **storage** follows the reference's shardings: params, and AdamW's
  moments, are DTensors under ``param_pspecs`` (``serve=True`` for
  ``make_serve_step(..., serve_layout=True)``), caches under
  ``cache_pspecs`` (:func:`repro_torch.models.sharding.shard_tree`
  distributes them), batches and tokens under ``batch_pspecs`` (a
  DTensor, or a plain tensor that every rank holds whole, of which each
  rank takes its rows);
* **compute** is tensor parallel over ``model`` as the weights are
  stored (:mod:`repro_torch.models.layers`): each layer's leaves are
  gathered over the data axes when the layer runs, a rank keeps its block
  over ``model`` (:class:`~repro_torch.models.sharding.Gathered`), and
  the gradients go back to the storage placements as a reduce-scatter
  over the data axes: ZeRO-3 over the data axes, the batch split over
  them.  The loss is the mean over every token of the global batch,
  vocabulary-parallel over ``model``; ``grad_norm`` comes from
  all-reduced sums of squares, and AdamW updates each rank's shards.

A serve step attends over the attention caches where they lie: a leaf
split along T over ``model`` by the partials of each rank's slots,
combined across the ranks, and each rank writes the new token only into
its own slots.  The Mamba-2 layers compute each rank's SSD heads where
``model`` divides them, on its shard of the ``ssm`` cache, which is
never gathered.  The MoE FFN's ``sorted`` and ``scan`` dispatches
compute on gathered weights.  At one ``model`` rank the collectives over
``model`` are skipped.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import Device, mesh_device, resolve_device
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ParamTree, decode_step, forward, next_token_loss
from repro_torch.training import optimizer as opt


def _batch_on(batch: Mapping[str, torch.Tensor], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _check_params(params: ParamTree, dev: torch.device) -> None:
    where = params["embed"].device
    if where != dev:
        raise ValueError(f"params are on {where}, the step runs on {dev}")


def _device(mesh, device: Device) -> torch.device:
    """The step's device: the mesh's where there is one."""
    return resolve_device(device if mesh is None else mesh_device(mesh))


def _local_batch(batch, mesh, dev: torch.device, *,
                 split: bool) -> Tuple[Dict[str, torch.Tensor], bool]:
    """(this rank's rows of every batch leaf (see :func:`sharding.local_rows`),
    whether the tokens' rows split over the data axes).  ``split``: the
    batch must divide over the data axes."""
    batch = {k: v if isinstance(v, DTensor) else torch.as_tensor(v, device=dev)
             for k, v in batch.items()}
    specs = sharding.batch_pspecs(mesh, batch)
    for k, spec in specs.items():
        if split and spec[0] is None:
            raise ValueError(f"batch {k!r} of {tuple(batch[k].shape)} does not divide over the "
                             f"data axes {sharding.data_axes(mesh)}")
    local = {k: sharding.local_rows(v, mesh, specs[k]) for k, v in batch.items()}
    return local, specs["tokens"][0] is not None


def _rows_out(local: torch.Tensor, mesh, rows_split: bool) -> DTensor:
    """A step's output from this rank's rows: a DTensor sharded on dim 0
    over the data axes, or replicated where the batch did not split."""
    dp = sharding.data_axes(mesh) if rows_split else None
    spec = sharding.P(dp, *([None] * (local.dim() - 1)))
    return DTensor.from_local(local, mesh, sharding.placements(mesh, spec), run_check=False)


def _global_norm(grads, mesh) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares over the whole mesh, in
    fp32: each rank's shard's sum, divided by the number of ranks that
    hold the same shard, all-reduced once (the mesh spans the group)."""
    sizes = list(sharding.mesh_sizes(mesh).values())
    total = 0
    for _, g in opt.leaves(grads):
        copies = 1
        for n, p in zip(sizes, g.placements):
            copies *= n if isinstance(p, Replicate) else 1
        total = total + torch.sum(torch.square(g.to_local().float())) / copies
    dist.all_reduce(total)
    return torch.sqrt(total)


def _local(tree) -> Dict:
    """Each DTensor leaf's local shard (a view of its storage)."""
    with torch.no_grad():
        return opt.map_tree(lambda t: t.to_local(), tree)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: Optional[opt.AdamWConfig] = None,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    remat: bool = True,
    accum_steps: int = 1,
    device: Device = "cuda",
    mesh=None,
) -> Callable[[ParamTree, opt.AdamWState, Mapping[str, torch.Tensor]],
              Tuple[ParamTree, opt.AdamWState, Dict[str, torch.Tensor]]]:
    """One training step: ``step(params, opt_state, batch) → (params,
    opt_state, metrics)`` with ``loss``, ``grad_norm`` and ``lr``.

    The params must be on the device (with a ``mesh``: DTensors under
    ``param_pspecs``, and ``opt.init`` of them gives moments of the same
    placements); the step turns on their ``requires_grad``, takes the
    gradient of ``next_token_loss`` by autograd, and updates params and
    moments in place (the same objects come back).  ``accum_steps`` splits
    the batch into that many microbatches along its first axis (with a
    mesh, this rank's rows; it must divide them); their gradients are
    summed in fp32 and divided, as the reference's ``lax.scan`` does.  ``remat=True`` checkpoints each layer and saves
    only its matmuls' outputs (the counterpart of
    ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``), so
    attention (and, with a mesh, each weight's gather) runs again in the
    backward pass.  With a mesh the global batch must divide over the data
    axes.  A ``ref*`` impl is plain PyTorch on any device."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1; got {accum_steps}")
    opt_cfg = opt_cfg or opt.AdamWConfig()
    dev = _device(mesh, device)

    def loss_and_grads(view, batch: Dict[str, torch.Tensor]):
        loss = next_token_loss(view, batch, cfg, impl=impl, moe_dispatch=moe_dispatch,
                               remat=remat, mesh=mesh)
        loss.backward()
        return loss.detach()

    def step(params: ParamTree, opt_state: opt.AdamWState, batch: Mapping[str, torch.Tensor]):
        _check_params(params, dev)
        if mesh is None:
            view, batch = params, _batch_on(batch, dev)
        else:
            sharding.check_sharded(params, mesh, sharding.param_pspecs(mesh, params, cfg), "param")
            view, batch = sharding.Gathered(params, mesh), _local_batch(batch, mesh, dev,
                                                                        split=True)[0]
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if accum_steps == 1:
                loss = loss_and_grads(view, batch)
                grads = opt.map_tree(_grad_of, params)
            else:
                rows = batch["tokens"].shape[0]
                if rows % accum_steps:
                    raise ValueError(f"accum_steps={accum_steps} does not divide the {rows} rows "
                                     f"of the batch{' this rank holds' if mesh is not None else ''}")
                micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
                         for k, v in batch.items()}
                total = opt.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                                                requires_grad=False), params)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(accum_steps):
                    loss = loss + loss_and_grads(view, {k: v[i] for k, v in micro.items()})
                    for path, p in opt.leaves(params):
                        _leaf(total, path).add_(_grad_of(p))
                        p.grad = None
                grads = opt.map_tree(lambda g: g / accum_steps, total)
                loss = loss / accum_steps
        if mesh is None:
            params, opt_state, metrics = opt.apply(opt_cfg, grads, opt_state, params)
        else:
            local = opt.AdamWState(opt_state.step, _local(opt_state.m), _local(opt_state.v))
            _, local, metrics = opt.apply_with_norm(opt_cfg, _local(grads), local,
                                                    _local(params), _global_norm(grads, mesh))
            opt_state = opt.AdamWState(local.step, opt_state.m, opt_state.v)
        params.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    """A param's gradient; zeros where the loss did not reach it, as
    ``jax.grad`` gives them."""
    return p.grad if p.grad is not None else torch.zeros_like(p, requires_grad=False)


def _leaf(tree, path: str) -> torch.Tensor:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _model_gathered(cache_leaf: DTensor, mesh):
    """The placements of ``cache_leaf`` with every dim but the data axes
    gathered."""
    data = sharding.data_axes(mesh)
    return [p if n in data else Replicate()
            for n, p in zip(mesh.mesh_dim_names, cache_leaf.placements)]


def _model_split_dim(cache_leaf: DTensor, mesh) -> Optional[int]:
    """The dim of ``cache_leaf`` stored split over ``model`` (of more than
    one rank), else None."""
    place = cache_leaf.placements[list(mesh.mesh_dim_names).index(sharding.TP_AXIS)]
    if sharding.model_rank(mesh)[1] == 1 or not isinstance(place, Shard):
        return None
    return place.dim


def _slot_offset(cache_leaf: DTensor, mesh) -> Optional[int]:
    """This rank's first slot of an attention cache leaf (L, B, T, ...)
    split along T over ``model`` (of more than one rank), else None."""
    if _model_split_dim(cache_leaf, mesh) != 2:
        return None
    return sharding.model_rank(mesh)[0] * cache_leaf.to_local().shape[2]


def make_serve_step(
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    cache_update: str = "scatter",
    device: Device = "cuda",
    mesh=None,
    serve_layout: bool = False,
) -> Callable[[ParamTree, Dict[str, torch.Tensor], torch.Tensor],
              Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """One-token decode step: ``step(params, cache, tokens) → (logits
    (B, V), cache)``, the cache (from ``init_cache``) updated in place.
    Asking for a card where there is none raises.

    With a ``mesh``: the params are DTensors under ``param_pspecs`` (its
    ``serve=serve_layout`` layout) and the cache under ``cache_pspecs``;
    ``tokens`` is (B,), a DTensor or whole on every rank.  The step is
    tensor parallel over ``model`` as the weights are stored: in the
    serve layout every weight's contraction dim lies over ``model``, each
    rank multiplies its block of the activation's features by its block
    of the weight and ``model_sum`` adds the partials, so no weight is
    gathered over ``model``.  The attention caches stay where they lie
    (a leaf split along T is attended by partials, see
    :func:`repro_torch.models.decode_step`), and so does the ``ssm`` cache:
    its shard over ``model`` is the rank's SSD heads, which the rank
    computes (:func:`repro_torch.models.sharding.ssm_heads`).  The
    ``conv`` cache, whole on every rank, is stored split along its K − 1
    where |model| divides K − 1 (3 in every config of the zoo): only there
    is it gathered over ``model`` for the step, each rank writing back its
    own part.  The logits come back as a DTensor, its rows over the data
    axes."""
    dev = _device(mesh, device)

    def step(params: ParamTree, cache: Dict[str, torch.Tensor], tokens: torch.Tensor):
        _check_params(params, dev)
        if mesh is None:
            return decode_step(params, cache, torch.as_tensor(tokens, device=dev), cfg,
                               impl=impl, moe_dispatch=moe_dispatch, cache_update=cache_update)
        sharding.check_sharded(params, mesh, sharding.param_pspecs(mesh, params, cfg,
                                                                   serve=serve_layout), "param")
        sharding.check_sharded(cache, mesh, sharding.cache_pspecs(mesh, cache), "cache")
        local, split = _local_batch({"tokens": tokens}, mesh, dev, split=False)
        # the one leaf that decode reads whole and the rules may split over
        # ``model``: ``conv`` (L, B, K - 1, C), along K - 1 where |model|
        # divides it (the reference's rule for the SSM caches' dim 2)
        gathered = {k: _model_gathered(v, mesh) for k, v in cache.items()
                    if k == "conv" and _model_split_dim(v, mesh) is not None}
        work = {k: v.redistribute(mesh, gathered[k]).to_local() if k in gathered
                else v.to_local() for k, v in cache.items()}
        offsets = {k: _slot_offset(v, mesh) for k, v in cache.items() if k in sharding.ATTENTION_CACHES}
        logits, _ = decode_step(sharding.Gathered(params, mesh), work, local["tokens"], cfg,
                                impl=impl, moe_dispatch=moe_dispatch, cache_update=cache_update,
                                mesh=mesh, slot_offsets=offsets)
        for k, places in gathered.items():  # each rank's own part, from the gathered copy
            v = cache[k]
            back = DTensor.from_local(work[k], mesh, places, run_check=False)
            v.to_local().copy_(back.redistribute(mesh, v.placements).to_local())
        return _rows_out(logits, mesh, split), cache

    return step


def make_prefill_step(
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    device: Device = "cuda",
    mesh=None,
) -> Callable[[ParamTree, Mapping[str, torch.Tensor]], torch.Tensor]:
    """Full-sequence forward (inference prefill): ``step(params, batch) →
    logits (B, S, V)``, under ``torch.no_grad()`` (it builds no autograd
    graph).  Every entry of ``batch`` (``tokens`` (B, S), and a VLM's
    ``vision_embeds`` or an audio model's ``audio_frames``) is moved to the
    device and handed to ``forward``; the params must already be there.
    With ``impl="auto"`` attention, the SSD scan and the sorted MoE
    dispatch's grouped matmul run the hand-written kernels on a card and
    their plain twins on the CPU.  Asking for a card where there is none
    raises.  With a ``mesh``: the params are DTensors under
    ``param_pspecs``, each rank runs its rows of the batch, and the logits
    come back as a DTensor, its rows over the data axes."""
    dev = _device(mesh, device)

    @torch.no_grad()
    def step(params: ParamTree, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        _check_params(params, dev)
        if mesh is None:
            logits, _ = forward(params, _batch_on(batch, dev), cfg, impl=impl,
                                moe_dispatch=moe_dispatch)
            return logits
        sharding.check_sharded(params, mesh, sharding.param_pspecs(mesh, params, cfg), "param")
        local, split = _local_batch(batch, mesh, dev, split=False)
        logits, _ = forward(sharding.Gathered(params, mesh), local, cfg, impl=impl,
                            moe_dispatch=moe_dispatch, mesh=mesh)
        return _rows_out(logits, mesh, split)

    return step
