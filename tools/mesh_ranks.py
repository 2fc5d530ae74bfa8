#!/usr/bin/env python3
"""The port's sharded steps on every mesh of this process group, each
rank's results held to the mesh-less step that the rank runs itself.

    torchrun --nproc-per-node N tools/mesh_ranks.py [--device cuda|cpu] [--out DIR]

For a world of W ranks, every ``("data", "model")`` mesh (a, W / a):

* three ``make_train_step`` steps of a small dense model in fp32 (params
  and moments as DTensors, the batch split over ``data``): loss, grad
  norm and every param within ``REL`` of the mesh-less step's;
* four greedy ``make_serve_step`` tokens (the serve layout, the cache
  under ``cache_pspecs``): equal to the mesh-less step's;
* ``make_prefill_step``'s logits within ``REL``;

then, on (1, W), one MoE layer of the ``ep`` dispatch at a capacity that
keeps every replica (capacity factor W): its output and the gradients of
its input, router and experts against the ``sorted`` dispatch's; and on
(W, 1) the SST all-gather of every rank's row, bit for bit.  With
``--inputs FILE`` (the reference's MoE params and an input, as
``tests/test_torch_distributed.py`` writes them) it also runs that model's
``ep`` prefill and one layer at capacity factor 0.5 on (1, W), and with
``--out DIR`` each rank writes what it saw to ``DIR/out{RANK}.npz``.

Rank 0 prints one JSON line of the checks; the exit code is 1 when any
failed.  On cards each rank takes the card ``LOCAL_RANK`` and the group
runs over NCCL; on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

DENSE = dict(name="tiny", arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
             d_ff=64, vocab=64, dtype="float32")
MOE = dict(name="moe-t", arch_type="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_ff=0, vocab=97, n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
           dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
TRAIN_STEPS, SERVE_TOKENS = 3, 4
REL = 1e-5  # fp32: the ranks' shares sum in another order than one device's


def train_batches():
    import torch

    g = torch.Generator().manual_seed(11)
    return [{"tokens": torch.randint(0, 64, (4, 16), generator=g, dtype=torch.int32)}
            for _ in range(TRAIN_STEPS)]


def sst_row(rank: int) -> np.ndarray:
    from repro_torch.core import SSTRow
    from repro_torch.core.sst_exchange import pack_row

    return pack_row(SSTRow(ft_estimate_s=1.5 + rank, cache_bitmap=(5 << 40) | rank,
                           free_cache_bytes=2048.0 * (rank + 1), version=7 + rank,
                           heartbeat_s=0.25 * rank, epoch=3, draining=bool(rank)), queue_len=rank)


def close(got, want) -> bool:
    import torch

    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    return bool(((got - want).abs() <= 1e-6 + REL * want.abs()).all())


def shards_match(tree, mesh, specs) -> bool:
    """Every DTensor's local shard is ``sharding.local_shard`` of its full
    tensor at this rank's coordinates."""
    import torch
    from repro_torch.models import sharding
    from repro_torch.training import optimizer as opt

    sizes, where = sharding.mesh_sizes(mesh), sharding.coords(mesh)
    full = dict(opt.leaves(sharding.gather_tree(tree)))
    ok = True
    for path, d in opt.leaves(tree):
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        ok &= torch.equal(d.to_local(), sharding.local_shard(full[path], sizes, where, spec))
    return ok


def one_device(dev):
    """The mesh-less runs every mesh is held to: (losses, norms, params),
    the serve tokens and the prefill logits."""
    import torch
    from repro_torch.models import ModelConfig, init_cache, init_params
    from repro_torch.training import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.training import optimizer as opt

    cfg = ModelConfig(**DENSE)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu").to(dev)
    logits = make_prefill_step(cfg, device=dev)(params, train_batches()[0])
    state = opt.init(params)
    step = make_train_step(cfg, opt.AdamWConfig(**OPT), device=dev)
    metrics = []
    for batch in train_batches():
        params, state, m = step(params, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    served = init_params(cfg, torch.Generator().manual_seed(5), "cpu").to(dev)
    cache, serve = init_cache(cfg, 2, 8, device=dev), make_serve_step(cfg, device=dev)
    tok, toks = torch.ones(2, dtype=torch.int32, device=dev), []
    for _ in range(SERVE_TOKENS):
        out, cache = serve(served, cache, tok)
        tok = out.argmax(-1).to(torch.int32)
        toks.append(tok.cpu().numpy())
    return metrics, dict(opt.leaves(params)), np.stack(toks), logits


def on_mesh(mesh, dev, want, checks: Dict[str, bool], out: Dict[str, np.ndarray]) -> None:
    import torch
    from repro_torch.models import ModelConfig, init_cache, init_params, sharding
    from repro_torch.training import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.training import optimizer as opt

    tag = "x".join(str(n) for n in sharding.mesh_sizes(mesh).values())
    cfg = ModelConfig(**DENSE)
    metrics, params_want, toks_want, logits_want = want
    base = init_params(cfg, torch.Generator().manual_seed(5), "cpu").to(dev)
    specs = sharding.param_pspecs(mesh, base, cfg)
    params = sharding.shard_tree(base, mesh, specs)
    checks[f"shards {tag}"] = shards_match(params, mesh, specs)
    logits = make_prefill_step(cfg, mesh=mesh)(params, train_batches()[0]).full_tensor()
    checks[f"prefill {tag}"] = close(logits, logits_want)
    state = opt.init(params)
    step = make_train_step(cfg, opt.AdamWConfig(**OPT), mesh=mesh)
    got = []
    for batch in train_batches():
        params, state, m = step(params, state, batch)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    checks[f"moment shards {tag}"] = shards_match(state.m, mesh, specs)
    full = dict(opt.leaves(sharding.gather_tree(params)))
    checks[f"train metrics {tag}"] = close(got, metrics)
    checks[f"train params {tag}"] = all(close(full[p], t) for p, t in params_want.items())
    out[f"train_metrics_{tag}"] = np.array(got)
    for p, t in full.items():
        out[f"train_param_{tag}/{p}"] = t.detach().cpu().numpy()

    served = sharding.shard_tree(base.to(dev), mesh,
                                 sharding.param_pspecs(mesh, base, cfg, serve=True))
    cache = init_cache(cfg, 2, 8, device=dev)
    cache = sharding.shard_tree(cache, mesh, sharding.cache_pspecs(mesh, cache))
    serve = make_serve_step(cfg, mesh=mesh, serve_layout=True)
    tok, toks = torch.ones(2, dtype=torch.int32, device=dev), []
    for _ in range(SERVE_TOKENS):
        logits, cache = serve(served, cache, tok)
        tok = logits.full_tensor().argmax(-1).to(torch.int32)
        toks.append(tok.cpu().numpy())
    out[f"serve_tokens_{tag}"] = np.stack(toks)
    checks[f"serve tokens {tag}"] = bool((out[f"serve_tokens_{tag}"] == toks_want).all())


def ep_against_sorted(mesh, dev, checks: Dict[str, bool]) -> None:
    """One MoE layer at a capacity that keeps every replica: ``ep`` over
    ``mesh``'s model axis, its weights DTensors under ``param_pspecs`` read
    through ``Gathered`` (each rank's expert bank its own block), against
    ``sorted`` on this rank alone: the output and the gradients of the
    input and of every weight (gathered whole)."""
    import torch
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models import sharding

    cfg = ModelConfig(**MOE)
    params = init_params(cfg, torch.Generator().manual_seed(7), "cpu").to(dev)
    layer = {k: v.detach().clone() for k, v in params["layers"].layer(0)["moe"].items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(8)).to(dev)
    weight = torch.linspace(-1, 1, x.numel(), device=dev).view_as(x)
    cf = float(sharding.mesh_sizes(mesh)["model"])
    runs = {}
    for dispatch in ("sorted", "ep"):
        if dispatch == "ep":
            leaves = sharding.shard_tree(layer, mesh, sharding.param_pspecs(mesh, layer))
            view = sharding.Gathered(leaves, mesh)
        else:
            leaves = {k: v.clone() for k, v in layer.items()}
            view = leaves
        for v in leaves.values():
            v.requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        y, aux = moe_ffn(xi, view, top_k=cfg.top_k, dispatch=dispatch, impl="ref",
                         mesh=mesh if dispatch == "ep" else None, capacity_factor=cf)
        (y * weight).sum().backward()
        grads = {k: v.grad.full_tensor() if dispatch == "ep" else v.grad
                 for k, v in leaves.items()}
        runs[dispatch] = (y.detach(), float(aux.detach()), xi.grad, grads)
    (ys, auxs, gxs, gs), (ye, auxe, gxe, ge) = runs["sorted"], runs["ep"]
    tag = "x".join(str(n) for n in sharding.mesh_sizes(mesh).values())
    checks[f"ep output {tag}"] = close(ye, ys) and abs(auxe - auxs) <= REL * abs(auxs)
    checks[f"ep input grad {tag}"] = close(gxe, gxs)
    checks[f"ep param grads {tag}"] = all(close(ge[k], gs[k]) for k in gs)


def ep_of_the_reference(mesh, inputs: str, out: Dict[str, np.ndarray]) -> None:
    """The reference's MoE model and layer input (``inputs``): the ``ep``
    prefill's logits at the default capacity, and one layer at capacity
    factor 0.5, where ranks drop replicas."""
    import torch
    from repro_torch.device import mesh_device
    from repro_torch.models import ModelConfig, params_from_numpy
    from repro_torch.models import sharding
    from repro_torch.models.moe import moe_ffn
    from repro_torch.training import make_prefill_step

    arrays = dict(np.load(inputs))
    tokens, x = torch.as_tensor(arrays.pop("tokens")), torch.as_tensor(arrays.pop("moe_x"))
    tree: Dict = {}
    for key, val in arrays.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    cfg = ModelConfig(**MOE)
    dev = mesh_device(mesh)
    params = params_from_numpy(tree, cfg, dev)
    sharded = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
    prefill = make_prefill_step(cfg, moe_dispatch="ep", impl="ref", mesh=mesh)
    out["ep_logits"] = prefill(sharded, {"tokens": tokens}).full_tensor().cpu().numpy()
    with torch.no_grad():
        y, aux = moe_ffn(x.to(dev), params["layers"].layer(0)["moe"], top_k=cfg.top_k,
                         dispatch="ep", impl="ref", mesh=mesh, capacity_factor=0.5)
    out["ep_layer_y"], out["ep_layer_aux"] = y.cpu().numpy(), np.float64(aux)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="directory for each rank's out{RANK}.npz")
    ap.add_argument("--inputs", default=None, help="the reference's MoE params and input (.npz)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from repro_torch.core.sst_exchange import make_sst_allgather
    from repro_torch.device import mesh_device
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    first = make_debug_mesh(device=args.device)  # (W, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = mesh_device(first)
    checks: Dict[str, bool] = {}
    out: Dict[str, np.ndarray] = {}
    want = one_device(dev)
    shapes = [(a, world // a) for a in range(world, 0, -1) if world % a == 0]
    for shape in shapes:
        on_mesh(make_mesh(shape, ("data", "model"), args.device), dev, want, checks, out)
    model_mesh = make_mesh((1, world), ("data", "model"), args.device)
    ep_against_sorted(model_mesh, dev, checks)
    if args.inputs:
        ep_of_the_reference(model_mesh, args.inputs, out)
    table = make_sst_allgather(first, axis="data")(sst_row(rank)[None]).cpu().numpy()
    out["sst_table"] = table
    checks[f"sst all-gather {world}x1"] = bool(
        (table == np.stack([sst_row(r) for r in range(world)])).all())
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        np.savez(Path(args.out) / f"out{rank}.npz", **out)
    ok = all(checks.values())
    flags = torch.tensor([int(ok)], device=dev)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    if rank == 0:
        print(json.dumps({"world": world, "backend": dist.get_backend(), "device": dev.type,
                          "meshes": shapes, "checks": checks, "ok": bool(flags.item())}))
    dist.destroy_process_group()
    return 0 if flags.item() else 1


if __name__ == "__main__":
    sys.exit(main())
