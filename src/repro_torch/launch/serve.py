"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``,
the port's ``repro.launch.serve``.

Builds the sharded one-token serve step for the architecture (its reduced
config in fp32 by default, ``--full`` for the assigned one), runs batched
greedy decode from a token of ones for ``--tokens`` steps, and prints the
decode rate and the time a step.  ``--optimized`` takes the reference's
serving path (the grouped decode oracle, one-hot cache writes, the ``ep``
dispatch for MoE archs); without it decode attention runs on its kernel
(``impl="auto"``) and MoE on the sorted dispatch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --device cpu
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.serve --arch ...

The mesh is ``make_debug_mesh`` (every rank as data parallel) or, with
``--production-mesh``, the (16, 16) pod.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.device import mesh_device
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import ModelConfig, init_cache, init_params
from repro_torch.models import sharding
from repro_torch.training import make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, mesh, *, batch: int = 4, capacity: int = 256, tokens: int = 64,
          optimized: bool = False, seed: int = 0) -> Dict[str, Any]:
    """Greedy decode of ``tokens`` steps at ``batch`` over ``mesh``, from
    params seeded with ``seed`` (the same on every rank).  Returns the
    tokens (steps, batch), the unsharded params, the path taken and the
    time a step (over every step but the first)."""
    dev = mesh_device(mesh)
    path = dict(impl="ref_grouped" if optimized else "auto",
                cache_update="onehot" if optimized else "scatter",
                moe_dispatch="ep" if (optimized and cfg.n_experts) else "sorted")
    step = make_serve_step(cfg, mesh=mesh, **path)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    sharded = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
    cache = init_cache(cfg, batch, capacity, device=dev)
    cache = sharding.shard_tree(cache, mesh, sharding.cache_pspecs(mesh, cache))
    tok = torch.ones((batch,), dtype=torch.int32, device=dev)
    out = []
    logits, cache = step(sharded, cache, tok)  # first token
    tok = logits.full_tensor().argmax(-1).to(torch.int32)
    out.append(tok)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(tokens - 1):
        logits, cache = step(sharded, cache, tok)
        tok = logits.full_tensor().argmax(-1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    steps = max(tokens - 1, 1)
    return dict(tokens=torch.stack(out).cpu().numpy(), params=params, path=path,
                ms_per_step=dt / steps * 1e3, tokens_per_s=(tokens - 1) * batch / dt if dt else 0.0)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the reference's serving path (grouped decode, onehot writes, ep MoE)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(dtype="float32")
    if cfg.arch_type == "audio":
        raise SystemExit("use examples/serve_cluster.py for enc-dec serving")
    mesh = (make_production_mesh(device=args.device) if args.production_mesh
            else make_debug_mesh(device=args.device))
    out = serve(cfg, mesh, batch=args.batch, capacity=args.capacity, tokens=args.tokens,
                optimized=args.optimized)
    if dist.get_rank() == 0:
        print(f"{cfg.name}: {out['tokens_per_s']:,.0f} tokens/s ({out['ms_per_step']:.1f} "
              f"ms/step, batch {args.batch}, mesh {dict(sharding.mesh_sizes(mesh))}, "
              f"{'optimized' if args.optimized else 'baseline'} path: {out['path']}, "
              f"on {mesh.device_type})", flush=True)
    return out


if __name__ == "__main__":
    main()
