"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``,
the port's ``repro.launch.train``.

Builds the sharded train step for the architecture (its reduced config in
fp32 by default, ``--full`` for the assigned one), drives the synthetic
data pipeline (every rank draws the same global batch and takes its rows)
and writes checkpoints through ``training/checkpoint.py``: every rank
gathers the params, rank 0 writes them.

Every family trains with ``impl="auto"``: on a card through the
hand-written kernels and their backward kernels (flash attention, the SSD
scan, the grouped matmul), on the CPU through their plain twins.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --device cpu --steps 5
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train --arch ...
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.device import mesh_device
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.models import sharding
from repro_torch.training import checkpoint, make_train_step, optimizer as opt


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--moe-dispatch", default="sorted", choices=["sorted", "scan", "ep"])
    ap.add_argument("--full", action="store_true", help="the full assigned config")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(dtype="float32")
    mesh = (make_production_mesh(device=args.device) if args.production_mesh
            else make_debug_mesh(device=args.device))
    dev = mesh_device(mesh)
    lead = dist.get_rank() == 0
    if lead:
        print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
              f"mesh={sharding.mesh_sizes(mesh)} device={dev.type}", flush=True)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
    state = opt.init(params)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                           total_steps=args.steps)
    step = make_train_step(cfg, ocfg, moe_dispatch=args.moe_dispatch, remat=False,
                           accum_steps=args.accum, mesh=mesh)
    data = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    dtype = getattr(torch, cfg.dtype)

    def save(done: int) -> None:
        gathered = sharding.gather_tree(params)  # a collective: every rank
        if lead:
            checkpoint.save(args.ckpt, {"params": gathered}, metadata={"step": done})

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {"tokens": next(data)["tokens"]}
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = torch.zeros((args.batch, 9, cfg.d_model), dtype=dtype,
                                                 device=dev)
        if cfg.arch_type == "audio":
            batch["audio_frames"] = torch.zeros((args.batch, cfg.n_audio_frames, cfg.d_model),
                                                dtype=dtype, device=dev)
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        if lead and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:5d} loss {losses[-1]:7.3f} gnorm {float(metrics['grad_norm']):6.2f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)", flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    if args.ckpt:
        save(args.steps)
        if lead:
            print(f"checkpoint → {args.ckpt}", flush=True)
    return dict(losses=losses, params=params, impl="auto")


if __name__ == "__main__":
    main()
