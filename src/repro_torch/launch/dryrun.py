"""Multi-pod dry-run, mirroring ``repro.launch.dryrun``.

For every (architecture × input shape × mesh) combination this runs the
port's own step (``make_train_step`` / ``make_prefill_step`` /
``make_serve_step``, with ``mesh=``) on fake tensors over a fake process
group of the production mesh's 256 or 512 ranks
(:func:`repro_torch.launch.specs.abstract_world`), as rank 0 runs it, and
records what :class:`repro_torch.launch.counter.StepCounter` counts:

  * FLOPs and bytes accessed a rank (the reference's
    ``compiled.cost_analysis()``; see the counter for the rules),
  * collective bytes a rank by kind (the reference's
    ``parse_collective_bytes`` of the optimized HLO),
  * the step's peak live bytes a rank (the reference's
    ``compiled.memory_analysis()``),
  * the state bytes a device: the local shards of the DTensor params
    (and moments, or cache) under ``models/sharding.py``'s rules.

Nothing touches a device and nothing is allocated.  The count is of what
the port dispatches, eagerly and unfused, on the ``ref`` path (the
reference's ``attn_impl="ref"``): the hand kernels cannot be counted and
refuse to launch inside a count.

Results are written as JSON (one file per case) under --out; the roofline
(``repro_torch.launch.roofline``) reads them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--both-meshes]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
from fractions import Fraction
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.counter import StepCounter
from repro_torch.launch.specs import (
    TRAIN_ACCUM,
    abstract_cache,
    abstract_world,
    batch_specs,
    build_case,
    decode_capacity,
    skip_reason,
)
from repro_torch.models import abstract_params, sharding
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.training import optimizer as opt
from repro_torch.training.train import make_prefill_step, make_serve_step, make_train_step

#: AdamW's moments in the count, as the reference's ``abstract_opt_state``.
MOMENT_DTYPE = torch.bfloat16
#: The production meshes: (shape, axis names) by name.
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's leaves: a DTensor's local shard,
    a plain tensor whole."""
    total = 0
    for _, t in opt.leaves(tree):
        local = t.to_local() if isinstance(t, DTensor) else t
        total += local.numel() * local.element_size()
    return total


def _shard_case(case: Dict[str, Any], mesh, serve_layout: bool,
                moment_dtype: torch.dtype = MOMENT_DTYPE) -> Dict[str, Any]:
    """The case's params (and cache) as DTensors under the reference's
    rules, as the steps take them (``mesh`` None: as they are), and a
    train case's AdamW moments in ``moment_dtype`` beside the params, in
    the mode the params are in (fake or real)."""
    cfg = case["cfg"]
    out = dict(case)
    params = case["params"]
    if mesh is not None:
        serve = case["kind"] == "decode" and serve_layout
        params = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg,
                                                                          serve=serve))
        if case["kind"] == "decode":
            out["cache"] = sharding.shard_tree(case["cache"], mesh,
                                               sharding.cache_pspecs(mesh, case["cache"]))
    out["params"] = params
    if case["kind"] == "train":
        out["opt_state"] = opt.init(params, moment_dtype=moment_dtype)
    return out


def state_bytes(case: Dict[str, Any]) -> int:
    """Per-device bytes of the step's state: params, plus AdamW's two
    moments (train) or the cache (decode), from the local shards."""
    total = local_bytes(case["params"])
    if case["kind"] == "train":
        total += local_bytes(case["opt_state"].m) + local_bytes(case["opt_state"].v)
    elif case["kind"] == "decode":
        total += local_bytes(case["cache"])
    return total


def prepare_step(case: Dict[str, Any], mesh, moe_dispatch: str, attn_impl: str = "ref",
                 cache_update: str = "scatter", serve_layout: bool = False,
                 device: str = "cpu", moment_dtype: torch.dtype = MOMENT_DTYPE):
    """(step, its arguments, the state bytes a device) of ``case``: its
    tree sharded over ``mesh`` (None: one device, no mesh) and its step
    factory's step, ready to run once."""
    kind, cfg = case["kind"], case["cfg"]
    case = _shard_case(case, mesh, serve_layout, moment_dtype)
    kw = dict(impl=attn_impl, moe_dispatch=moe_dispatch, device=device, mesh=mesh)
    if kind == "train":
        step = make_train_step(cfg, accum_steps=case["accum_steps"], **kw)
        args = (case["params"], case["opt_state"], case["batch"])
    elif kind == "prefill":
        step = make_prefill_step(cfg, **kw)
        args = (case["params"], case["batch"])
    else:
        step = make_serve_step(cfg, cache_update=cache_update, serve_layout=serve_layout, **kw)
        args = (case["params"], case["cache"], case["tokens"])
    return step, args, state_bytes(case)


def rank_accum(accum_steps: int, global_batch: int, mesh) -> int:
    """The microbatch count of a train case on ``mesh``: the port splits
    each rank's rows into microbatches (the reference splits the global
    batch and lets GSPMD lay each one out), so it takes the largest count
    up to ``accum_steps`` that divides a rank's rows.  Where the rows are
    as many as ``accum_steps`` or more, that is ``accum_steps`` itself:
    on 2x16x16 llama3-405b's 8 rows a rank take 8 for the spec's 16, one
    row a rank a microbatch as on 16x16."""
    rows = global_batch // sharding._axis_size(mesh, sharding.data_axes(mesh))
    return max(n for n in range(1, min(accum_steps, rows) + 1) if rows % n == 0)


def count_case(case: Dict[str, Any], mesh, moe_dispatch: str, **kw) -> Dict[str, Any]:
    """Run ``case``'s step once (:func:`prepare_step`, which takes ``kw``)
    inside a :class:`StepCounter` and return the counts with the state
    bytes a device.  The tensors must be fake (or real, for a count of a
    step run for real)."""
    step, args, resident = prepare_step(case, mesh, moe_dispatch, **kw)
    with StepCounter(resident=resident) as counter:
        out = step(*args)
        del out
    rec = counter.counts.as_record()
    rec["state_bytes_per_device"] = resident
    return rec


def abstract_case(cfg, kind: str, shape, accum_steps: int = 1,
                  device: str = "cpu") -> Dict[str, Any]:
    """A case of ``cfg`` at the TRUE input shape, on fake tensors (``cfg``
    is already the serving config for a decode shape): what
    :func:`~repro_torch.launch.specs.build_case` gives, for any config."""
    if kind == "train":  # the moments come with the step (prepare_step)
        return {"kind": kind, "cfg": cfg, "params": abstract_params(cfg, device),
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len, device),
                "accum_steps": accum_steps}
    if kind == "prefill":
        return {"kind": kind, "cfg": cfg, "params": abstract_params(cfg, device),
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len, device)}
    _, capacity = decode_capacity(cfg, shape)
    return {"kind": kind, "cfg": cfg, "params": abstract_params(cfg, device),
            "cache": abstract_cache(cfg, shape.global_batch, capacity, device),
            "tokens": batch_specs(cfg, shape.global_batch, 1, device)["tokens"].reshape(-1)}


_LINEAR = ("flops", "matmul_flops", "bytes_accessed", "peak_bytes", "state_bytes_per_device")


def _combine(u: Dict, v: Dict, fu, fv) -> Dict:
    """fu*u + fv*v elementwise over the counts and the collectives, in exact
    rational arithmetic (a rank's FLOPs pass 2**53)."""
    fu, fv = Fraction(fu), Fraction(fv)
    out = {k: fu * u[k] + fv * v[k] for k in _LINEAR}
    out["collectives"] = {k: fu * u["collectives"][k] + fv * v["collectives"][k]
                          for k in u["collectives"]}
    out["links"] = {link: {k: fu * kinds[k] + fv * v["links"][link][k] for k in kinds}
                    for link, kinds in u["links"].items()}
    return out


def _number(x: Fraction):
    """An extrapolated count as an int where it is whole, else a float."""
    return int(x) if x.denominator == 1 else float(x)


def corrected_costs(cfg, kind: str, shape, mesh, moe_dispatch: str, accum_steps: int = 1,
                    attn_impl: str = "ref", cache_update: str = "scatter",
                    serve_layout: bool = False, device: str = "cpu") -> Dict[str, Any]:
    """Full-depth costs from small variants, the reference's extrapolation:
    count two shallow variants at the TRUE input shape and solve for the
    per-layer body and what lies outside the layers:
    U2 = outside + 2·body, U3 = outside + 3·body →
    total = U2 + (L − 2)·(U3 − U2).  Hybrids get a third variant to
    separate the shared-attention body from the per-layer SSM body
    (applications = L // attn_period); audio models scale the encoder
    with the decoder.  The reference takes 1 and 2 layers; here no stack
    is one layer deep (nor the hybrid's shared-block cache one
    application deep), since DTensor moves a stack of one, with a batch
    of one in front of a sharded dim, without the copy it makes for
    deeper ones.

    The reference needs this because XLA counts a loop body once; an eager
    count is exact layer by layer, so the extrapolation of FLOPs, bytes
    and collectives equals a direct count of the full depth (``run_case``
    records both), and it is what keeps a sweep short.  The state bytes
    are linear in depth and extrapolate exactly; the peak is not (it is
    the largest of terms linear in depth, and which one is largest may
    change with depth), so its extrapolation is an estimate."""
    def variant(n_layers, attn_period=None):
        kw = dict(n_layers=n_layers)
        if attn_period is not None:
            kw["attn_period"] = attn_period
        if cfg.arch_type == "audio":
            kw["n_encoder_layers"] = n_layers
        vcfg = dataclasses.replace(cfg, **kw)
        return count_case(abstract_case(vcfg, kind, shape, accum_steps, device), mesh,
                          moe_dispatch, attn_impl=attn_impl, cache_update=cache_update,
                          serve_layout=serve_layout, device=device)

    if cfg.arch_type == "hybrid":
        l_real = cfg.n_layers
        napp = l_real // cfg.attn_period
        u1 = variant(4, attn_period=2)   # outside + 4·ssm + 2·attn
        u2 = variant(8, attn_period=2)   # outside + 8·ssm + 4·attn
        u3 = variant(8, attn_period=4)   # outside + 8·ssm + 2·attn
        attn = _combine(u2, u3, Fraction(1, 2), Fraction(-1, 2))
        ssm = _combine(u3, u1, Fraction(1, 4), Fraction(-1, 4))
        outside = _combine(_combine(u1, ssm, 1, -4), attn, 1, -2)
        total = _combine(_combine(outside, ssm, 1, l_real), attn, 1, napp)
        return _whole(total, 3)

    if cfg.arch_type == "audio" and cfg.n_encoder_layers != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the extrapolation scales encoder and decoder together, "
                         f"so it needs as many of each ({cfg.n_encoder_layers} != {cfg.n_layers})")
    u2 = variant(2)
    u3 = variant(3)
    body = _combine(u3, u2, 1, -1)
    return _whole(_combine(u2, body, 1, cfg.n_layers - 2), 2)


def _whole(total: Dict, variants: int) -> Dict:
    out = {k: _number(total[k]) for k in _LINEAR}
    out["collectives"] = {k: _number(v) for k, v in total["collectives"].items()}
    out["links"] = {link: {k: _number(v) for k, v in kinds.items()}
                    for link, kinds in total["links"].items()}
    out["variants"] = variants
    return out


def run_case(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    moe_dispatch: str = "sorted",
    correct_costs: bool = True,
    attn_impl: str = "ref",
    cache_update: str = "scatter",
    serve_layout: bool = False,
    direct: bool = True,
) -> Dict[str, Any]:
    """One case's record.  ``direct``: count the step at full depth (its
    counts at the top level, with its peak); ``correct_costs``: the
    extrapolation from shallow variants (:func:`corrected_costs`) under
    ``corrected``.  One of the two is needed."""
    if not (direct or correct_costs):
        raise ValueError("run_case needs the direct count, the extrapolation, or both")
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "ok": False,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(skipped=True, reason=reason, ok=True)
        return rec

    mesh_shape, names = MESHES[mesh_name]
    with abstract_world(mesh_shape, names) as mesh:
        rec["n_chips"] = mesh.size()
        case = build_case(cfg, shape)
        cfg = case["cfg"]
        accum = case.get("accum_steps", 1)
        if case["kind"] == "train":
            accum = case["accum_steps"] = rank_accum(accum, shape.global_batch, mesh)
            rec["accum_steps"] = accum
            if accum != TRAIN_ACCUM.get(cfg.name, 1):
                rec["accum_steps_spec"] = TRAIN_ACCUM.get(cfg.name, 1)
        rec["model_params"] = cfg.param_count()
        rec["model_params_active"] = cfg.param_count(active_only=True)
        if direct:
            t0 = time.time()
            got = count_case(case, mesh, moe_dispatch, attn_impl=attn_impl,
                             cache_update=cache_update, serve_layout=serve_layout)
            rec["count_s"] = round(time.time() - t0, 2)
            rec.update(flops=got["flops"], matmul_flops=got["matmul_flops"],
                       bytes_accessed=got["bytes_accessed"], collectives=got["collectives"],
                       links=got["links"], peak_bytes=got["peak_bytes"],
                       state_bytes_per_device=got["state_bytes_per_device"], ops=got["ops"])
        del case
        if correct_costs:
            t0 = time.time()
            corr = corrected_costs(cfg, shape.kind, shape, mesh, moe_dispatch, accum_steps=accum,
                                   attn_impl=attn_impl, cache_update=cache_update,
                                   serve_layout=serve_layout)
            rec["corrected"] = {
                "flops": corr["flops"],
                "matmul_flops": corr["matmul_flops"],
                "bytes_accessed": corr["bytes_accessed"],
                "collectives": corr["collectives"],
                "links": corr["links"],
                "peak_bytes": corr["peak_bytes"],
                "state_bytes_per_device": corr["state_bytes_per_device"],
                "variants": corr["variants"],
                "variant_count_s": round(time.time() - t0, 2),
            }
            if not direct:
                rec["state_bytes_per_device"] = corr["state_bytes_per_device"]
                rec["peak_bytes"] = corr["peak_bytes"]  # an estimate (see above)
    rec["direct"] = direct
    rec["ok"] = True
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id, or ids joined by commas (default: all)")
    ap.add_argument("--shape", default=None,
                    help="input shape, or shapes joined by commas (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-dispatch", default="sorted", choices=["sorted", "scan", "ep"])
    ap.add_argument("--no-correct", action="store_true",
                    help="skip the extrapolation from shallow variants")
    ap.add_argument("--no-direct", action="store_true",
                    help="skip the full-depth count (the extrapolation stands in)")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args()
    # DTensor warns at each multi-pod gather that it takes two all-gathers
    # (pod, then data): the count has them, each
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    archs = args.arch.split(",") if args.arch else sorted(ARCHS)
    shapes = args.shape.split(",") if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = run_case(arch, shape, multi_pod=mp, moe_dispatch=args.moe_dispatch,
                                   correct_costs=not args.no_correct,
                                   direct=not args.no_direct)
                except Exception:
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "ok": False, "error": traceback.format_exc(),
                    }
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = "SKIP" if rec.get("skipped") else ("OK" if rec["ok"] else "FAIL")
                extra = ""
                if rec.get("ok") and not rec.get("skipped"):
                    corr = rec.get("corrected", {})
                    cf = corr.get("flops")
                    colls = rec.get("collectives") or corr["collectives"]
                    extra = (
                        (f" cflops={cf:.3e}" if cf else "")
                        + (f" flops={rec['flops']:.3e}" if "flops" in rec else "")
                        + f" state/dev={rec['state_bytes_per_device']/2**30:.2f}GiB"
                        f" peak/dev={rec['peak_bytes']/2**30:.2f}GiB"
                        f" coll={sum(v for k, v in colls.items() if k != 'count')/2**30:.2f}GiB"
                        + (f" count={rec['count_s']}s" if "count_s" in rec else "")
                        + (f" variants={corr['variant_count_s']}s" if corr else "")
                    )
                print(f"[{status}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} case(s) failed")


if __name__ == "__main__":
    main()
