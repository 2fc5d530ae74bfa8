"""Roofline analysis on one H100 a rank, mirroring ``repro.launch.roofline``:
derive the three roofline terms from the dry-run records in
results/dryrun/ and identify each case's bottleneck.

    compute_term    = FLOPs / peak bf16 FLOP/s                  [per card]
    memory_term     = bytes accessed / HBM rate                 [per card]
    collective_term = Σ over links of weighted collective bytes
                      / that link's rate                        [per card]

FLOPs and bytes are the dry-run's per-rank counts of the port's eager
step (``repro_torch.launch.counter``: matmul-class FLOPs plus one an
elementwise output; unfused bytes), the direct full-depth count where the
record has one, else its extrapolation from shallow variants.  Collective bytes use
the reference's per-device result-shape proxy with all-reduce charged 2×
(ring = reduce-scatter + all-gather phases), each op's bytes over the
slowest link its group crosses: NVLink (``NVLINK_BW``) inside one node of
``CARDS_PER_NODE`` cards, one NIC (``NIC_BW``) across nodes.  The
denominators are ``repro_torch.launch.mesh``'s H100 SXM constants.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for training;
            2·N(_active)·D for inference (forward only).
The ratio MODEL_FLOPS / counted FLOPs measures how much of the work the
step dispatches is "useful" (remat, dense dispatch, replicated compute
over the model axis and unmasked attention push it down).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import HBM_BW, HBM_PER_CHIP, NIC_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import INPUT_SHAPES

# Time-conversion weights per collective kind (ring algorithm phases).
COLL_WEIGHT = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
#: Bytes/s a direction of each link a collective's group may cross.
LINK_BW = {"nvlink": NVLINK_BW, "nic": NIC_BW}


def model_flops(arch: str, shape_name: str) -> float:
    """Global MODEL_FLOPS for the case."""
    cfg = ARCHS[arch]
    shape = INPUT_SHAPES[shape_name]
    n = cfg.param_count(active_only=cfg.arch_type == "moe")
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: ONE token per sequence
    return 2.0 * n * shape.global_batch


def terms(flops: float, bytes_accessed: float, links: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The three roofline terms, seconds on one H100, of one rank's counts."""
    coll = sum(COLL_WEIGHT[k] * v / LINK_BW[link]
               for link, kinds in links.items() for k, v in kinds.items())
    return {"compute": flops / PEAK_FLOPS_BF16, "memory": bytes_accessed / HBM_BW,
            "collective": coll}


def analyze(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if not rec.get("ok") or rec.get("skipped"):
        return None
    src = rec if rec.get("direct") else rec["corrected"]
    t = terms(src["flops"], src["bytes_accessed"], src["links"])
    dominant = max(t, key=t.get)
    mf = model_flops(rec["arch"], rec["shape"])
    counted_global = src["flops"] * rec["n_chips"]
    bound = max(t.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "compute_s": t["compute"],
        "memory_s": t["memory"],
        "collective_s": t["collective"],
        "dominant": dominant,
        "model_flops": mf,
        "counted_flops_global": counted_global,
        "useful_ratio": mf / counted_global if counted_global else 0.0,
        "state_gib_per_chip": rec["state_bytes_per_device"] / 2**30,
        "peak_gib_per_chip": rec["peak_bytes"] / 2**30,
        "fits_hbm": rec["state_bytes_per_device"] < HBM_PER_CHIP,
        "peak_fits_hbm": rec["peak_bytes"] < HBM_PER_CHIP,
        "step_time_lb_s": bound,
        "roofline_frac": t["compute"] / bound if bound else 0.0,
    }


def load_all(result_dir: str) -> List[Dict[str, Any]]:
    out = []
    for path in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        a = analyze(rec)
        if a:
            out.append(a)
    return out


def render_table(rows: List[Dict[str, Any]], mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | bottleneck "
        "| useful % | state GiB/card | peak GiB/card | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']*100:.1f} | "
            f"{r['state_gib_per_chip']:.2f} | {r['peak_gib_per_chip']:.2f} | "
            f"{'✓' if r['fits_hbm'] else '✗'} |"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json-out", default="results/roofline.json")
    args = ap.parse_args(argv)
    rows = load_all(args.dir)
    print(render_table(rows, args.mesh))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\n{len(rows)} cases → {args.json_out}")
    mine = [r for r in rows if r["mesh"] == args.mesh]
    print(f"\nState over {HBM_PER_CHIP / 1e9:.0f} GB a card ({args.mesh}): "
          + (", ".join(f"{r['arch']} {r['shape']} ({r['state_gib_per_chip']:.1f} GiB)"
                       for r in mine if not r["fits_hbm"]) or "none"))
    print(f"Peak over {HBM_PER_CHIP / 1e9:.0f} GB a card ({args.mesh}): "
          + (", ".join(f"{r['arch']} {r['shape']} ({r['peak_gib_per_chip']:.1f} GiB)"
                       for r in mine if not r["peak_fits_hbm"]) or "none"))
    # Highlight candidates for the perf hillclimb.
    ranked = sorted(mine, key=lambda r: r["roofline_frac"])
    print("\nWorst roofline fraction (compute/dominant):")
    for r in ranked[:5]:
        print(
            f"  {r['arch']:22s} {r['shape']:12s} frac={r['roofline_frac']:.3f}"
            f" dominant={r['dominant']}"
        )


if __name__ == "__main__":
    main()
