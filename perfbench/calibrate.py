"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload trio.chat --seeds 1,2,3 --decks 2

For each seed the weights are drawn again in place (the captured graphs
stay valid), ``--decks`` decks of the cell's traffic are served as a run
serves them, and the run's check (``harness.check_sides``) judges them
against the cell's own ``checks/<cell>.json`` twice: as served (the
program's readings, ``correct``), and with the token that the reference
computed in float8 puts first in each served token's place (the
control's readings, ``control_correct``, which has to come out false).
One JSON line a seed; ``--out`` writes them to a file too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--decks", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness as hb

    cell = hb.workload(args.workload)
    cfg, traffic = hb.config(cell["config"]), hb.traffic(cell["traffic"])
    limits = hb.checks(cell["name"])
    seeds = [int(s) for s in args.seeds.split(",")]
    dep = hb.Deployment(cfg, traffic, seeds[0], "cuda")
    hb.warm_up(dep, seeds[0])
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        dep.refill(seed)
        gen = hb.Traffic(traffic, cfg, seed)
        requests: list = []
        for _ in range(args.decks):
            hb.serve_deck(dep, gen, requests)
        sides = hb.check_sides(dep, requests, limits, seed, ("program", "control"))
        row = {"workload": args.workload, "seed": seed, "requests": len(requests),
               "correct": hb.passed(sides["program"]),
               "control_correct": hb.passed(sides["control"]),
               **{side: {k: v["value"] for k, v in rows.items()} for side, rows in sides.items()},
               "limits": {k: v["limit"] for k, v in sides["program"].items()},
               "seconds": time.perf_counter() - t0}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
