"""Run one cell of the benchmark once, on the CUDA card it is started on.

    python3 perfbench/run.py --workload trio.chat --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number the check compared
beside its limit, which also close standard error.  Exits non-zero and
prints no result without enough CUDA cards, or where the process holds
JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def process_age_s() -> float:
    """Seconds since this process started (the kernel's count), or since
    this file began to run where that is not readable."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def note(msg: str) -> None:
    """A line on standard error, stamped with the process's age."""
    print(f"[{process_age_s():8.2f} s] {msg}", file=sys.stderr, flush=True)


def fail(msg: str, code: int = 2) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    args = parse(argv)
    from perfbench import harness as hb

    bench = hb.spec()
    cell = hb.workload(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    torch.cuda.set_device(0)
    result, check_rows = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    banned = hb.banned_modules()
    if banned:
        fail(f"the process holds {banned} after the window", 3)
    emit(result, check_rows)


def run_cell(bench, cell, seed: int, seconds: float, trace: bool, device,
             age=process_age_s, cfg=None, traffic=None, limits=None):
    """One run of ``cell``: (the result's object without ``checks``, the
    check's rows).  ``cfg``, ``traffic`` and ``limits`` stand in for the
    cell's files where given."""
    import torch

    from perfbench import harness as hb
    from perfbench import trace as tr

    cuda = torch.device(device).type == "cuda"
    cfg = cfg or hb.config(cell["config"])
    traffic = traffic or hb.traffic(cell["traffic"])
    limits = limits or hb.checks(cell["name"])
    dep = hb.Deployment(cfg, traffic, seed, device)
    note(f"weights drawn, cluster built: {sum(w.nbytes for w in dep.weights.values())} bytes")
    hb.warm_up(dep, seed)  # builds and loads the kernels the served path launches
    note(f"warmed up: {dep.cluster.engine.captures} graphs captured")
    timers = {} if trace else None
    if trace:
        hb.instrument(dep, timers)
    gen = hb.Traffic(traffic, cfg, seed)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dep.cluster.engine.reset_counts()
    setup_s = age()
    note(f"window opens at {time.time():.3f} s since the epoch")
    requests, window_s = hb.window(dep, gen, seconds, timers)
    note(f"window: {len(requests)} requests in {window_s:.3f} s; median s by kind "
         f"{hb.latency_by_kind(requests)}; each in order "
         f"{[round(r.latency_s, 4) for r in requests]}")
    run = hb.Run(dep.sizes, requests, window_s, setup_s,
                 replays=dep.cluster.engine.replays, timers=dict(timers) if trace else None)
    device_row = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1}
    breakdown = None
    if trace and cuda:
        deck: list = []

        def one_deck():  # a profile taken again serves a deck of its own
            deck.clear()
            hb.serve_deck(dep, gen, deck, spans=True, kinds=gen.traced_deck())

        records, spans, wall, lost = tr.profiled(one_deck)
        note(f"profiled deck: {len(deck)} requests, {len(records)} device records, "
             f"{lost} ballast records lost")
        run.trace = hb.Trace(records, spans, wall, tr.busy_s(records, spans),
                             tr.busy_within(records, spans, tr.SPAN + "run_task"),
                             [t for r in deck if r.ok for t in r.tasks])
        device_row.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = {"device_ops": tr.device_ops(records),
                     "idle_gaps": tr.idle_gaps(records, spans)}
        requests = requests + deck
    if cuda:
        device_row["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    dep.cluster.engine.close()
    if cuda:
        torch.cuda.empty_cache()
    if run.trace is not None:
        hb.routed_experts(dep, run.trace.tasks)
        note("routing read")
    kind = "per_layer" if trace else "end_to_end"
    metrics = hb.read_metrics(run, hb.metrics_for(cell["name"], kind, bench))
    rows = hb.check(dep, requests, limits, seed)
    failures = [r for r in requests if not r.ok]
    if failures:
        note(f"{len(failures)} requests failed; the first:\n{failures[0].error}")
    note("checked")
    result = {"correct": hb.passed(rows), "attempted": len(requests),
              "failed": sum(not r.ok for r in requests), "metrics": metrics,
              "device": device_row}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, rows


def emit(result, rows) -> None:
    """The check's numbers on standard error, then the result's line."""
    for name, row in rows.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(dict(result, checks=rows)), flush=True)


if __name__ == "__main__":
    main()
