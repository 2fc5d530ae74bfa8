#!/usr/bin/env python3
"""One traced run of a benchmark cell with the serving path's profiler
ranges on or off, and what they say about the card's idle time.

    python3 tools/serving_spans.py --workload trio.chat --seed 7 --seconds 51 \\
        --spans 1 --out chiprun_out/spans

Runs ``perfbench/run.py``'s ``run_cell`` with ``--trace 1`` as the
benchmark does, but builds the cell's ``ServingCluster`` with
``spans=True`` (or ``False``), keeps the profile of the traced deck, and
the engine's task times over the window.  Prints one JSON line: the run's
end-to-end and per-layer metrics, ``correct``, the traced deck's wall
seconds and the profile's record counts, and with spans on the readings
of ``perfbench/program_trace.py`` (the replays' gaps and bubbles, the
share of the window the card waited for the host, the idle by cause,
the device time a step over the window and its slow share) with the
checks of the attribution and the card's clock against the host's;
``--out`` also gets every task time.  ``--early 1`` also profiles one
deck between the warm-up and the window, where most runs are slow, and
reads it the same way (that deck shifts the window's decks in the seed's
draw).  Needs a CUDA card.

Temporary: a second traced path beside ``perfbench/run.py``, which it
patches (``ServingCluster``, ``trace.profiled``, ``harness.read_metrics``,
``harness.window``) so as to read ``run_cell``'s profile again.  Delete it
once ``harness.Deployment`` takes ``spans`` and the readings of
``perfbench/program_trace.py`` are per-layer metrics of the benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: Seconds of the window a bin of the slow stretches' time course covers.
BIN_S = 5.0


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unread"


@contextlib.contextmanager
def kept_profiles():
    """Inside, every ``torch.profiler.profile`` made is kept in the list
    yielded, so that the profile ``trace.profiled`` takes can be read
    again."""
    import torch.profiler

    made = []
    base = torch.profiler.profile

    class Kept(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    torch.profiler.profile = Kept
    try:
        yield made
    finally:
        torch.profiler.profile = base


def course(times, flags):
    """The window's task times in bins of ``BIN_S`` seconds from the first
    task's start: [bin start s, tasks, device s, slow device s]."""
    if not times:
        return []
    t0 = times[0].host_s - times[0].device_s
    bins = {}
    for t, s in zip(times, flags):
        row = bins.setdefault(int((t.host_s - t0) // BIN_S), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += t.device_s
        row[2] += t.device_s if s else 0.0
    return [[k * BIN_S] + v for k, v in sorted(bins.items())]


def readings(pt, prog, times, refs):
    """What a profiled deck's program ranges say, and its tasks' device
    time a replay over their key's reference in the window (``refs``)."""
    at = pt.attribute(prog)
    parts = pt.idle_by_cause(at, top=None)
    lo, hi = prog.window
    idle_s = (hi - lo - at.busy(lo, hi)) / 1e9
    anchors = at.anchors
    drift = [1e6 * (e1 - e0) / (t1 - t0) for (t0, e0), (t1, e1) in zip(anchors, anchors[1:])
             if t1 > t0]
    over = [t.device_s / t.replays / refs[t.key] for t in times if t.key in refs]
    return {
        "device_idle_share": 100.0 * idle_s / ((hi - lo) / 1e9),
        "replay_gap_us": pt.replay_gap_us(at),
        "in_replay_idle_share": pt.in_replay_idle_share(at),
        "host_late_share": pt.host_late_share(at),
        "idle_by_cause": parts[:10],
        "idle_by_cause_s": sum(v for _, v in parts), "idle_s": idle_s,
        "coverage": pt.coverage(at),
        "clock": {
            "anchors": len(anchors), "first_offset_ns": anchors[0][1],
            "last_offset_ns": anchors[-1][1], "between_s": (anchors[-1][0] - anchors[0][0]) / 1e9,
            "least_offset_ns": min(e for _, e in anchors),
            "most_offset_ns": max(e for _, e in anchors),
            "drift_ppm_median": statistics.median(drift) if drift else None,
            "host_late_share_unaligned": pt.host_late_share(dataclasses.replace(at, anchors=[])),
        },
        "tasks_over_ref_median": statistics.median(over) if over else None,
        "tasks_slow": sum(r > pt.SLOW for r in over),
        "tasks": len(over),
    }, anchors


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--early", type=int, choices=(0, 1), default=0,
                    help="also profile one deck between the warm-up and the window")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    from perfbench import run as pr  # sets the checkout's build and cache paths

    import torch

    import repro_torch.serving as serving
    from perfbench import harness as hb
    from perfbench import program_trace as pt
    from perfbench import trace as tr

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.cuda.set_device(0)
    clusters, kept, runs = [], {}, []
    real_cluster, real_profiled, real_read = serving.ServingCluster, tr.profiled, hb.read_metrics
    real_window = hb.window

    def cluster(*a, **kw):
        clusters.append(real_cluster(*a, spans=bool(args.spans), **kw))
        return clusters[-1]

    def profiled(fn):
        kept["window_times"] = list(clusters[0].engine.task_times)
        with kept_profiles() as made:
            out = real_profiled(fn)
        kept["program"] = pt.read(made[-1].profiler.kineto_results.events())
        return out

    def read_metrics(run, entries):
        runs.append(run)
        return real_read(run, entries)

    def window(dep, gen, seconds, timers=None):
        if args.early:  # in the slow stretch, if the run has one
            deck = []
            with kept_profiles() as made:
                real_profiled(lambda: (deck.clear(), hb.serve_deck(
                    dep, gen, deck, spans=True, kinds=gen.traced_deck())))
            kept["early"] = (pt.read(made[-1].profiler.kineto_results.events()),
                             list(dep.cluster.engine.task_times))
            dep.cluster.engine.reset_counts()
            for k in timers or {}:
                timers[k] = 0.0
        return real_window(dep, gen, seconds, timers)

    serving.ServingCluster, tr.profiled, hb.read_metrics = cluster, profiled, read_metrics
    hb.window = window
    bench = hb.spec()
    cell = hb.workload(args.workload, bench)
    result, rows = pr.run_cell(bench, cell, args.seed, args.seconds, True, "cuda")
    run = runs[0]
    e2e = real_read(run, hb.metrics_for(args.workload, "end_to_end", bench))
    out = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
           "early": args.early, "card": power_limit(), "correct": result["correct"],
           "failed": result["failed"],
           "end_to_end": {k: v["value"] for k, v in e2e.items()},
           "per_layer": {k: v["value"] for k, v in result["metrics"].items()},
           "idle_gaps": result["breakdown"]["idle_gaps"]}
    prog = kept["program"]
    deck_s, busy_s = result["device"]["window_s"], result["device"]["busy_s"]
    out["deck"] = {"wall_s": deck_s, "busy_s": busy_s, "events": prog.events,
                   "device_records": len(run.trace.device),
                   "program_records": len(prog.records), "annotations": prog.annotations,
                   "program_ranges": len(prog.spans), "event_records": prog.event_records,
                   "replays": run.replays}
    times = kept["window_times"]
    if args.spans:
        flags = pt.slow(times)
        refs = pt.references(times)
        deck_times = clusters[0].engine.task_times[len(times):]
        late, anchors = readings(pt, prog, deck_times, refs)
        out["program"] = dict(
            late,
            step_device_ms=pt.step_device_ms(times),
            slow_step_share=pt.slow_step_share(times),
            idle_times_window_s=deck_s - busy_s,
            window_tasks=len(times),
            keys={str(k): {"tasks": sum(t.key == k for t in times), "ref_ms": 1e3 * r,
                           "median_over_ref": statistics.median(
                               t.device_s / t.replays / r for t in times if t.key == k)}
                  for k, r in refs.items()},
            course=course(times, flags))
        out["clock_anchors"] = anchors
        if args.early:
            out["early_deck"], _ = readings(pt, kept["early"][0], kept["early"][1], refs)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        name = f"{args.workload}.{args.seed}.spans{args.spans}.json"
        (args.out / name).write_text(json.dumps(dict(out, task_times=[
            [list(t.key), t.replays, t.device_s, t.host_s] for t in times])))
    out.pop("clock_anchors", None)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
