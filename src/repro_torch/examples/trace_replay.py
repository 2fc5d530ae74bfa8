"""Replay a bursty production-style trace through every scheduler
(the §6.4 experiment) and render completion-time timelines as ASCII.

    PYTHONPATH=src python -m repro_torch.examples.trace_replay

A copy of the JAX package's ``examples/trace_replay.py`` on the port; it prints
the same table.
"""

from repro_torch.core import ClusterSpec, ProfileRepository
from repro_torch.sim import (
    Simulation,
    arrival_rate_timeline,
    bursty_trace_workload,
)
from repro_torch.workflows import MODELS, paper_dfgs


def sparkline(values, width=72):
    if not values:
        return ""
    blocks = " ▁▂▃▄▅▆▇█"
    step = max(1, len(values) // width)
    vals = [max(values[i:i + step]) for i in range(0, len(values), step)]
    hi = max(vals) or 1.0
    return "".join(blocks[min(8, int(v / hi * 8))] for v in vals)


def main() -> None:
    cluster = ClusterSpec(n_workers=5)
    dfgs = paper_dfgs()
    jobs = bursty_trace_workload(dfgs, base_rate_per_s=0.8,
                                 duration_s=600.0, seed=3)
    rates = [r for _, r in arrival_rate_timeline(jobs, bin_s=10.0)]
    print(f"trace: {len(jobs)} requests over 600 s")
    print(f"arrival rate   {sparkline(rates)}")

    for name in ["navigator", "jit", "heft", "hash"]:
        profiles = ProfileRepository(cluster, MODELS)
        for d in dfgs:
            profiles.register(d)
        res = Simulation(cluster, profiles, MODELS, scheduler=name,
                         seed=1).run(jobs)
        lats = [0.0] * 61
        for r in res.records:
            lats[int(r.arrival // 10)] = max(
                lats[int(r.arrival // 10)], r.latency
            )
        print(f"{name:>10} lat {sparkline(lats)}  "
              f"p95={res.percentile_latency(0.95):6.2f}s "
              f"mean={res.mean_latency:5.2f}s")

    print("\nHash is least burst-tolerant; Navigator absorbs the spikes")
    print("by expanding the worker set only when it pays off (§6.4).")


if __name__ == "__main__":
    main()
