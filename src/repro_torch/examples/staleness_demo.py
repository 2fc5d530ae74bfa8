"""Decentralized scheduling under metadata staleness, in 60 seconds.

Runs Navigator on the decentralized SST gossip plane — every worker plans
from its own, possibly stale, replica of the cluster state — and sweeps
the gossip period from near-fresh (50 ms) to very stale (4 s), on the
uniform paper fleet and on a heterogeneous mixed fleet (A10/L4/T4/edge).
Watch the P50/P99 job completion times degrade *gracefully* as views get
staler while the message volume collapses.

    PYTHONPATH=src python -m repro_torch.examples.staleness_demo

A copy of the JAX package's ``examples/staleness_demo.py`` on the port; it prints
the same table.
"""

from repro_torch.core import ClusterSpec, GossipConfig, ProfileRepository, fleet
from repro_torch.sim import Simulation, fleet_scaled_rate, fleet_workload
from repro_torch.workflows import MODELS, paper_dfgs


def run(cluster, period_s, base_rate):
    dfgs = paper_dfgs()
    profiles = ProfileRepository(cluster, MODELS)
    for d in dfgs:
        profiles.register(d)
    jobs = fleet_workload(dfgs, cluster, base_rate, duration_s=150.0, seed=7)
    sim = Simulation(
        cluster, profiles, MODELS, scheduler="navigator",
        gossip=GossipConfig(period_s=period_s, fanout=2), seed=1,
    )
    return sim.run(jobs)


def main() -> None:
    for fleet_name in ("uniform", "mixed"):
        cluster = fleet(fleet_name)
        print(f"\n{fleet_name} fleet ({cluster.n_workers} workers, "
              f"aggregate speed {cluster.total_speed:.1f}x, "
              f"{fleet_scaled_rate(cluster, 2.0):.2f} req/s):")
        print(f"{'gossip period':>14} | {'P50 JCT':>8} | {'P99 JCT':>8} | "
              f"{'slowdown':>8} | {'messages':>8}")
        print("-" * 62)
        for period in (0.05, 0.2, 1.0, 4.0):
            res = run(cluster, period, 2.0)
            print(f"{period:13.2f}s | {res.percentile_latency(0.5):7.2f}s | "
                  f"{res.percentile_latency(0.99):7.2f}s | "
                  f"{res.mean_slowdown:8.2f} | {res.sst_pushes:8d}")

    print("\nEach worker planned from its own gossip replica; a 80x staler")
    print("view costs well under 2x latency — the decentralized plane")
    print("degrades gracefully instead of cliffing.")


if __name__ == "__main__":
    main()
