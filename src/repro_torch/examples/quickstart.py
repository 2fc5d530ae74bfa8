"""Quickstart: Navigator in 60 seconds.

Builds the paper's four ML workflows (Fig. 1), runs the decentralized
scheduler against the JIT/HEFT/Hash baselines on a simulated 5-worker
edge cluster at the paper's high-load setting, and prints the §6.2
comparison (slowdown factor, cache hit rate, GPU utilization).

    PYTHONPATH=src python -m repro_torch.examples.quickstart

A copy of the JAX package's ``examples/quickstart.py`` on the port; it prints
the same table.
"""

from repro_torch.core import ClusterSpec, ProfileRepository
from repro_torch.sim import Simulation, poisson_workload
from repro_torch.workflows import MODELS, paper_dfgs


def main() -> None:
    cluster = ClusterSpec(n_workers=5)  # 5× 16 GB-GPU workers (§6)
    dfgs = paper_dfgs()

    print(f"{'scheduler':>10} | {'mean lat':>8} | {'slowdown':>8} | "
          f"{'hit rate':>8} | {'GPU util':>8}")
    print("-" * 56)
    for name in ["navigator", "jit", "heft", "hash"]:
        profiles = ProfileRepository(cluster, MODELS)
        for d in dfgs:
            profiles.register(d)
        jobs = poisson_workload(dfgs, rate_per_s=2.0, duration_s=300.0, seed=7)
        res = Simulation(
            cluster, profiles, MODELS, scheduler=name, seed=1
        ).run(jobs)
        print(
            f"{name:>10} | {res.mean_latency:7.2f}s | "
            f"{res.mean_slowdown:8.2f} | {res.cache_hit_rate*100:7.1f}% | "
            f"{res.gpu_utilization*100:7.1f}%"
        )

    print("\nNavigator schedules where the models already are; the cache")
    print("hit-rate column is the paper's Table-1 story in one number.")


if __name__ == "__main__":
    main()
