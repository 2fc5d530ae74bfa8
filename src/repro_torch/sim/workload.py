"""Workload generators for the experiments (§6), copied from the JAX
package so that the port stands alone.

* Poisson arrivals with a mixture over the four Figure-1 DFGs (the paper's
  low-load 0.5 req/s and high-load 2 req/s settings, and the scalability
  study's 40 req/s).
* A bursty "production trace" generator statistically matched to the
  Alibaba-trace replay of §6.4 (the offline container has no network; see
  DESIGN.md §7): baseline Poisson arrivals modulated by lognormal bursts
  arriving as a Poisson process, rescaled to cluster capacity.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.netmodel import ClusterSpec
from repro_torch.core.types import DFG, Job


def _mixture_picker(
    rng: random.Random, dfgs: Sequence[DFG], weights: Optional[Sequence[float]]
):
    if weights is None:
        weights = [1.0] * len(dfgs)
    total = sum(weights)
    cum = []
    acc = 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)

    def pick() -> DFG:
        u = rng.random()
        for dfg, c in zip(dfgs, cum):
            if u <= c:
                return dfg
        return dfgs[-1]

    return pick


def poisson_workload(
    dfgs: Sequence[DFG],
    rate_per_s: float,
    duration_s: float,
    seed: int = 0,
    weights: Optional[Sequence[float]] = None,
) -> List[Job]:
    """Poisson arrivals at ``rate_per_s`` with DFG types drawn from the
    mixture ("Poison distribution on request types", §6.2.2)."""
    rng = random.Random(seed)
    pick = _mixture_picker(rng, dfgs, weights)
    jobs: List[Job] = []
    t = 0.0
    jid = 0
    while True:
        t += rng.expovariate(rate_per_s)
        if t >= duration_s:
            break
        jobs.append(Job(job_id=jid, dfg=pick(), arrival_time=t))
        jid += 1
    return jobs


def bursty_trace_workload(
    dfgs: Sequence[DFG],
    base_rate_per_s: float,
    duration_s: float,
    seed: int = 0,
    burst_rate_per_s: float = 0.02,
    burst_size_mu: float = 2.3,
    burst_size_sigma: float = 0.7,
    burst_span_s: float = 4.0,
    weights: Optional[Sequence[float]] = None,
) -> List[Job]:
    """Bursty arrivals: a low Poisson baseline plus burst events whose
    sizes are lognormal (heavy-tailed, as in production GPU-cluster traces)
    and whose members arrive within a short span.  Matches the qualitative
    §6.4 pattern: long quiet stretches punctuated by sharp spikes."""
    rng = random.Random(seed)
    pick = _mixture_picker(rng, dfgs, weights)
    arrivals: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(base_rate_per_s)
        if t >= duration_s:
            break
        arrivals.append(t)
    t = 0.0
    while True:
        t += rng.expovariate(burst_rate_per_s)
        if t >= duration_s:
            break
        size = max(1, int(rng.lognormvariate(burst_size_mu, burst_size_sigma)))
        for _ in range(size):
            arrivals.append(t + rng.random() * burst_span_s)
    arrivals.sort()
    return [
        Job(job_id=i, dfg=pick(), arrival_time=a)
        for i, a in enumerate(arrivals)
        if a < duration_s
    ]


def fleet_scaled_rate(
    cluster: ClusterSpec,
    base_rate_per_s: float,
    reference_speed: float = 1.0,
) -> float:
    """Scale an arrival rate by aggregate fleet throughput so a sweep over
    heterogeneous fleets holds *offered load* (arrival rate ÷ service
    capacity) constant.  ``base_rate_per_s`` is the rate calibrated for a
    fleet of ``n_workers`` × ``reference_speed`` workers (the paper's
    uniform-T4 testbed)."""
    reference_capacity = reference_speed * cluster.n_workers
    if reference_capacity <= 0:
        return base_rate_per_s
    return base_rate_per_s * cluster.total_speed / reference_capacity


def fleet_workload(
    dfgs: Sequence[DFG],
    cluster: ClusterSpec,
    base_rate_per_s: float,
    duration_s: float,
    seed: int = 0,
    weights: Optional[Sequence[float]] = None,
) -> List[Job]:
    """Poisson workload whose rate is scaled to the fleet's aggregate
    throughput (see ``fleet_scaled_rate``) — the generator the
    heterogeneity sweeps use so "high load" means the same utilisation on
    every fleet."""
    return poisson_workload(
        dfgs,
        fleet_scaled_rate(cluster, base_rate_per_s),
        duration_s,
        seed=seed,
        weights=weights,
    )


def arrival_rate_timeline(
    jobs: Sequence[Job], bin_s: float = 10.0
) -> List[Tuple[float, float]]:
    """(bin_start, req/s) series — Fig. 9a style."""
    if not jobs:
        return []
    end = max(j.arrival_time for j in jobs)
    nbins = int(end / bin_s) + 1
    counts = [0] * nbins
    for j in jobs:
        counts[int(j.arrival_time / bin_s)] += 1
    return [(i * bin_s, c / bin_s) for i, c in enumerate(counts)]
