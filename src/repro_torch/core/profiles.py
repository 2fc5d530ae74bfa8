"""Repository of Workflow Profiles (§3.1) and vertex ranking (§4.2.1),
plus heterogeneous worker-fleet profiles.

Holds static DFG metadata: expected runtimes R(t), input/output object
sizes, model sizes — plus the statically computed upward ranks (Eq. 1):

    rank(t) = R(t) + max_{t ≺ t'} (TD_output(t) + rank(t'))

Ranks depend only on the DFG and the cluster's network model, so Navigator
computes them once when the DFG is loaded and caches them here (§4.2.1);
dynamic inputs merely update, not recompute, the static values.

Fleet profiles: the paper's testbed is 5 identical T4 workers, but edge
clusters are rarely uniform.  ``WorkerProfile`` describes one GPU class
(FLOPS multiplier + memory) and ``build_fleet`` assembles a
``ClusterSpec`` from a mix; ``FLEETS`` names the presets the staleness /
heterogeneity sweeps use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.netmodel import ClusterSpec, LinkSpec, Topology
from repro_torch.core.types import DFG, GB, MLModel, TaskSpec


# --------------------------------------------------------------------------
# Heterogeneous fleet profiles
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkerProfile:
    """One GPU class: ``speed`` multiplies task throughput
    (R(t, w) = R(t) / speed), ``gpu_capacity_bytes`` bounds the Navigator
    cache."""

    name: str
    speed: float = 1.0
    gpu_capacity_bytes: float = 16.0 * GB


# The paper's T4 is the 1.0x reference; the others are plausible edge/DC
# neighbours (relative serving throughput, not peak-FLOPS marketing).
T4 = WorkerProfile("t4", 1.0, 16.0 * GB)
L4 = WorkerProfile("l4", 1.6, 24.0 * GB)
A10 = WorkerProfile("a10", 2.0, 24.0 * GB)
EDGE = WorkerProfile("edge", 0.5, 8.0 * GB)

#: Named fleet mixes for the heterogeneity sweeps (bench_staleness.py).
FLEETS: Dict[str, Tuple[WorkerProfile, ...]] = {
    "uniform": (T4, T4, T4, T4, T4),
    "mixed": (A10, L4, T4, T4, EDGE),
    "edge_heavy": (L4, EDGE, EDGE, EDGE, EDGE),
}


def rack_topology(
    rack_sizes: Sequence[int],
    oversubscription: float = 4.0,
    rack_link: LinkSpec = LinkSpec(100e9 / 8.0, 1e-3),
    uplink_delta_s: float = 1e-3,
) -> Topology:
    """Two-tier topology over ``rack_sizes`` racks: rack-local links at
    ``rack_link`` capacity, each rack's shared spine uplink oversubscribed
    by ``oversubscription`` (uplink bw = rack bw / factor)."""
    if oversubscription <= 0:
        raise ValueError("oversubscription must be positive")
    rack_of: List[int] = []
    for rack, size in enumerate(rack_sizes):
        rack_of.extend([rack] * size)
    return Topology(
        rack_of=tuple(rack_of),
        rack_link=rack_link,
        uplink=LinkSpec(
            rack_link.bandwidth_bytes_per_s / oversubscription,
            uplink_delta_s,
        ),
    )


#: Rack-aware fleet presets: (worker profiles, topology).  ``rack2`` is
#: the paper's T4 class spread across two racks of four behind 4×
#: oversubscribed uplinks; ``rack2_mixed`` skews the fast GPUs into rack
#: 0 so rack-local placement and heterogeneity pull in different
#: directions.
RACK_FLEETS: Dict[str, Tuple[Tuple[WorkerProfile, ...], Topology]] = {
    "rack2": (
        (T4,) * 8,
        rack_topology((4, 4), oversubscription=4.0),
    ),
    "rack2_mixed": (
        (A10, A10, L4, T4, T4, T4, EDGE, EDGE),
        rack_topology((4, 4), oversubscription=4.0),
    ),
}


def build_fleet(
    profiles: Sequence[WorkerProfile], **cluster_kwargs
) -> ClusterSpec:
    """Assemble a ``ClusterSpec`` from a worker-profile mix.  Extra
    keyword arguments (network, link, …) pass through to the spec."""
    if not profiles:
        raise ValueError("fleet needs at least one worker profile")
    return ClusterSpec(
        n_workers=len(profiles),
        gpu_capacity_bytes=max(p.gpu_capacity_bytes for p in profiles),
        worker_speed={w: p.speed for w, p in enumerate(profiles)},
        worker_gpu_capacity={
            w: p.gpu_capacity_bytes for w, p in enumerate(profiles)
        },
        **cluster_kwargs,
    )


def fleet(name: str, **cluster_kwargs) -> ClusterSpec:
    """Named preset → ``ClusterSpec`` (see ``FLEETS`` / ``RACK_FLEETS``)."""
    if name in RACK_FLEETS:
        profiles, topo = RACK_FLEETS[name]
        cluster_kwargs.setdefault("topology", topo)
        return build_fleet(profiles, **cluster_kwargs)
    try:
        return build_fleet(FLEETS[name], **cluster_kwargs)
    except KeyError:
        raise ValueError(
            f"unknown fleet {name!r}; have "
            f"{sorted(FLEETS) + sorted(RACK_FLEETS)}"
        ) from None


class ProfileRepository:
    def __init__(self, cluster: ClusterSpec, models: Mapping[int, MLModel]) -> None:
        self.cluster = cluster
        self.models: Dict[int, MLModel] = dict(models)
        self._dfgs: Dict[str, DFG] = {}
        self._ranks: Dict[str, Dict[str, float]] = {}
        self._mean_factors: Optional[Tuple[float, float]] = None
        # Per-worker vector caches for the batched planners.  All derive
        # from the frozen ClusterSpec, so they never invalidate.
        n = cluster.n_workers
        self._speed_vec = np.array([cluster.speed(w) for w in range(n)])
        self._gpu_cap_vec = np.array([cluster.gpu_capacity(w) for w in range(n)])
        self._fits_vec: Dict[Optional[int], np.ndarray] = {}
        self._path_src_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    # -- registration ---------------------------------------------------------
    def register(self, dfg: DFG) -> None:
        for t in dfg.tasks.values():
            if t.model_id is not None and t.model_id not in self.models:
                raise KeyError(
                    f"DFG {dfg.name!r} task {t.task_id!r} references "
                    f"unknown model {t.model_id}"
                )
        self._dfgs[dfg.name] = dfg
        self._ranks[dfg.name] = self._compute_ranks(dfg)

    def dfg(self, name: str) -> DFG:
        return self._dfgs[name]

    def dfgs(self) -> List[DFG]:
        return list(self._dfgs.values())

    # -- parameters (§4.1) -----------------------------------------------------
    def runtime(self, task: TaskSpec, worker: int) -> float:
        """R(t, w)."""
        return self.cluster.runtime_on(task.runtime_s, worker)

    def mean_runtime(self, task: TaskSpec) -> float:
        """R(t): average of R(t, w) over the worker set (§4.2.1)."""
        speeds = [self.cluster.speed(w) for w in self.cluster.workers()]
        return task.runtime_s * sum(1.0 / s for s in speeds) / len(speeds)

    def _mean_transfer(self, nbytes: float) -> float:
        """Representative (placement-free) transfer time: the flat table
        when no topology is configured, the mean over distinct worker
        pairs otherwise — used by static ranks, which price transfers
        before placement is known."""
        topo = self.cluster.topology
        if topo is None:
            return self.cluster.network.transfer_time(nbytes)
        if nbytes <= 0:
            return 0.0
        if self._mean_factors is None:
            self._mean_factors = topo.mean_path_factors()
        inv_bw, delta = self._mean_factors
        return nbytes * inv_bw + delta

    def td_output(self, task: TaskSpec) -> float:
        """TD_output(t): time to move the task's output between workers
        (representative cost; see ``td_output_to`` for a concrete path)."""
        return self._mean_transfer(task.output_bytes)

    def td_input(self, task: TaskSpec) -> float:
        """TD_input(t): time to move the task's (external) input."""
        return self._mean_transfer(task.input_bytes)

    def td_output_to(self, task: TaskSpec, src: int, dst: int) -> float:
        """TD_output(t) along the concrete ``src → dst`` path."""
        return self.cluster.path_transfer_time(task.output_bytes, src, dst)

    def td_input_to(self, task: TaskSpec, src: int, dst: int) -> float:
        """TD_input(t) along the concrete ``src → dst`` path."""
        return self.cluster.path_transfer_time(task.input_bytes, src, dst)

    def td_model(self, model_id: Optional[int]) -> float:
        """TD_model(m, w) for a cache miss (uniform link assumed unless the
        cluster defines per-worker links)."""
        if model_id is None:
            return 0.0
        return self.cluster.link.fetch_time(self.models[model_id].size_bytes)

    def model_size(self, model_id: Optional[int]) -> float:
        if model_id is None:
            return 0.0
        return self.models[model_id].size_bytes

    def cached_model_size(self, model_id: Optional[int]) -> float:
        """Compressed in-cache footprint (§3.3)."""
        if model_id is None:
            return 0.0
        return self.models[model_id].size_bytes * self.cluster.compression_ratio

    def model_fits(self, model_id: Optional[int], worker: int) -> bool:
        """Static feasibility: the worker's GPU must hold one compressed
        cache copy plus one decompressed execution instance (§3.3).
        Heterogeneous fleets can contain workers too small for the
        largest models; capacity-aware schedulers price them out."""
        if model_id is None:
            return True
        footprint = self.models[model_id].size_bytes * (
            1.0 + self.cluster.compression_ratio
        )
        return footprint <= self.cluster.gpu_capacity(worker)

    # -- per-worker vectors (batched planners / indexed engine) ---------------
    # Each vector replays the scalar expression elementwise in float64, so
    # every element is bit-identical to the corresponding scalar call — the
    # contract the differential parity suite (chaos family 7) rests on.

    def runtime_vec(self, task: TaskSpec) -> np.ndarray:
        """R(t, ·) over the fleet — elementwise ``runtime(task, w)``.
        Returns a fresh array."""
        return task.runtime_s / self._speed_vec

    def model_fits_vec(self, model_id: Optional[int]) -> np.ndarray:
        """``model_fits(model_id, ·)`` as a cached bool vector.  Callers
        must treat the returned array as read-only."""
        out = self._fits_vec.get(model_id)
        if out is None:
            if model_id is None:
                out = np.ones(self.cluster.n_workers, dtype=bool)
            else:
                footprint = self.models[model_id].size_bytes * (
                    1.0 + self.cluster.compression_ratio
                )
                out = footprint <= self._gpu_cap_vec
            self._fits_vec[model_id] = out
        return out

    def _path_factors(self, src: int) -> Tuple[np.ndarray, np.ndarray]:
        """(bottleneck bandwidth, crosses-uplink) vectors for ``src → ·``
        paths of the configured topology (cached per source)."""
        cached = self._path_src_cache.get(src)
        if cached is None:
            topo = self.cluster.topology
            racks = np.asarray(topo.rack_of)
            cross = racks != racks[src]
            rack_bw = topo.rack_link.bandwidth_bytes_per_s
            # Uncontended planner price: both crossed uplinks at share 1.0,
            # so the bottleneck is min(rack link, uplink) — same fold as
            # Topology.transfer_time with default shares.
            bw = np.where(
                cross,
                min(rack_bw, topo.uplink.bandwidth_bytes_per_s),
                rack_bw,
            )
            cached = (bw, cross)
            self._path_src_cache[src] = cached
        return cached

    def path_time_vec(self, nbytes: float, src: int) -> np.ndarray:
        """``cluster.path_transfer_time(nbytes, src, ·)`` over all
        destinations as a fresh array.  Mirrors the scalar exactly,
        including the flat model charging ``src == dst`` (callers zero
        the diagonal wherever the scalar code path skips self-transfers)
        and the topology model's zero diagonal."""
        n = self.cluster.n_workers
        topo = self.cluster.topology
        if topo is None:
            return np.full(n, self.cluster.network.transfer_time(nbytes))
        if nbytes <= 0:
            return np.zeros(n)
        bw, cross = self._path_factors(src)
        t = nbytes / bw
        t = t + topo.rack_link.delta_s
        t = np.where(cross, t + topo.uplink.delta_s, t)
        t[src] = 0.0
        return t

    def td_input_vec(self, task: TaskSpec, src: int) -> np.ndarray:
        """``td_input_to(task, src, ·)`` over all destinations."""
        return self.path_time_vec(task.input_bytes, src)

    def td_output_vec(self, task: TaskSpec, src: int) -> np.ndarray:
        """``td_output_to(task, src, ·)`` over all destinations."""
        return self.path_time_vec(task.output_bytes, src)

    # -- ranking (Eq. 1) ---------------------------------------------------------
    def _compute_ranks(self, dfg: DFG) -> Dict[str, float]:
        ranks: Dict[str, float] = {}
        for tid in reversed(dfg.topo_order):
            task = dfg.tasks[tid]
            succ_term = 0.0
            if dfg.succs[tid]:
                succ_term = max(
                    self.td_output(task) + ranks[s] for s in dfg.succs[tid]
                )
            ranks[tid] = self.mean_runtime(task) + succ_term
        return ranks

    def ranks(self, dfg: DFG) -> Dict[str, float]:
        if dfg.name not in self._ranks:
            self.register(dfg)
        return self._ranks[dfg.name]

    def rank_order(self, dfg: DFG) -> List[str]:
        """Tasks in descending rank; ties broken by topological position
        ("time of arrival determines the ranking" for identical ranks,
        §4.2.1 — topo position is the deterministic analogue within a job)."""
        ranks = self.ranks(dfg)
        topo_pos = {t: i for i, t in enumerate(dfg.topo_order)}
        return sorted(dfg.tasks, key=lambda t: (-ranks[t], topo_pos[t]))
