"""Transfer-time models (§4.1).

The paper estimates:
  TD_input(t)      = |input_t| / network transmission capacity + delta_network
  TD_model(m, w)   = |m| / PCIe transmission capacity_w + delta_PCIe(w)

Both are the "commonly accepted heuristic" linear size/bandwidth models.
The experimental cluster is RDMA/InfiniBand 100 Gbps with Tesla T4 GPUs
(16 GB, PCIe 3.0 x16); we keep those constants as defaults so the simulator
reproduces the paper.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import GB


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Worker↔worker object transfer cost model (flat all-pairs table)."""

    bandwidth_bytes_per_s: float = 100e9 / 8.0  # 100 Gbps RDMA
    delta_s: float = 1e-3  # constant latency term (delta_network)

    def transfer_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return nbytes / self.bandwidth_bytes_per_s + self.delta_s


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One physical link class: capacity plus a constant per-hop latency."""

    bandwidth_bytes_per_s: float
    delta_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-tier rack topology: workers sit on non-blocking rack-local
    links; each rack reaches the spine through one shared (and typically
    oversubscribed) uplink.

    Path model:

    * same worker          — zero cost.
    * same rack            — ``rack_link`` bandwidth + one hop latency
                             (the ToR is non-blocking, so rack-local
                             transfers never contend).
    * cross rack           — bottleneck of the rack link and *both* rack
                             uplinks, plus one rack hop and one spine
                             hop of latency.  Concurrent transfers that
                             share an uplink divide its capacity
                             (fair-share contention, see
                             :class:`NetworkState`).
    """

    rack_of: Tuple[int, ...]
    rack_link: LinkSpec = LinkSpec(100e9 / 8.0, 1e-3)
    uplink: LinkSpec = LinkSpec(100e9 / 8.0 / 4.0, 1e-3)

    def __post_init__(self) -> None:
        if not self.rack_of:
            raise ValueError("topology needs at least one worker")
        racks = set(self.rack_of)
        if racks != set(range(len(racks))):
            raise ValueError(
                f"rack ids must be contiguous from 0, got {sorted(racks)}"
            )

    @property
    def n_workers(self) -> int:
        return len(self.rack_of)

    @property
    def n_racks(self) -> int:
        return max(self.rack_of) + 1

    def rack(self, worker: int) -> int:
        return self.rack_of[worker]

    def path_uplinks(self, src: int, dst: int) -> Tuple[int, ...]:
        """Rack uplinks a ``src → dst`` transfer crosses (the contended
        resources); empty for worker- or rack-local paths."""
        rs, rd = self.rack_of[src], self.rack_of[dst]
        if rs == rd:
            return ()
        return (rs, rd)

    def transfer_time(
        self,
        nbytes: float,
        src: int,
        dst: int,
        uplink_shares: Optional[Tuple[float, ...]] = None,
    ) -> float:
        """Effective transfer time along the ``src → dst`` path.

        ``uplink_shares`` optionally scales each crossed uplink's
        capacity (fair-share fraction in ``(0, 1]``); omitted means the
        uncontended path cost the planners price with.
        """
        if nbytes <= 0 or src == dst:
            return 0.0
        rs, rd = self.rack_of[src], self.rack_of[dst]
        if rs == rd:
            return (
                nbytes / self.rack_link.bandwidth_bytes_per_s
                + self.rack_link.delta_s
            )
        bw = self.rack_link.bandwidth_bytes_per_s
        ups = (1.0, 1.0) if uplink_shares is None else uplink_shares
        for share in ups:
            bw = min(bw, self.uplink.bandwidth_bytes_per_s * share)
        return nbytes / bw + self.rack_link.delta_s + self.uplink.delta_s

    def pair_matrices(self) -> Tuple[List[List[float]], List[List[float]]]:
        """(inverse-bandwidth, latency) matrices over worker pairs for the
        vectorized planner: ``time(src→dst) = nbytes * inv_bw[src][dst]
        + delta[src][dst]`` (uncontended; diagonal is zero).

        Pure function of the (frozen) topology, so the O(W²) build is
        memoized on the instance — planners used to rebuild it on every
        plan call.  Callers must treat the returned matrices as
        read-only."""
        cached = getattr(self, "_pair_matrices_cache", None)
        if cached is not None:
            return cached
        n = self.n_workers
        inv_bw = [[0.0] * n for _ in range(n)]
        delta = [[0.0] * n for _ in range(n)]
        for s in range(n):
            for d in range(n):
                if s == d:
                    continue
                if self.rack_of[s] == self.rack_of[d]:
                    inv_bw[s][d] = 1.0 / self.rack_link.bandwidth_bytes_per_s
                    delta[s][d] = self.rack_link.delta_s
                else:
                    bw = min(
                        self.rack_link.bandwidth_bytes_per_s,
                        self.uplink.bandwidth_bytes_per_s,
                    )
                    inv_bw[s][d] = 1.0 / bw
                    delta[s][d] = self.rack_link.delta_s + self.uplink.delta_s
        # Frozen dataclass: stash the memo via object.__setattr__.
        object.__setattr__(self, "_pair_matrices_cache", (inv_bw, delta))
        return inv_bw, delta

    def mean_path_factors(self) -> Tuple[float, float]:
        """Mean (inverse bandwidth, latency) over distinct worker pairs —
        the topology analogue of the flat table for static ranks (Eq. 1),
        which price a representative transfer before placement is known.
        Memoized alongside :meth:`pair_matrices`."""
        cached = getattr(self, "_mean_factors_cache", None)
        if cached is not None:
            return cached
        inv_bw, delta = self.pair_matrices()
        n = self.n_workers
        if n < 2:
            return 1.0 / self.rack_link.bandwidth_bytes_per_s, \
                self.rack_link.delta_s
        pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
        out = (
            sum(inv_bw[s][d] for s, d in pairs) / len(pairs),
            sum(delta[s][d] for s, d in pairs) / len(pairs),
        )
        object.__setattr__(self, "_mean_factors_cache", out)
        return out


class NetworkState:
    """Mutable fair-share contention tracker over a :class:`Topology`.

    Each rack uplink carries a lazily-expired heap of in-flight transfer
    end times.  A new bulk transfer sees each crossed uplink's capacity
    divided by ``active flows + 1`` (itself); in-flight transfers are
    never re-timed, so admitting a new flow can only slow the *new*
    transfer — contention is monotone by construction, and the whole
    tracker is deterministic under a fixed event order.
    """

    def __init__(self, topology: Topology) -> None:
        self.topology = topology
        self._flows: List[List[float]] = [[] for _ in range(topology.n_racks)]
        self.bulk_transfers = 0
        self.contended_transfers = 0
        # Fair-share fractions applied to the most recent transfer_time
        # call, one per crossed uplink (empty for local paths).  The
        # flight recorder reads this to tag each traced transfer with
        # the contention share it actually received.
        self.last_shares: Tuple[float, ...] = ()

    def active_flows(self, rack: int, now: float) -> int:
        heap = self._flows[rack]
        while heap and heap[0] <= now:
            heapq.heappop(heap)
        return len(heap)

    def transfer_time(self, nbytes: float, src: int, dst: int,
                      now: float) -> float:
        """Contention-aware path time if a transfer started at ``now``
        (does not register the flow)."""
        uplinks = self.topology.path_uplinks(src, dst)
        if not uplinks:
            self.last_shares = ()
            return self.topology.transfer_time(nbytes, src, dst)
        shares = tuple(
            1.0 / (self.active_flows(r, now) + 1) for r in uplinks
        )
        self.last_shares = shares
        return self.topology.transfer_time(nbytes, src, dst, shares)

    def start_transfer(self, nbytes: float, src: int, dst: int,
                       now: float) -> float:
        """Register a bulk transfer starting at ``now`` on every uplink
        along its path; returns its (contended) duration."""
        dur = self.transfer_time(nbytes, src, dst, now)
        uplinks = self.topology.path_uplinks(src, dst)
        if uplinks and nbytes > 0:
            self.bulk_transfers += 1
            if any(self.active_flows(r, now) for r in uplinks):
                self.contended_transfers += 1
            for r in uplinks:
                heapq.heappush(self._flows[r], now + dur)
        return dur


@dataclasses.dataclass(frozen=True)
class AcceleratorLink:
    """Host→accelerator model fetch cost model (PCIe on the paper's T4
    testbed).

    The Navigator cache holds model objects *compressed*; making a model
    executable requires transfer + decompression + framework initialization
    (§3.3).  The effective bandwidth is therefore far below raw PCIe —
    2 GB/s effective makes a several-GB model a multi-second fetch, which
    matches the paper's premise that "it is costly to fetch large models at
    the last instant" against 1–3 s idle job completion times.
    """

    bandwidth_bytes_per_s: float = 2.0 * GB  # transfer+decompress+init
    delta_s: float = 0.1  # delta_PCIe: driver/alloc constant

    def fetch_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return nbytes / self.bandwidth_bytes_per_s + self.delta_s


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Static description of the worker cluster.

    The paper's testbed (§6): 5 workers, Tesla T4 (16 GB) each, dual Xeon
    Gold 6242, 192 GB host DRAM, 100 Gbps InfiniBand.  ``worker_speed``
    allows heterogeneous workers (HEFT heritage); R(t, w) =
    runtime_s / worker_speed[w].
    """

    n_workers: int = 5
    gpu_capacity_bytes: float = 16.0 * GB
    network: NetworkModel = dataclasses.field(default_factory=NetworkModel)
    link: AcceleratorLink = dataclasses.field(default_factory=AcceleratorLink)
    worker_speed: Optional[Dict[int, float]] = None
    # Per-worker GPU memory overrides (heterogeneous fleets); workers not
    # listed fall back to ``gpu_capacity_bytes``.
    worker_gpu_capacity: Optional[Dict[int, float]] = None
    # Compressed/decompressed bytes ratio for Navigator-cache accounting
    # (§3.3: the cache holds models compressed; execution memory holds a
    # decompressed instance per active task).
    compression_ratio: float = 0.6
    # Energy proxy (Table 1): active vs idle GPU power draw.
    gpu_power_active_w: float = 70.0  # T4 TDP
    gpu_power_idle_w: float = 10.0
    # Optional rack topology.  ``None`` (the default) preserves the flat
    # all-pairs table exactly: every path cost delegates to ``network``.
    topology: Optional[Topology] = None

    def __post_init__(self) -> None:
        if (
            self.topology is not None
            and self.topology.n_workers != self.n_workers
        ):
            raise ValueError(
                f"topology covers {self.topology.n_workers} workers, "
                f"cluster has {self.n_workers}"
            )

    def speed(self, worker: int) -> float:
        if self.worker_speed is None:
            return 1.0
        return self.worker_speed.get(worker, 1.0)

    def gpu_capacity(self, worker: int) -> float:
        """GPU memory of ``worker`` (heterogeneous fleets override the
        uniform ``gpu_capacity_bytes`` per worker)."""
        if self.worker_gpu_capacity is None:
            return self.gpu_capacity_bytes
        return self.worker_gpu_capacity.get(worker, self.gpu_capacity_bytes)

    @property
    def total_speed(self) -> float:
        """Aggregate fleet throughput multiplier (used to hold offered
        load constant when sweeping fleet heterogeneity)."""
        return sum(self.speed(w) for w in self.workers())

    def runtime_on(self, base_runtime_s: float, worker: int) -> float:
        """R(t, w) from the profiled base runtime R(t)."""
        return base_runtime_s / self.speed(worker)

    def workers(self) -> range:
        return range(self.n_workers)

    def path_transfer_time(self, nbytes: float, src: int, dst: int) -> float:
        """Uncontended ``src → dst`` transfer time: the flat table when no
        topology is configured (bit-exact with the pre-topology model),
        the path cost otherwise."""
        if self.topology is None:
            return self.network.transfer_time(nbytes)
        return self.topology.transfer_time(nbytes, src, dst)
