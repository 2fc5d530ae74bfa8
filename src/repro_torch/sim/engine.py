"""Event-driven cluster simulator (§5.4), copied from the JAX package so
that the port stands alone; a seeded run gives the reference's records.

Models the environment of §3 at the fidelity the paper describes: task
arrival, queue waiting, model fetch (PCIe), task execution (one active GPU
task per worker), task dispatch with network transfer of intermediate
objects, and rate-limited SST dissemination.  Events are processed in
simulated-time order (heap).  The paper validated its simulator within 5 %
of the real 5-worker testbed; ours follows the same structure (Sparrow
style) and uses the same profiled constants.

Execution semantics (faithful to §3.2):
* A worker's Task Dispatcher scans its execution queue in order and starts
  the first task whose inputs are present and whose model is resident; a
  task whose model is being fetched (or whose inputs are missing) is left
  on the queue and the dispatcher proceeds to the next.
* One model fetch (PCIe transfer) is in flight per worker at a time; it
  overlaps with GPU execution of other tasks.
* On task completion the scheduler's dynamic-adjustment hook runs for each
  successor (Alg. 2), then outputs are shipped to the successors' workers.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple, Union

import numpy as np

from repro_torch.core.healthplane import HealthConfig, HealthMonitor
from repro_torch.core.memory import GpuMemoryManager
from repro_torch.core.netmodel import ClusterSpec, NetworkState
from repro_torch.core.telemetry import (
    FlightRecorder,
    MetricsRegistry,
    TraceConfig,
)
from repro_torch.core.prefetch import (
    INTENT_WIRE_BYTES,
    PrefetchConfig,
    PrefetchIntent,
    PrefetchPlane,
    PrefetchStats,
)
from repro_torch.core.profiles import ProfileRepository
from repro_torch.core.scheduler import (
    NavigatorConfig,
    Scheduler,
    make_scheduler,
)
from repro_torch.core.sst_exchange import GossipConfig, GossipPlane
from repro_torch.core.state import DEAD, LeaseConfig, SharedStateTable
from repro_torch.core.types import ADFG, Job, MLModel
from repro_torch.sim.churn import CRASH, DRAIN, HEAL, JOIN, PARTITION, ChurnEvent


# --------------------------------------------------------------------------
# Per-job bookkeeping
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _TaskRun:
    enqueued: bool = False
    fetching: bool = False
    was_miss: bool = False
    # Assigned to a GPU that can never host the model (capacity-blind
    # scheduler on a heterogeneous fleet); being re-routed by the
    # dispatcher.
    bouncing: bool = False
    started: Optional[float] = None
    finished: Optional[float] = None
    worker: Optional[int] = None
    # Attempt counter: every re-route/re-execution (bounce, worker crash,
    # drain) bumps it, and in-flight events tagged with an older value are
    # void on delivery — the mechanism that keeps gossip-declared death
    # racing in-flight fetches/inputs/completions safe.
    generation: int = 0
    # Worker incarnation at completion time: the task's output survives
    # only while its worker is up in the SAME incarnation (a crash wipes
    # outputs even if the worker rejoins before anyone re-reads them).
    session: int = 0


class _JobState:
    def __init__(self, job: Job, origin: int) -> None:
        self.job = job
        self.origin = origin
        self.adfg: Optional[ADFG] = None
        self.tasks: Dict[str, _TaskRun] = {
            t: _TaskRun() for t in job.dfg.tasks
        }
        # task -> set of predecessors whose outputs have arrived at the
        # task's assigned worker (external input counts via the sentinel "").
        self.inputs_arrived: Dict[str, Set[str]] = {t: set() for t in job.dfg.tasks}
        self.finish_time: Optional[float] = None

    def inputs_ready(self, task_id: str) -> bool:
        dfg = self.job.dfg
        need = set(dfg.preds[task_id]) or {""}
        return need <= self.inputs_arrived[task_id]

    def done(self) -> bool:
        return all(r.finished is not None for r in self.tasks.values())


@dataclasses.dataclass
class JobRecord:
    job_id: int
    dfg_name: str
    arrival: float
    finish: float
    lower_bound: float

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def slowdown(self) -> float:
        return self.latency / self.lower_bound if self.lower_bound > 0 else 1.0


@dataclasses.dataclass
class SimResult:
    """Per-run outcome.  All counters live in the :class:`MetricsRegistry`
    (``metrics``) under named, labeled families — the legacy flat fields
    (``cache_hits``, ``net_local_transfers``, ...) are derived views over
    it, so existing benchmarks and tests keep working unchanged."""

    scheduler: str
    records: List[JobRecord]
    horizon: float
    n_workers: int
    busy_time: Dict[int, float]
    workers_used: Set[int]
    metrics: MetricsRegistry
    prefetch_stats: Optional[PrefetchStats] = None
    # (job_id, task_id) -> accepted completion count; every task completes
    # >= 1 time, and sum == n_tasks + outputs_recovered.
    task_completions: Optional[Dict[Tuple[int, str], int]] = None
    # (time, kind) per processed event when ``record_events=True`` — the
    # determinism regression tests compare two runs' logs verbatim.
    event_log: Optional[List[Tuple[float, str]]] = None
    # Flight recorder (core/telemetry.py) when the run was traced; feed
    # it (or the whole result) to ``SimReport`` for latency breakdowns,
    # critical paths, and placement provenance.
    trace: Optional[FlightRecorder] = None
    # Health monitor (core/healthplane.py) when the health plane ran:
    # windowed series, latency sketches, and detector ledger — read via
    # ``SimReport.health_summary()`` or ``health.summary()`` directly.
    health: Optional[HealthMonitor] = None

    # -- derived views over the metrics registry -------------------------------
    @property
    def cache_hits(self) -> int:
        return int(self.metrics.sum_values("cache.hits"))

    @property
    def cache_misses(self) -> int:
        return int(self.metrics.sum_values("cache.misses"))

    @property
    def cache_evictions(self) -> int:
        return int(self.metrics.sum_values("cache.evictions"))

    @property
    def bytes_fetched(self) -> float:
        return self.metrics.sum_values("cache.bytes_fetched")

    @property
    def sst_pushes(self) -> int:
        return int(self.metrics.value("sst.pushes"))

    @property
    def adjustments(self) -> int:
        return int(self.metrics.value("sched.adjustments"))

    # Predictive prefetch plane (core/prefetch.py); zeros when disabled.
    @property
    def prefetch_bytes(self) -> float:
        return self.metrics.sum_values("prefetch.bytes")

    @property
    def prefetch_wasted_bytes(self) -> float:
        return self.metrics.sum_values("prefetch.wasted_bytes")

    @property
    def prefetch_unused_resident_bytes(self) -> float:
        return self.metrics.sum_values("prefetch.unused_resident_bytes")

    @property
    def prefetch_useful(self) -> int:
        return int(self.metrics.sum_values("prefetch.useful"))

    # Fleet churn / fault tolerance (zeros on a static fleet).
    @property
    def churn_crashes(self) -> int:
        return int(self.metrics.value("churn.events", kind="crash"))

    @property
    def churn_joins(self) -> int:
        return int(self.metrics.value("churn.events", kind="join"))

    @property
    def churn_drains(self) -> int:
        return int(self.metrics.value("churn.events", kind="drain"))

    @property
    def churn_partitions(self) -> int:
        return int(self.metrics.value("churn.events", kind="partition"))

    @property
    def churn_heals(self) -> int:
        return int(self.metrics.value("churn.events", kind="heal"))

    # Topology plane (zeros on a flat cluster): bulk transfers that stayed
    # inside one rack vs. crossed the (oversubscribable) spine, and how
    # many of the crossing ones shared an uplink with another in-flight
    # transfer (fair-share slowdown actually applied).
    @property
    def net_local_transfers(self) -> int:
        return int(self.metrics.value("net.transfers", scope="local"))

    @property
    def net_cross_transfers(self) -> int:
        return int(self.metrics.value("net.transfers", scope="cross"))

    @property
    def net_contended_transfers(self) -> int:
        return int(self.metrics.value("net.transfers", scope="contended"))

    @property
    def bounces(self) -> int:
        """Capacity bounces executed (§3.2 dispatcher)."""
        return int(self.metrics.value("sched.bounces"))

    @property
    def tasks_rescued(self) -> int:
        """In-flight/queued work re-routed off a dead worker."""
        return int(self.metrics.value("churn.tasks_rescued"))

    @property
    def outputs_recovered(self) -> int:
        """Finished producers re-run (outputs died)."""
        return int(self.metrics.value("churn.outputs_recovered"))

    @property
    def churn_wasted_bytes(self) -> float:
        """PCIe bytes thrown away by churn."""
        return self.metrics.sum_values("churn.wasted_bytes")

    # Accounting-balance inputs for the chaos invariant checker:
    # hits + misses == model_exec_starts + lost_miss_attempts
    #                  + demand_refetches.
    @property
    def model_exec_starts(self) -> int:
        return int(self.metrics.value("exec.model_starts"))

    @property
    def lost_miss_attempts(self) -> int:
        return int(self.metrics.value("exec.lost_miss_attempts"))

    @property
    def demand_refetches(self) -> int:
        """A waiting task's fetched model was evicted before it could
        start (another task's execution displaced it): the dispatcher
        fetches again, charging a second miss against the same eventual
        start."""
        return int(self.metrics.value("exec.demand_refetches"))

    # -- aggregates ------------------------------------------------------------
    @property
    def mean_latency(self) -> float:
        return sum(r.latency for r in self.records) / max(1, len(self.records))

    @property
    def mean_slowdown(self) -> float:
        return sum(r.slowdown for r in self.records) / max(1, len(self.records))

    @property
    def median_slowdown(self) -> float:
        xs = sorted(r.slowdown for r in self.records)
        if not xs:
            return 0.0
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def slowdowns_by_type(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for r in self.records:
            out.setdefault(r.dfg_name, []).append(r.slowdown)
        return out

    @property
    def cache_hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 1.0

    @property
    def gpu_utilization(self) -> float:
        if self.horizon <= 0:
            return 0.0
        return sum(self.busy_time.values()) / (self.horizon * self.n_workers)

    def energy_joules(self, cluster: ClusterSpec) -> float:
        busy = sum(self.busy_time.values())
        idle = self.horizon * self.n_workers - busy
        return busy * cluster.gpu_power_active_w + idle * cluster.gpu_power_idle_w

    def percentile_latency(self, q: float) -> float:
        xs = sorted(r.latency for r in self.records)
        if not xs:
            return 0.0
        idx = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
        return xs[idx]


# --------------------------------------------------------------------------
# Simulator
# --------------------------------------------------------------------------
class Simulation:
    def __init__(
        self,
        cluster: ClusterSpec,
        profiles: ProfileRepository,
        models: Mapping[int, MLModel],
        scheduler: str = "navigator",
        navigator_config: Optional[NavigatorConfig] = None,
        eviction_policy: str = GpuMemoryManager.LOOKAHEAD,
        push_interval_s: float = 0.2,
        cache_push_interval_s: Optional[float] = None,
        gossip: Optional[GossipConfig] = None,
        prefetch: Optional[PrefetchConfig] = None,
        lease: Optional[LeaseConfig] = None,
        churn: Optional[Sequence[ChurnEvent]] = None,
        record_events: bool = False,
        trace: Union[bool, TraceConfig] = False,
        health: Union[bool, HealthConfig] = False,
        runtime_noise_sigma: float = 0.25,
        seed: int = 0,
        engine: str = "indexed",
    ) -> None:
        if engine not in ("indexed", "reference"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.cluster = cluster
        self.profiles = profiles
        self.models = dict(models)
        self.scheduler: Scheduler = make_scheduler(
            scheduler, profiles, navigator_config
        )
        # Flight recorder (core/telemetry.py).  ``None`` when off: every
        # emission site below is guarded by ``if self._rec is not None``,
        # so the disabled path costs one attribute load + branch and
        # performs zero telemetry allocations in the event loop (the CI
        # trace-smoke guard asserts exactly that).
        self._rec: Optional[FlightRecorder] = None
        if trace:
            self._rec = FlightRecorder(
                cluster.n_workers,
                trace if isinstance(trace, TraceConfig) else None,
            )
        self.scheduler.recorder = self._rec  # placement provenance sink
        # Health plane (core/healthplane.py).  Same zero-overhead-when-off
        # contract as the recorder: every sampling site below is guarded
        # by ``if self._health is not None``.
        self._health: Optional[HealthMonitor] = None
        if health:
            self._health = HealthMonitor(
                cluster.n_workers,
                health if isinstance(health, HealthConfig) else None,
                recorder=self._rec,
            )
        # Indexed engine: planners read the SST as packed numpy columns
        # (one O(W) column copy per read instead of W python row copies)
        # and score all candidates in one vector pass — bit-exact with the
        # scalar row path (chaos family 7).  The flight recorder needs
        # per-candidate provenance only the scalar path records, so
        # tracing forces the reference read path.
        self._use_packed = engine == "indexed" and self._rec is None
        # Metadata plane: ``gossip`` selects the decentralized per-worker
        # view subsystem (each worker plans from its own, possibly stale,
        # replica); default is the single-published-snapshot table.
        # ``lease`` enables the membership lane on either plane: workers
        # heartbeat their own row and every reader classifies peers
        # ALIVE/SUSPECT/DEAD from its own replica's heartbeat age.
        self.gossip = gossip
        self.lease = lease
        if churn and lease is None:
            # Churn without a membership lane would leave informed
            # schedulers placing onto corpses forever; default the lease.
            lease = self.lease = LeaseConfig()
        self.churn = list(churn or [])
        if gossip is not None:
            self.sst = GossipPlane(
                cluster.n_workers, gossip, seed=seed, lease=lease
            )
        else:
            self.sst = SharedStateTable(
                cluster.n_workers, push_interval_s, cache_push_interval_s,
                lease=lease,
            )
        self.memories = [
            GpuMemoryManager(
                cluster.gpu_capacity(w),
                self.models,
                cluster.link,
                policy=eviction_policy,
                compression_ratio=cluster.compression_ratio,
            )
            for w in cluster.workers()
        ]
        self.rng = random.Random(seed)
        self.noise_sigma = runtime_noise_sigma

        self._heap: List[Tuple[float, int, Tuple]] = []
        self._seq = itertools.count()
        self._now = 0.0
        self._queues: List[List[Tuple[_JobState, str]]] = [
            [] for _ in cluster.workers()
        ]
        self._gpu_busy: List[Optional[Tuple[_JobState, str]]] = [
            None for _ in cluster.workers()
        ]
        # Fetch-pipe state (one PCIe transfer in flight per worker, §3.2).
        # ``_fetch_model`` is the model on the pipe; ``_fetch_preemptible``
        # marks a speculative prefetch a demand fetch may abort; the token
        # invalidates posted completion events after a preemption.
        self._fetch_busy: List[bool] = [False for _ in cluster.workers()]
        self._fetch_model: List[Optional[int]] = [
            None for _ in cluster.workers()
        ]
        self._fetch_spec: List[bool] = [False for _ in cluster.workers()]
        self._fetch_preemptible: List[bool] = [
            False for _ in cluster.workers()
        ]
        self._fetch_started: List[float] = [0.0 for _ in cluster.workers()]
        self._fetch_ends: List[float] = [0.0 for _ in cluster.workers()]
        self._fetch_token: List[int] = [0 for _ in cluster.workers()]
        # Predictive prefetch plane (plan-driven speculative fetches).
        self.prefetch_plane: Optional[PrefetchPlane] = None
        if prefetch is not None:
            self.prefetch_plane = PrefetchPlane(
                cluster.n_workers, prefetch, fetch_time_fn=profiles.td_model
            )
        self._poke_at: List[Optional[float]] = [
            None for _ in cluster.workers()
        ]
        self._busy_time: Dict[int, float] = {w: 0.0 for w in cluster.workers()}
        self._records: List[JobRecord] = []
        self._jobs_open = 0
        self._workers_used: Set[int] = set()
        self._adjustments = 0
        # Fleet membership ground truth (what the world is, not what any
        # worker's view says) plus per-worker incarnation sessions that
        # void stale periodic events (gossip/heartbeat/publication chains)
        # across down/up transitions.
        self._up: List[bool] = [True for _ in cluster.workers()]
        self._draining: List[bool] = [False for _ in cluster.workers()]
        self._session: List[int] = [0 for _ in cluster.workers()]
        self._open_jobs: List[_JobState] = []
        # Amortized roster compaction: prune finished jobs once the list
        # doubles past the last compacted size, so a churn-free 1M-job
        # replay does not pin every finished _JobState for the whole run.
        self._compact_open_at = 64
        self._events = 0
        self._orphaned_intents: Dict[Tuple[int, str], PrefetchIntent] = {}
        self._completions: Dict[Tuple[int, str], int] = {}
        self._bounces = 0
        self._tasks_rescued = 0
        self._outputs_recovered = 0
        self._model_exec_starts = 0
        self._lost_miss_attempts = 0
        self._demand_refetches = 0
        self._churn_crashes = 0
        self._churn_joins = 0
        self._churn_drains = 0
        self._churn_partitions = 0
        self._churn_heals = 0
        # Topology plane: contention tracker over the cluster's rack graph
        # (None on a flat cluster — every wire cost then takes the exact
        # pre-topology all-pairs code path) and the open partition, as
        # worker -> group id (None = fully connected).
        self._net: Optional[NetworkState] = (
            NetworkState(cluster.topology)
            if cluster.topology is not None
            else None
        )
        self._partition: Optional[List[int]] = None
        self._net_local = 0
        self._net_cross = 0
        # Replayable event log (determinism regression tests).
        self.event_log: Optional[List[Tuple[float, str]]] = (
            [] if record_events else None
        )
        for w in cluster.workers():
            self.sst.update_cache(w, 0, cluster.gpu_capacity(w), 0.0)
            if self.lease is not None:
                self.sst.heartbeat(w, 0.0)
            self.sst.push(w, 0.0)

    # -- event plumbing ----------------------------------------------------------
    def _post(self, t: float, kind: str, *payload) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), (kind, *payload)))

    def _post_input(
        self,
        t_arrive: float,
        js: "_JobState",
        tid: str,
        src: str,
        worker: int,
        gen: int,
        src_worker: Optional[int],
    ) -> None:
        """Post one input shipment, tracing its send/arrive pair.  The
        span stitcher reconstructs per-task transfer time from exactly
        these records (``t`` = send time, ``arrive`` = landing time)."""
        if self._rec is not None:
            self._rec.emit(
                self._now, "task.input", worker=worker,
                job=js.job.job_id, task=tid, gen=gen, src=src,
                frm=src_worker, to=worker, arrive=t_arrive,
            )
        self._post(t_arrive, "input", js, tid, src, worker, gen, src_worker)

    def _noisy(self, runtime: float) -> float:
        if self.noise_sigma <= 0:
            return runtime
        return runtime * self.rng.lognormvariate(0.0, self.noise_sigma)

    def _sst_view(self, reader: int):
        """Planner-facing SST read: packed columns on the indexed engine,
        the scalar row list otherwise.  Both planes keep a columnar mirror
        maintained O(1) per dirty row, so the packed read is a handful of
        numpy column copies rather than W python row copies."""
        if self._use_packed:
            return self.sst.view_arrays(reader, self._now)
        return self.sst.view(reader, self._now)

    # -- public API ----------------------------------------------------------------
    def run(self, jobs: Sequence[Job]) -> SimResult:
        """Drive the simulation to completion.  Split into schedule /
        event-loop / assemble stages so the CI zero-allocation guard can
        profile the hot event loop in isolation (result assembly builds
        the metrics registry, which allocates by design)."""
        self._schedule_initial(jobs)
        self._event_loop()
        return self._assemble_result()

    def _schedule_initial(self, jobs: Sequence[Job]) -> None:
        origin = itertools.cycle(self.cluster.workers())
        for job in sorted(jobs, key=lambda j: j.arrival_time):
            self._post(job.arrival_time, "arrival", job, next(origin))
        for ev in self.churn:
            self._post(ev.time, "churn", ev)
        # SST dissemination schedule (staggered per worker).
        if self.gossip is not None:
            for w in self.cluster.workers():
                offset = (w + 1) * self.gossip.period_s / max(
                    1, self.cluster.n_workers
                )
                self._post(offset, "gossip", w, 0)
        else:
            for w in self.cluster.workers():
                offset = (w + 1) * self.sst.push_interval_s / max(
                    1, self.cluster.n_workers
                )
                self._post(offset, "sst_load", w, 0)
                offset_c = (w + 1) * self.sst.cache_push_interval_s / max(
                    1, self.cluster.n_workers
                )
                self._post(offset_c, "sst_cache", w, 0)
        if self.lease is not None:
            for w in self.cluster.workers():
                offset = (w + 1) * self.lease.heartbeat_period_s / max(
                    1, self.cluster.n_workers
                )
                self._post(offset, "heartbeat", w, 0)
        self._jobs_open = len(jobs)

    def _event_loop(self) -> None:
        while self._heap and self._jobs_open > 0:
            t, _, ev = heapq.heappop(self._heap)
            self._now = t
            self._events += 1
            kind = ev[0]
            if self.event_log is not None:
                self.event_log.append((round(t, 9), kind))
            if kind == "arrival":
                self._on_arrival(ev[1], ev[2])
            elif kind == "enqueue":
                self._on_enqueue(ev[1], ev[2], ev[3])
            elif kind == "input":
                self._on_input(ev[1], ev[2], ev[3], ev[4], ev[5], ev[6])
            elif kind == "fetch_done":
                self._on_fetch_done(ev[1], ev[2])
            elif kind == "task_done":
                self._on_task_done(ev[1], ev[2], ev[3], ev[4])
            elif kind == "task_fetch_bookkeep":
                self._on_fetch_bookkeep(ev[1], ev[2], ev[3], ev[4])
            elif kind == "intent":
                self._on_intent(ev[1], ev[2])
            elif kind == "intent_cancel":
                self._on_intent_cancel(ev[1], ev[2], ev[3])
            elif kind == "prefetch_poke":
                self._on_prefetch_poke(ev[1], t)
            elif kind == "bounce":
                self._on_bounce(ev[1], ev[2], ev[3], ev[4])
            elif kind == "churn":
                self._on_churn(ev[1])
            elif kind == "recover":
                self._on_recover(ev[1])
            elif kind == "dead_letter":
                self._on_dead_letter(ev[1], ev[2], ev[3], ev[4], ev[5])
            elif kind == "reroute_retry":
                self._on_reroute_retry(ev[1], ev[2], ev[3], ev[4])
            elif kind == "heartbeat":
                self._on_heartbeat(ev[1], ev[2])
            elif kind == "sst_load":
                if ev[2] == self._session[ev[1]] and self._up[ev[1]]:
                    if self._health is not None:
                        self._refresh_health_digest(ev[1])
                    self.sst.push_load(ev[1], t)
                    self._post(
                        t + self.sst.push_interval_s, "sst_load", ev[1], ev[2]
                    )
            elif kind == "sst_cache":
                if ev[2] == self._session[ev[1]] and self._up[ev[1]]:
                    self.sst.push_cache(ev[1], t)
                    self._post(
                        t + self.sst.cache_push_interval_s,
                        "sst_cache", ev[1], ev[2],
                    )
            elif kind == "gossip":
                self._on_gossip(ev[1], ev[2])
            elif kind == "gossip_rx":
                # A cut drops cross-group gossip at delivery time: the
                # message was in flight when the link went down.  Rows are
                # full-state (newest version wins), so post-heal rounds
                # reconverge without replaying the lost diffs.
                if self._up[ev[1]] and self._reachable(ev[3], ev[1]):
                    self.sst.deliver(ev[1], ev[2], t)
            else:  # pragma: no cover
                raise AssertionError(f"unknown event {kind}")

    def _assemble_result(self) -> SimResult:
        """Fold the engine's hot-loop counters (plain ints — cheap to
        bump, free when tracing is off) and the per-worker memory ledgers
        into one named, labeled metrics registry.  The legacy SimResult
        fields read back out of it as derived views."""
        reg = MetricsRegistry()
        for w, m in enumerate(self.memories):
            ws = str(w)
            s = m.stats
            reg.counter("cache.hits", worker=ws).inc(s.hits)
            reg.counter("cache.misses", worker=ws).inc(s.misses)
            reg.counter("cache.evictions", worker=ws).inc(s.evictions)
            reg.counter("cache.bytes_fetched", worker=ws).inc(s.bytes_fetched)
            reg.counter("prefetch.bytes", worker=ws).inc(s.prefetch_bytes)
            reg.counter("prefetch.wasted_bytes", worker=ws).inc(
                s.prefetch_wasted_bytes
            )
            reg.counter("prefetch.useful", worker=ws).inc(s.prefetch_useful)
            reg.counter("churn.wasted_bytes", worker=ws).inc(
                s.churn_wasted_bytes
            )
            reg.gauge("prefetch.unused_resident_bytes", worker=ws).set(
                m.unused_prefetched_bytes()
            )
            reg.gauge("exec.busy_s", worker=ws).set(self._busy_time[w])
        reg.counter("sst.pushes").inc(self.sst.total_pushes)
        reg.counter("sched.adjustments").inc(self._adjustments)
        reg.counter("sched.bounces").inc(self._bounces)
        for kind, v in (
            ("crash", self._churn_crashes),
            ("join", self._churn_joins),
            ("drain", self._churn_drains),
            ("partition", self._churn_partitions),
            ("heal", self._churn_heals),
        ):
            reg.counter("churn.events", kind=kind).inc(v)
        reg.counter("churn.tasks_rescued").inc(self._tasks_rescued)
        reg.counter("churn.outputs_recovered").inc(self._outputs_recovered)
        reg.counter("net.transfers", scope="local").inc(self._net_local)
        reg.counter("net.transfers", scope="cross").inc(self._net_cross)
        reg.counter("net.transfers", scope="contended").inc(
            self._net.contended_transfers if self._net is not None else 0
        )
        reg.counter("exec.model_starts").inc(self._model_exec_starts)
        reg.counter("exec.lost_miss_attempts").inc(self._lost_miss_attempts)
        reg.counter("exec.demand_refetches").inc(self._demand_refetches)
        reg.gauge("sim.horizon_s").set(self._now)
        reg.counter("sim.events").inc(self._events)
        reg.counter("sim.jobs_completed").inc(len(self._records))
        if self._rec is not None:
            # Per-ring FIFO drop counters (satellite of the health plane):
            # counted inside the recorder, visible in the metrics export so
            # a drop-rate alert needs no trace access.
            for ring, (emitted, dropped) in self._rec.ring_stats().items():
                reg.counter("trace.emitted", ring=ring).inc(emitted)
                reg.counter("trace.dropped", ring=ring).inc(dropped)
        if self._health is not None:
            for kind in sorted(self._health.counts):
                reg.counter("health.events", kind=kind).inc(
                    self._health.counts[kind]
                )
        lat = reg.histogram(
            "job.latency_s",
            bounds=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
        )
        for r in self._records:
            lat.observe(r.latency)
        return SimResult(
            scheduler=self.scheduler.name,
            records=self._records,
            horizon=self._now,
            n_workers=self.cluster.n_workers,
            busy_time=self._busy_time,
            workers_used=self._workers_used,
            metrics=reg,
            prefetch_stats=(
                self.prefetch_plane.stats
                if self.prefetch_plane is not None
                else None
            ),
            task_completions=dict(self._completions),
            event_log=self.event_log,
            trace=self._rec,
            health=self._health,
        )

    # -- network plane -----------------------------------------------------------
    def _xfer_time(
        self,
        nbytes: float,
        src: Optional[int] = None,
        dst: Optional[int] = None,
        register: bool = False,
    ) -> float:
        """Wire time for one transfer.  Without a topology (or with an
        unknown endpoint) this is the flat all-pairs table — the exact
        pre-topology cost, including its quirk of charging a transfer even
        when ``src == dst``.  With a topology it is the path cost, and
        ``register`` (bulk data: inputs, outputs, re-shipments) enrolls
        the flow on every crossed uplink so concurrent cross-rack
        transfers fair-share the spine; control messages ride unregistered
        and uncontended."""
        if self._net is None or src is None or dst is None:
            dur = self.cluster.network.transfer_time(nbytes)
            if register and self._rec is not None and src is not None:
                self._rec.emit(
                    self._now, "net.xfer", worker=src, dst=dst,
                    bytes=nbytes, dur=dur, scope="flat", share=1.0,
                )
            if register and self._health is not None and src is not None:
                self._health.on_transfer(
                    self._now, "flat", nbytes, 1.0, cross=False
                )
            return dur
        if src == dst:
            return 0.0
        if register:
            topo = self._net.topology
            local = topo.rack(src) == topo.rack(dst)
            if local:
                self._net_local += 1
            else:
                self._net_cross += 1
            dur = self._net.start_transfer(nbytes, src, dst, self._now)
            share = min(self._net.last_shares, default=1.0)
            if self._rec is not None:
                self._rec.emit(
                    self._now, "net.xfer", worker=src, dst=dst,
                    bytes=nbytes, dur=dur,
                    scope="local" if local else "cross",
                    share=share,
                )
            if self._health is not None:
                self._health.on_transfer(
                    self._now,
                    f"rack{topo.rack(src)}" if local
                    else f"spine.rack{topo.rack(src)}",
                    nbytes, share, cross=not local,
                )
            return dur
        return self._net.transfer_time(nbytes, src, dst, self._now)

    def _reachable(self, a: Optional[int], b: Optional[int]) -> bool:
        """Whether a message between two workers crosses an open cut.
        Unknown endpoints are assumed reachable (the flat pre-partition
        behaviour); groups are equivalence classes, so reachability is
        transitive among known endpoints."""
        if self._partition is None or a is None or b is None or a == b:
            return True
        return self._partition[a] == self._partition[b]

    # -- event handlers --------------------------------------------------------------
    def _serving(self, worker: int) -> bool:
        """Ground truth: the worker is up and accepting new work."""
        return self._up[worker] and not self._draining[worker]

    def _live_workers(self) -> List[int]:
        return [w for w in self.cluster.workers() if self._serving(w)]

    def _live_origin(self, preferred: int) -> Optional[int]:
        """Clients connect to a live front-end: the preferred origin if it
        serves, else the next serving worker by id (deterministic)."""
        n = self.cluster.n_workers
        for d in range(n):
            w = (preferred + d) % n
            if self._serving(w):
                return w
        return None

    def _on_arrival(self, job: Job, origin: int) -> None:
        live = self._live_origin(origin)
        if live is None:
            if not self._fleet_can_serve(None):
                raise ValueError(
                    "whole fleet is down with no scheduled joins; "
                    "arrivals can never be served"
                )
            # Whole fleet down/draining: the client retries shortly.
            self._post(self._now + 1.0, "arrival", job, origin)
            return
        origin = live
        js = _JobState(job, origin)
        self._open_jobs.append(js)
        if len(self._open_jobs) >= self._compact_open_at:
            self._open_jobs = [
                j for j in self._open_jobs if j.finish_time is None
            ]
            self._compact_open_at = max(64, 2 * len(self._open_jobs))
        if self._rec is not None:
            self._rec.emit(
                self._now, "job.arrive", job=job.job_id,
                dfg=job.dfg.name, origin=origin,
                n_tasks=len(job.dfg.tasks),
            )
        adfg = self.scheduler.plan(
            job, self._now, origin, self._sst_view(origin)
        )
        js.adfg = adfg
        if adfg is None:
            # JIT: entry tasks become ready immediately; pick workers now.
            js.adfg = ADFG(job)
            for tid in job.dfg.entry_tasks:
                self._jit_assign(js, tid, {"": origin}, {"": job.dfg.tasks[tid].input_bytes})
        else:
            if self.prefetch_plane is not None:
                # Plan → memory intents: every assigned worker learns which
                # models its future tasks need.  The origin worker (which
                # planned) knows immediately; remote workers learn after a
                # small control-message delay.
                per = self.prefetch_plane.plan_intents(
                    job, adfg, self.profiles, self._now
                )
                for w, intents in per.items():
                    if not self._reachable(origin, w):
                        continue  # best-effort control traffic; lost in the cut
                    delay = 0.0
                    if w != origin:
                        delay = self._xfer_time(
                            INTENT_WIRE_BYTES * len(intents), origin, w
                        )
                    self._post(self._now + delay, "intent", w, intents)
            for tid in job.dfg.entry_tasks:
                w = adfg[tid]
                delay = 0.0
                if w != origin:
                    delay = self._xfer_time(
                        job.dfg.tasks[tid].input_bytes, origin, w,
                        register=True,
                    )
                self._post_input(
                    self._now + delay, js, tid, "", w,
                    js.tasks[tid].generation, origin,
                )

    def _jit_assign(
        self,
        js: _JobState,
        task_id: str,
        input_locations: Dict[str, int],
        input_sizes: Dict[str, float],
    ) -> None:
        # Reader worker: where the largest input lives — shipping cost is
        # dominated by the biggest object, so the JIT decision is made (and
        # the SST replica read) there.
        reader_src = max(
            input_locations, key=lambda s: input_sizes.get(s, 0.0)
        )
        reader = input_locations[reader_src]
        if not self._up[reader]:
            # The largest input's holder died: read from any live worker
            # (the JIT decision has to be made somewhere).
            live = self._live_origin(reader)
            if live is not None:
                reader = live
        w = self.scheduler.select_worker_at_ready(
            js.job,
            task_id,
            self._now,
            self._sst_view(reader),
            input_locations,
            input_sizes,
            self_worker=reader,
        )
        assert js.adfg is not None
        js.adfg[task_id] = w
        # Ship all inputs to w (they travel as one batch: the slowest
        # path sets the arrival time).
        delay = 0.0
        for src, loc in input_locations.items():
            if loc != w:
                delay = max(
                    delay,
                    self._xfer_time(input_sizes[src], loc, w, register=True),
                )
        gen = js.tasks[task_id].generation
        for src, loc in input_locations.items():
            self._post_input(
                self._now + delay, js, task_id, src, w, gen, loc
            )

    def _on_input(
        self,
        js: _JobState,
        task_id: str,
        src: str,
        worker: int,
        gen: int,
        src_worker: Optional[int] = None,
    ) -> None:
        run = js.tasks[task_id]
        if gen != run.generation or run.finished is not None:
            return  # superseded by a re-route / re-execution
        reachable = self._reachable(src_worker, worker)
        if not self._serving(worker) or not reachable:
            if self._up[worker] and reachable:
                # Draining: the worker is alive and politely refuses, so
                # failover is immediate.
                self._reroute(js, task_id, from_worker=src_worker)
            else:
                # Dead — or alive but unreachable across a cut, which the
                # sender cannot tell apart: it only discovers the silence
                # after the connection timeout — the per-contact price
                # every membership-blind placement keeps paying all
                # through the outage, and an informed planner pays at
                # most once per lease window.
                timeout = (
                    self.lease.dead_letter_timeout_s
                    if self.lease is not None
                    else 0.0
                )
                self._post(
                    self._now + timeout, "dead_letter", js, task_id, src,
                    gen, src_worker,
                )
            return
        js.inputs_arrived[task_id].add(src)
        if not run.enqueued:
            run.enqueued = True
            run.worker = worker
            self._queues[worker].append((js, task_id))
            self._update_load(worker)
        self._dispatch(worker)

    def _on_fetch_done(self, worker: int, token: int) -> None:
        if token != self._fetch_token[worker]:
            return  # the transfer this event described was preempted
        mid = self._fetch_model[worker]
        spec = self._fetch_spec[worker]
        if self._rec is not None and mid is not None:
            self._rec.emit(
                self._now, "fetch.done", worker=worker, model=mid,
                spec=spec,
            )
        self._fetch_busy[worker] = False
        self._fetch_model[worker] = None
        self._fetch_spec[worker] = False
        self._fetch_preemptible[worker] = False
        if self._health is not None:
            self._health.fetch_state(worker, self._now, False)
        if spec and mid is not None:
            self.memories[worker].complete_prefetch(mid)
            if self.prefetch_plane is not None:
                self.prefetch_plane.complete_inflight(worker)
        self._publish_cache(worker)  # also refreshes the intent bitmap
        self._dispatch(worker)

    def _on_task_done(
        self, js: _JobState, task_id: str, worker: int, gen: int
    ) -> None:
        run = js.tasks[task_id]
        if gen != run.generation:
            return  # the worker died mid-run; the attempt is void
        run.finished = self._now
        run.session = self._session[worker]
        if self._rec is not None:
            self._rec.emit(
                self._now, "task.done", worker=worker,
                job=js.job.job_id, task=task_id, gen=gen,
            )
        key = (js.job.job_id, task_id)
        self._completions[key] = self._completions.get(key, 0) + 1
        task = js.job.dfg.tasks[task_id]
        if task.model_id is not None:
            self.memories[worker].end_execution(task.model_id)
            self._publish_cache(worker)
        self._busy_time[worker] += self._now - (run.started or self._now)
        if self._health is not None:
            self._health.task_done(
                worker, self._now,
                self._now - (run.started or self._now),
                self.profiles.runtime(task, worker),
            )
        self._gpu_busy[worker] = None
        self._update_load(worker)
        self._route_successors(js, task_id, worker)
        if js.done() and js.finish_time is None:
            js.finish_time = self._now
            self._records.append(
                JobRecord(
                    job_id=js.job.job_id,
                    dfg_name=js.job.dfg.name,
                    arrival=js.job.arrival_time,
                    finish=self._now,
                    lower_bound=js.job.lower_bound(),
                )
            )
            self._jobs_open -= 1
            if self._rec is not None:
                self._rec.emit(
                    self._now, "job.done", job=js.job.job_id,
                    latency=self._now - js.job.arrival_time,
                )
            if self._health is not None:
                self._health.job_done(
                    self._now, self._now - js.job.arrival_time
                )
        if (
            self._draining[worker]
            and self._gpu_busy[worker] is None
            and not self._fetch_busy[worker]
        ):
            self._complete_drain(worker)
            return
        self._dispatch(worker)

    # -- successor routing ---------------------------------------------------------
    def _route_successors(self, js: _JobState, task_id: str, worker: int) -> None:
        dfg = js.job.dfg
        task = dfg.tasks[task_id]
        adfg = js.adfg
        assert adfg is not None
        for succ in dfg.succs[task_id]:
            run_s = js.tasks[succ]
            if run_s.finished is not None or run_s.started is not None:
                # Already (re-)satisfied: a re-executed producer must not
                # disturb successors that consumed its original output.
                continue
            if self.scheduler.plans_at_arrival:
                if (
                    self.scheduler.needs_adjustment
                    and not dfg.is_join(succ)
                ):
                    new_w = self.scheduler.adjust(
                        js.job,
                        adfg,
                        succ,
                        self._now,
                        self._sst_view(worker),
                        worker,
                        task.output_bytes,
                    )
                    if new_w != adfg[succ]:
                        self._adjustments += 1
                        if self._rec is not None:
                            self._rec.emit(
                                self._now,
                                "sched.adjust",
                                worker=worker,
                                job=js.job.job_id,
                                task=succ,
                                frm=adfg[succ],
                                to=new_w,
                            )
                        if self.prefetch_plane is not None:
                            self._migrate_intent(
                                js, succ, adfg[succ], new_w, worker
                            )
                        adfg[succ] = new_w
                w = adfg[succ]
                delay = (
                    0.0
                    if w == worker
                    else self._xfer_time(
                        task.output_bytes, worker, w, register=True
                    )
                )
                self._post_input(
                    self._now + delay, js, succ, task_id, w,
                    run_s.generation, worker,
                )
            else:
                # JIT: assign when ALL predecessors have completed (and the
                # task was not already assigned by an earlier completion —
                # re-executed producers complete more than once).
                preds = dfg.preds[succ]
                if succ not in adfg.assignment and all(
                    js.tasks[p].finished is not None for p in preds
                ):
                    dead = [
                        p
                        for p in preds
                        if not self._output_alive(js.tasks[p])
                    ]
                    if dead:
                        # A producer's output departed with its worker:
                        # re-run it; its re-completion re-enters here.
                        for p in dead:
                            self._reexec_producer(js, p)
                        continue
                    locs = {p: js.tasks[p].worker for p in preds}
                    sizes = {p: dfg.tasks[p].output_bytes for p in preds}
                    self._jit_assign(js, succ, locs, sizes)  # type: ignore[arg-type]

    # -- dispatcher (§3.2) ------------------------------------------------------------
    def _dispatch(self, worker: int) -> None:
        if not self._serving(worker):
            return
        if self._gpu_busy[worker] is not None:
            # Still try to start a model fetch for a queued task.
            self._maybe_prefetch(worker)
            return
        queue = self._queues[worker]
        for idx, (js, tid) in enumerate(queue):
            if not js.inputs_ready(tid) or js.tasks[tid].bouncing:
                continue
            task = js.job.dfg.tasks[tid]
            mem = self.memories[worker]
            mid = task.model_id
            if mid is not None:
                inflight = (
                    self._fetch_busy[worker]
                    and self._fetch_model[worker] == mid
                )
                if inflight and self._fetch_preemptible[worker]:
                    # A queued task demands the model on the pipe: the
                    # speculative prefetch becomes a demand fetch.
                    self._promote_prefetch(worker, js, tid)
                if not mem.has(mid) or inflight:
                    if not inflight and not js.tasks[tid].fetching:
                        self._request_demand_fetch(worker, js, tid)
                    continue  # leave on queue, proceed to next (paper §3.2)
            # Start execution.
            queue.pop(idx)
            run = js.tasks[tid]
            run.started = self._now
            if self._rec is not None:
                self._rec.emit(
                    self._now, "task.start", worker=worker,
                    job=js.job.job_id, task=tid, gen=run.generation,
                    model=-1 if task.model_id is None else task.model_id,
                    miss=run.was_miss,
                )
            if task.model_id is not None:
                self._model_exec_starts += 1
                if not run.was_miss:
                    mem.stats.hits += 1  # model was already resident
                upcoming = [
                    js2.job.dfg.tasks[t2].model_id for js2, t2 in queue
                ]
                mem.begin_execution(task.model_id, upcoming)
                if self.prefetch_plane is not None:
                    self.prefetch_plane.consume(
                        worker, js.job.job_id, tid
                    )
                self._publish_cache(worker)
            self._gpu_busy[worker] = (js, tid)
            self._workers_used.add(worker)
            rt = self._noisy(self.profiles.runtime(task, worker))
            self._post(
                self._now + rt, "task_done", js, tid, worker, run.generation
            )
            self._update_load(worker)
            break
        self._maybe_prefetch(worker)

    def _maybe_prefetch(self, worker: int) -> None:
        """Keep the fetch pipe busy: demand fetches for queued tasks first;
        with the prefetch plane enabled, speculative fetches from the
        intent queue fill the idle pipe (demand preempts prefetch)."""
        if not self._serving(worker):
            return
        if not self._fetch_busy[worker] or self._fetch_preemptible[worker]:
            for js, tid in self._queues[worker]:
                task = js.job.dfg.tasks[tid]
                mid = task.model_id
                if (
                    mid is None
                    or js.tasks[tid].fetching
                    or js.tasks[tid].bouncing
                    or not js.inputs_ready(tid)
                ):
                    continue
                if (
                    self._fetch_busy[worker]
                    and self._fetch_model[worker] == mid
                ):
                    if self._fetch_preemptible[worker]:
                        self._promote_prefetch(worker, js, tid)
                    continue  # transfer already underway for this model
                if not self.memories[worker].has(mid):
                    self._request_demand_fetch(worker, js, tid)
                    return
        if self.prefetch_plane is not None and not self._fetch_busy[worker]:
            self._start_speculative_fetch(worker)

    def _request_demand_fetch(self, worker: int, js: _JobState, tid: str) -> None:
        if self._fetch_busy[worker]:
            if not self._fetch_preemptible[worker]:
                return  # pipe owned by a demand (or promoted) fetch
            # Demand preempts prefetch: abort the speculative transfer.
            if self.prefetch_plane is not None:
                self.prefetch_plane.preempt_inflight(worker, requeue=True)
            self._abort_spec_fetch(worker)
        self._start_fetch(worker, js, tid)

    def _start_fetch(self, worker: int, js: _JobState, tid: str) -> None:
        task = js.job.dfg.tasks[tid]
        assert task.model_id is not None
        mem = self.memories[worker]
        if not mem.can_host(task.model_id):
            # Capacity-blind scheduler put the task on a GPU that can
            # never execute its model: the dispatcher rejects and
            # re-routes it (handled as an event so the queue is not
            # mutated mid-scan).
            js.tasks[tid].bouncing = True
            self._post(
                self._now, "bounce", js, tid, worker,
                js.tasks[tid].generation,
            )
            return
        upcoming = [
            js2.job.dfg.tasks[t2].model_id for js2, t2 in self._queues[worker]
        ]
        res = mem.ensure(task.model_id, upcoming)
        if res is None:
            return  # cannot evict enough right now; retry on next dispatch
        fetch_s, _ = res
        # Pin for the duration of the fetch so another task's eviction
        # cannot displace the in-flight model; released by the bookkeeping
        # event at fetch completion (execution re-pins at start).
        mem.pin(task.model_id)
        js.tasks[tid].fetching = True
        if js.tasks[tid].was_miss:
            # The earlier fetch's model was evicted before the task could
            # start: a second demand miss against the same start.
            self._demand_refetches += 1
        js.tasks[tid].was_miss = True
        self._fetch_busy[worker] = True
        self._fetch_model[worker] = task.model_id
        self._fetch_spec[worker] = False
        self._fetch_preemptible[worker] = False
        self._fetch_started[worker] = self._now
        self._fetch_ends[worker] = self._now + fetch_s
        if self._health is not None:
            self._health.fetch_state(worker, self._now, True)
        if self._rec is not None:
            self._rec.emit(
                self._now, "fetch.start", worker=worker,
                model=task.model_id, fetch_kind="demand",
                bytes=mem.cached_size(task.model_id), dur=fetch_s,
                job=js.job.job_id, task=tid,
            )
        if self.prefetch_plane is not None:
            # Demand took over this task's model staging; its intent (if
            # still queued) is spent.
            self.prefetch_plane.consume(worker, js.job.job_id, tid)
        self._publish_cache(worker)  # also refreshes the intent bitmap
        self._post(
            self._now + fetch_s, "task_fetch_bookkeep", js, tid, worker,
            js.tasks[tid].generation,
        )
        self._post(
            self._now + fetch_s, "fetch_done", worker,
            self._fetch_token[worker],
        )

    # -- speculative prefetch (core/prefetch.py) ---------------------------------
    def _start_speculative_fetch(self, worker: int) -> None:
        plane = self.prefetch_plane
        assert plane is not None
        if plane.queue_depth(worker) == 0:
            return
        mem = self.memories[worker]
        peer_bits = 0
        if self._use_packed:
            # A peer this worker's view marks DEAD is no anti-herd
            # evidence: its frozen row may still advertise the model, but
            # nobody can be routed there.
            pv = self.sst.view_arrays(worker, self._now)
            mask = ~pv.dead
            mask[worker] = False
            bits = pv.bitmap[mask] | pv.intent[mask]
            if bits.size:
                peer_bits = int(np.bitwise_or.reduce(bits))
        else:
            for w2, row in enumerate(self.sst.view(worker, self._now)):
                if w2 != worker and row.liveness != DEAD:
                    peer_bits |= row.cache_bitmap | row.intent_bitmap
        intent, retry_at = plane.next_intent(
            worker, self._now, mem.has, peer_bits
        )
        if intent is None:
            self._schedule_poke(worker, retry_at)
            return
        res = mem.begin_prefetch(
            intent.model_id,
            upcoming_model_ids=[
                js.job.dfg.tasks[t].model_id for js, t in self._queues[worker]
            ],
            allow_evict=plane.config.evict_for_prefetch,
        )
        if res is None:
            # No room right now: park the intent and retry shortly.
            until = self._now + max(0.1, plane.config.herd_backoff_s)
            plane.stall_inflight(worker, until)
            self._schedule_poke(worker, until)
            return
        fetch_s, _ = res
        self._fetch_busy[worker] = True
        self._fetch_model[worker] = intent.model_id
        self._fetch_spec[worker] = True
        self._fetch_preemptible[worker] = True
        self._fetch_started[worker] = self._now
        self._fetch_ends[worker] = self._now + fetch_s
        if self._health is not None:
            self._health.fetch_state(worker, self._now, True)
        if self._rec is not None:
            self._rec.emit(
                self._now, "fetch.start", worker=worker,
                model=intent.model_id, fetch_kind="prefetch",
                bytes=mem.cached_size(intent.model_id), dur=fetch_s,
            )
        self._post(
            self._now + fetch_s, "fetch_done", worker,
            self._fetch_token[worker],
        )
        self._publish_cache(worker)  # also refreshes the intent bitmap

    def _promote_prefetch(self, worker: int, js: _JobState, tid: str) -> None:
        if self._rec is not None:
            self._rec.emit(
                self._now, "fetch.promote", worker=worker,
                model=self._fetch_model[worker], job=js.job.job_id,
                task=tid,
            )
        self._fetch_preemptible[worker] = False
        if self.prefetch_plane is not None:
            self.prefetch_plane.promote_inflight(worker)
        # The demanding task still waits for (the rest of) the transfer,
        # so account it as a demand miss — hit rates stay comparable with
        # the plane off; only fetches that *complete* before the task
        # needs the model convert to hits.
        run = js.tasks[tid]
        if not run.was_miss:
            run.was_miss = True
            self.memories[worker].stats.misses += 1

    def _abort_spec_fetch(self, worker: int) -> None:
        """Tear down the in-flight speculative transfer (the plane-side
        intent bookkeeping is the caller's job)."""
        mid = self._fetch_model[worker]
        assert mid is not None and self._fetch_spec[worker]
        self._fetch_token[worker] += 1  # invalidate the posted completion
        dur = self._fetch_ends[worker] - self._fetch_started[worker]
        frac = 0.0 if dur <= 0 else (self._now - self._fetch_started[worker]) / dur
        if self._rec is not None:
            self._rec.emit(
                self._now, "fetch.abort", worker=worker, model=mid,
                frac=frac, churn=False,
            )
        self.memories[worker].abort_prefetch(mid, frac)
        self._fetch_busy[worker] = False
        self._fetch_model[worker] = None
        self._fetch_spec[worker] = False
        self._fetch_preemptible[worker] = False
        if self._health is not None:
            self._health.fetch_state(worker, self._now, False)
        self._publish_cache(worker)  # also refreshes the intent bitmap

    def _schedule_poke(self, worker: int, at: Optional[float]) -> None:
        if at is None:
            return
        if self._poke_at[worker] is not None and self._poke_at[worker] <= at:
            return
        self._poke_at[worker] = at
        self._post(at, "prefetch_poke", worker)

    def _on_prefetch_poke(self, worker: int, t: float) -> None:
        if self._poke_at[worker] is not None and self._poke_at[worker] <= t:
            self._poke_at[worker] = None
        self._maybe_prefetch(worker)

    def _on_intent(self, worker: int, intents) -> None:
        assert self.prefetch_plane is not None
        if not self._serving(worker):
            return  # control message reached a corpse; dropped on the floor
        if self._rec is not None:
            self._rec.emit(
                self._now, "intent.admit", worker=worker, n=len(intents)
            )
        self.prefetch_plane.admit(worker, intents, self._now)
        self._publish_intent(worker)
        self._maybe_prefetch(worker)

    def _on_intent_cancel(self, worker: int, js: _JobState, task_id: str) -> None:
        assert self.prefetch_plane is not None
        if not self._up[worker]:
            return  # the plane state for this worker was already dropped
        if self._rec is not None:
            self._rec.emit(
                self._now, "intent.cancel", worker=worker,
                job=js.job.job_id, task=task_id,
            )
        aborted = self.prefetch_plane.cancel(
            worker, js.job.job_id, task_id, migrated=True
        )
        if (
            aborted is not None
            and self._fetch_busy[worker]
            and self._fetch_preemptible[worker]
            and self._fetch_model[worker] == aborted.model_id
        ):
            self._abort_spec_fetch(worker)
            self._maybe_prefetch(worker)
        else:
            self._publish_intent(worker)

    def _on_fetch_bookkeep(
        self, js: _JobState, tid: str, worker: int, gen: int
    ) -> None:
        run = js.tasks[tid]
        if gen != run.generation:
            return  # fetch torn down by churn; pin already released
        run.fetching = False
        task = js.job.dfg.tasks[tid]
        if task.model_id is not None:
            self.memories[worker].unpin(task.model_id)

    def _on_bounce(self, js: _JobState, tid: str, worker: int, gen: int) -> None:
        """Re-route a task whose assigned GPU can never host its model:
        ship it (and its already-arrived inputs) to the least-loaded
        *serving* worker with enough memory."""
        run = js.tasks[tid]
        if gen != run.generation:
            return  # superseded by churn recovery
        task = js.job.dfg.tasks[tid]
        assert task.model_id is not None
        feasible = [
            w
            for w in self.cluster.workers()
            if self._serving(w) and self.memories[w].can_host(task.model_id)
        ]
        if not feasible:
            if not self._fleet_can_serve(task.model_id):
                raise ValueError(
                    f"model {task.model_id} fits no current or future "
                    f"fleet member; the job can never finish"
                )
            # Capable workers exist (or will rejoin): hold the task and
            # retry once capacity is restored.
            self._post(self._now + 0.5, "bounce", js, tid, worker, gen)
            return
        self._bounces += 1
        if self._use_packed:
            ftcol = self.sst.view_arrays(worker, self._now).ft
            target = min(
                feasible,
                key=lambda w: (max(self._now, float(ftcol[w])), w),
            )
        else:
            sst = self.sst.view(worker, self._now)
            target = min(
                feasible,
                key=lambda w: (max(self._now, sst[w].ft_estimate_s), w),
            )
        run.bouncing = False
        self._queues[worker] = [
            (j, t) for j, t in self._queues[worker] if (j, t) != (js, tid)
        ]
        run.enqueued = False
        run.worker = None
        run.generation += 1
        assert js.adfg is not None
        js.adfg[tid] = target
        dfg = js.job.dfg
        delay = 0.0
        srcs = list(js.inputs_arrived[tid])
        for src in srcs:
            nbytes = (
                task.input_bytes if src == "" else dfg.tasks[src].output_bytes
            )
            delay = max(
                delay, self._xfer_time(nbytes, worker, target, register=True)
            )
        js.inputs_arrived[tid] = set()
        if self._rec is not None:
            self._rec.emit(
                self._now, "task.bounce", worker=worker,
                job=js.job.job_id, task=tid, to=target,
                gen=run.generation,
            )
        for src in srcs:
            self._post_input(
                self._now + delay, js, tid, src, target,
                run.generation, worker,
            )
        self._update_load(worker)
        self._dispatch(worker)

    def _migrate_intent(
        self,
        js: _JobState,
        task_id: str,
        old_w: int,
        new_w: int,
        sender: Optional[int] = None,
    ) -> None:
        """Alg. 2 moved a task: cancel the prefetch intent on the planned
        worker (a control message) and re-issue it on the new one (riding
        the input transfer that is about to ship there).  Control traffic
        crossing an open cut is lost."""
        assert self.prefetch_plane is not None
        if self._reachable(sender, old_w):
            ctrl = self._xfer_time(INTENT_WIRE_BYTES, sender, old_w)
            self._post(self._now + ctrl, "intent_cancel", old_w, js, task_id)
        if not self._reachable(sender, new_w):
            return
        intent = self.prefetch_plane.make_intent(
            js.job, task_id, new_w, self._now
        )
        if intent is not None:
            ctrl = self._xfer_time(INTENT_WIRE_BYTES, sender, new_w)
            self._post(self._now + ctrl, "intent", new_w, [intent])

    # -- fleet churn: crash / drain / join (membership plane) ----------------------
    def _on_churn(self, ev: ChurnEvent) -> None:
        if ev.kind == CRASH:
            self._do_crash(ev.worker)
        elif ev.kind == JOIN:
            self._do_join(ev.worker)
        elif ev.kind == DRAIN:
            self._do_drain(ev.worker)
        elif ev.kind == PARTITION:
            self._do_partition(ev)
        elif ev.kind == HEAL:
            self._do_heal()

    def _do_partition(self, ev: ChurnEvent) -> None:
        """The interconnect splits into ``ev.groups``: every worker stays
        up and keeps executing, but bulk and control messages between
        groups are lost (bulk ones fail over through the dead-letter
        timeout, exactly like sends to a corpse — the sender cannot tell
        silence from death).  Nobody's epoch bumps: no process died, so
        healed rows must win replica merges on version alone.  Workers in
        no listed group are fully isolated (unique singleton groups)."""
        assert ev.groups is not None
        self._churn_partitions += 1
        if self._rec is not None:
            self._rec.emit(
                self._now, "churn.partition",
                groups=repr([sorted(g) for g in ev.groups]),
            )
        # Negative ids for unlisted workers so they can never collide with
        # a group index.
        part = [-(w + 1) for w in range(self.cluster.n_workers)]
        for gi, group in enumerate(ev.groups):
            for w in group:
                part[w] = gi
        self._partition = part
        self.sst.set_partition(part, self._now)

    def _do_heal(self) -> None:
        """The cut closes.  Nothing is replayed: gossip reconverges on its
        own (full-row newest-version merges), and work stranded behind the
        cut is re-driven by the retry/dead-letter machinery."""
        if self._partition is None:
            return
        self._churn_heals += 1
        if self._rec is not None:
            self._rec.emit(self._now, "churn.heal")
        self._partition = None
        self.sst.set_partition(None, self._now)

    def _do_crash(self, w: int) -> None:
        """The worker vanishes: running task, queue, in-flight fetch, cache
        contents, and gossip replica are all lost.  Nothing is announced —
        peers only find out when the heartbeat lease expires in their own
        views, so the work it held is only *recovered* after the detection
        delay (no oracle); until then peers may keep routing work here,
        which the dead-letter path in ``_on_input`` fails over after the
        connection timeout."""
        if not self._up[w]:
            return
        self._churn_crashes += 1
        if self._rec is not None:
            self._rec.emit(self._now, "churn.crash", worker=w)
        self._up[w] = False
        self._draining[w] = False
        self._session[w] += 1  # voids the gossip/heartbeat/publish chains
        self._abort_worker_fetch(w, churn=True)
        if self.prefetch_plane is not None:
            for intent in self.prefetch_plane.drop_worker(w):
                self._orphaned_intents[intent.key()] = intent
        self.memories[w].reset(graceful=False)
        self._poke_at[w] = None
        self._gpu_busy[w] = None
        self._queues[w] = []
        # The attempts physically ON the worker die with it *now*: their
        # generations bump immediately so the already-posted task_done /
        # bookkeep / bounce events are void (no ghost completions from a
        # corpse).  Re-placement still waits for detection; work whose
        # inputs are merely en route stays un-reset so the sender's
        # (faster) dead-letter timeout can fail it over first.
        snapshot = self._strand_snapshot(w)
        delay = (
            self.lease.detection_delay_s if self.lease is not None else 0.0
        )
        self._post(self._now + delay, "recover", (w, snapshot))

    def _do_drain(self, w: int) -> None:
        """Graceful departure: advertise ``draining`` (peers stop placing
        work the moment the flag reaches their view), re-route queued
        tasks, abort the in-flight fetch, finish the running task, then
        leave."""
        if not self._serving(w):
            return
        self._churn_drains += 1
        if self._rec is not None:
            self._rec.emit(self._now, "churn.drain", worker=w)
        self._draining[w] = True
        self.sst.set_draining(w, True, self._now)
        self._abort_worker_fetch(w, churn=True)
        if self.prefetch_plane is not None:
            for intent in self.prefetch_plane.drop_worker(w):
                self._orphaned_intents[intent.key()] = intent
            self._publish_intent(w)
        queued = list(self._queues[w])
        self._queues[w] = []
        for js, tid in queued:
            self._reroute(js, tid, from_worker=w)
        self._update_load(w)
        if self._gpu_busy[w] is None and not self._fetch_busy[w]:
            self._complete_drain(w)

    def _complete_drain(self, w: int) -> None:
        """The drained worker's running task finished: flush still-needed
        task outputs to an heir (graceful departure has the time to
        upload its state — that is the point of draining over crashing),
        then leave the fleet."""
        heir = None
        n = self.cluster.n_workers
        for d in range(n):
            cand = (w + 1 + d) % n
            if self._serving(cand) and self._reachable(w, cand):
                heir = cand  # next serving worker the drainer can reach
                break
        if heir is not None:
            self._open_jobs = [
                js for js in self._open_jobs if js.finish_time is None
            ]
            for js in self._open_jobs:
                for tid, run in js.tasks.items():
                    if (
                        run.finished is not None
                        and run.worker == w
                        and any(
                            js.tasks[s].finished is None
                            for s in js.job.dfg.succs[tid]
                        )
                    ):
                        run.worker = heir
                        run.session = self._session[heir]
        self._up[w] = False
        self._session[w] += 1
        self.memories[w].reset(graceful=True)
        self._poke_at[w] = None

    def _do_join(self, w: int) -> None:
        """The worker (re)enters with a cold cache and a fresh gossip
        incarnation; its SST view is rebuilt by anti-entropy full-sync
        from the first peers to contact it (``GossipPlane.join``).  A
        join that lands while a drain is still finishing its running task
        cancels the drain (the worker never actually left) instead of
        being dropped — a drop would remove the worker forever."""
        if self._up[w]:
            if self._draining[w]:
                self._draining[w] = False
                self.sst.set_draining(w, False, self._now)
                self._churn_joins += 1
                self._dispatch(w)
            return
        self._churn_joins += 1
        if self._rec is not None:
            self._rec.emit(self._now, "churn.join", worker=w)
        self._up[w] = True
        self._draining[w] = False
        self._session[w] += 1
        s = self._session[w]
        self.sst.join(w, self._now)
        self.sst.update_cache(w, 0, self.cluster.gpu_capacity(w), self._now)
        if self.lease is not None:
            self.sst.heartbeat(w, self._now)
            self._post(
                self._now + self.lease.heartbeat_period_s, "heartbeat", w, s
            )
        self._update_load(w)
        if self.gossip is not None:
            self._post(self._now + self.gossip.period_s, "gossip", w, s)
        else:
            self._post(self._now + self.sst.push_interval_s, "sst_load", w, s)
            self._post(
                self._now + self.sst.cache_push_interval_s, "sst_cache", w, s
            )

    def _abort_worker_fetch(self, w: int, churn: bool = False) -> None:
        """Tear down whatever is on the fetch pipe: speculative transfers
        go through the wasted-prefetch ledger, demand transfers release
        the owning (now dead/re-routed) task's fetch-pin and charge the
        partial bytes as churn waste."""
        if not self._fetch_busy[w]:
            return
        mid = self._fetch_model[w]
        assert mid is not None
        dur = self._fetch_ends[w] - self._fetch_started[w]
        frac = (
            0.0
            if dur <= 0
            else min(1.0, (self._now - self._fetch_started[w]) / dur)
        )
        if self._rec is not None:
            self._rec.emit(
                self._now, "fetch.abort", worker=w, model=mid,
                frac=frac, churn=churn,
            )
        mem = self.memories[w]
        if self._fetch_spec[w]:
            mem.abort_prefetch(mid, frac)
            if churn:
                mem.stats.churn_wasted_bytes += mem.cached_size(mid) * frac
        else:
            mem.abort_fetch(mid, frac)
        self._fetch_token[w] += 1  # invalidate the posted completion
        self._fetch_busy[w] = False
        self._fetch_model[w] = None
        self._fetch_spec[w] = False
        self._fetch_preemptible[w] = False
        if self._health is not None:
            self._health.fetch_state(w, self._now, False)

    # -- task recovery --------------------------------------------------------------
    def _strand_snapshot(
        self, w: int
    ) -> List[Tuple[_JobState, str, int, bool]]:
        """Everything the crashing worker strands, as (job, task,
        generation, needs_reset) tuples.

        Attempts physically on the worker (enqueued / fetching / running)
        are **reset here and now** — the crash voids them, so a pending
        ``task_done`` can never complete a task on a corpse — and only
        their re-placement waits for detection (``needs_reset=False``).
        Floating tasks whose inputs are en route, and finished producers
        whose outputs lived here, are left untouched until detection
        (``needs_reset=True``): the former so the sender's faster
        dead-letter timeout can fail them over first, the latter because
        whether a dead output is still *needed* is best judged at
        detection time.  Any pair whose generation moved on in between is
        skipped by the recovery event."""
        self._open_jobs = [
            js for js in self._open_jobs if js.finish_time is None
        ]
        snap: List[Tuple[_JobState, str, int, bool]] = []
        for js in self._open_jobs:
            assign = js.adfg.assignment if js.adfg is not None else {}
            for tid, run in js.tasks.items():
                if run.worker == w and run.finished is None:
                    self._reset_task(js, tid)
                    snap.append((js, tid, run.generation, False))
                elif run.worker == w or (
                    run.finished is None
                    and run.worker is None
                    and assign.get(tid) == w
                ):
                    snap.append((js, tid, run.generation, True))
        return snap

    def _on_recover(
        self, payload: Tuple[int, List[Tuple[_JobState, str, int]]]
    ) -> None:
        """Detection-time recovery: re-route the stranded unfinished work
        and re-run finished producers whose outputs died and are *still*
        needed (transitively: a producer is needed if some successor is
        unfinished and missing its output, or is itself being
        recovered)."""
        w, snapshot = payload
        by_job: Dict[int, Tuple[_JobState, List[Tuple[str, int, bool]]]] = {}
        for js, tid, gen, needs_reset in snapshot:
            by_job.setdefault(js.job.job_id, (js, []))[1].append(
                (tid, gen, needs_reset)
            )
        for js, pairs in by_job.values():
            if js.finish_time is not None:
                continue
            assign = js.adfg.assignment if js.adfg is not None else {}
            lost: List[str] = []          # crash-reset at crash time
            floating: List[str] = []      # still stranded, reset here
            dead_outputs = set()
            for tid, gen, needs_reset in pairs:
                run = js.tasks[tid]
                if run.generation != gen:
                    continue  # something already failed this attempt over
                if not needs_reset:
                    if (
                        run.enqueued
                        or run.started is not None
                        or run.finished is not None
                    ):
                        # Alg. 2 already re-staged the crash-voided
                        # attempt (same generation) on a live worker
                        # during the detection window; re-shipping would
                        # split its inputs across two targets.
                        continue
                    lost.append(tid)
                elif run.finished is not None:
                    dead_outputs.add(tid)
                elif run.worker == w or (
                    run.worker is None and assign.get(tid) == w
                ):
                    floating.append(tid)
                # else: Alg. 2 adjusted the still-floating task off the
                # corpse in the meantime; it is no longer stranded.
            dfg = js.job.dfg
            needed = set(lost) | set(floating)
            reexec: List[str] = []
            for tid in reversed(dfg.topo_order):
                if tid not in dead_outputs:
                    continue
                for s in dfg.succs[tid]:
                    rs = js.tasks[s]
                    if s in needed or (
                        rs.finished is None
                        and tid not in js.inputs_arrived[s]
                    ):
                        reexec.append(tid)
                        needed.add(tid)
                        break
            # Reset what was not already voided at crash time (generation
            # bumps void in-flight events), then ship producers before
            # consumers.
            for tid in reexec + floating:
                self._reset_task(js, tid)
            order = {t: i for i, t in enumerate(dfg.topo_order)}
            for tid in sorted(
                reexec + floating + lost, key=lambda t: order[t]
            ):
                self._ship_inputs(js, tid)

    def _on_dead_letter(
        self,
        js: _JobState,
        tid: str,
        src: str,
        gen: int,
        src_worker: Optional[int] = None,
    ) -> None:
        """The connection timeout on one input shipment to a dead (or
        unreachable) worker fired.  Three same-generation outcomes exist,
        because detection-time recovery re-stages crash-voided attempts
        without a fresh generation while stale-assignment shipments may
        still be in flight:

        * the attempt has started (or this input already landed via a
          duplicate shipment) — the timed-out copy is moot;
        * the attempt is enqueued on a (necessarily serving) worker the
          sender can reach, but this input is genuinely missing — re-ship
          just this input there, or the task waits forever;
        * the attempt is still unstaged (or re-staged somewhere the
          sender cannot reach) — full dead-letter failover on the
          sender's side of the cut."""
        run = js.tasks[tid]
        if gen != run.generation or run.finished is not None:
            return
        if run.started is not None or src in js.inputs_arrived[tid]:
            return  # inputs complete / duplicate shipment
        if (
            run.enqueued
            and run.worker is not None
            and self._reachable(src_worker, run.worker)
        ):
            task = js.job.dfg.tasks[tid]
            nbytes = (
                task.input_bytes
                if src == ""
                else js.job.dfg.tasks[src].output_bytes
            )
            delay = self._xfer_time(
                nbytes, src_worker, run.worker, register=True
            )
            self._post_input(
                self._now + delay, js, tid, src, run.worker, gen,
                src_worker,
            )
            return
        if self._rec is not None:
            self._rec.emit(
                self._now, "task.dead_letter",
                worker=src_worker if src_worker is not None else -1,
                job=js.job.job_id, task=tid, src=src, gen=gen,
            )
        self._reroute(js, tid, from_worker=src_worker)

    def _reset_task(self, js: _JobState, tid: str) -> None:
        run = js.tasks[tid]
        if run.enqueued and run.worker is not None:
            # Pull the attempt out of its queue: a stale entry would wake
            # up when the *new* attempt's inputs refill inputs_arrived and
            # start the task twice.
            self._queues[run.worker] = [
                (j, t)
                for j, t in self._queues[run.worker]
                if (j, t) != (js, tid)
            ]
        if self._rec is not None:
            self._rec.emit(
                self._now, "task.recover",
                worker=run.worker if run.worker is not None else -1,
                job=js.job.job_id, task=tid, gen=run.generation + 1,
                had_output=run.finished is not None,
            )
        if run.finished is not None:
            self._outputs_recovered += 1
        else:
            self._tasks_rescued += 1
            if run.was_miss and run.started is None:
                # The fetch's demand miss was charged but the attempt
                # never started: the chaos checker's hit/miss balance
                # needs the orphaned charge on the books.
                self._lost_miss_attempts += 1
            if run.started is not None and run.worker is not None:
                # GPU cycles the lost attempt burned still happened.
                self._busy_time[run.worker] += self._now - run.started
        run.generation += 1
        run.finished = None
        run.started = None
        run.enqueued = False
        run.fetching = False
        run.bouncing = False
        run.was_miss = False
        run.worker = None
        js.inputs_arrived[tid] = set()
        if not self.scheduler.plans_at_arrival and js.adfg is not None:
            # JIT re-assigns when the last producer (re-)completes.
            js.adfg.assignment.pop(tid, None)

    def _reroute(
        self, js: _JobState, tid: str, from_worker: Optional[int] = None
    ) -> None:
        """Dead-letter recovery for one task: void the old attempt and
        re-stage its inputs on a serving worker — on ``from_worker``'s
        side of an open cut, when the failover is partition-driven."""
        self._reset_task(js, tid)
        self._ship_inputs(js, tid, from_worker=from_worker)

    def _output_alive(self, run: _TaskRun) -> bool:
        """Whether a finished task's output can still be read: its worker
        must be up *in the incarnation that produced it* — a crash wipes
        outputs even when the worker rejoins before anyone re-reads."""
        return (
            run.worker is not None
            and self._up[run.worker]
            and run.session == self._session[run.worker]
        )

    def _reexec_producer(
        self, js: _JobState, tid: str, from_worker: Optional[int] = None
    ) -> None:
        run = js.tasks[tid]
        if run.finished is None:
            return  # already being recovered; its completion will ship
        self._reset_task(js, tid)
        self._ship_inputs(js, tid, from_worker=from_worker)

    def _fleet_can_serve(self, model_id: Optional[int]) -> bool:
        """Whether a worker able to host ``model_id`` is serving now or
        will ever (re)join per the churn schedule.  Retry loops consult
        this so a permanently lost capability raises a diagnosable error
        instead of re-posting retries forever (``run()`` would never
        return: the stuck job keeps the periodic chains alive)."""
        for w in self.cluster.workers():
            if model_id is not None and not self.memories[w].can_host(
                model_id
            ):
                continue
            if self._serving(w):
                return True
        for ev in self.churn:
            if ev.kind == JOIN and ev.time >= self._now:
                if model_id is None or self.memories[ev.worker].can_host(
                    model_id
                ):
                    return True
        return False

    def _recovery_inputs(
        self, js: _JobState, tid: str
    ) -> Tuple[Dict[str, int], Dict[str, float]]:
        """Where the task's already-available inputs live (and their
        sizes): surviving finished-producer outputs, or the job's entry
        payload at a live origin.  Inputs whose producers are being
        re-executed are omitted — their future location is unknown."""
        dfg = js.job.dfg
        locs: Dict[str, int] = {}
        sizes: Dict[str, float] = {}
        preds = dfg.preds[tid]
        if not preds:
            origin = self._live_origin(js.origin)
            if origin is not None:
                locs[""] = origin
                sizes[""] = dfg.tasks[tid].input_bytes
            return locs, sizes
        for p in preds:
            rp = js.tasks[p]
            if (
                rp.finished is not None
                and rp.worker is not None
                and self._output_alive(rp)
            ):
                locs[p] = rp.worker
                sizes[p] = dfg.tasks[p].output_bytes
        return locs, sizes

    def _recovery_target(
        self, js: _JobState, tid: str, from_worker: Optional[int] = None
    ) -> Optional[int]:
        """Serving worker to re-home a stranded task on, restricted to
        ``from_worker``'s side of an open cut.  The scheduler's
        ``select_recovery_worker`` hook prices candidates with the full
        Navigator placement cost (queue drain, concrete input paths,
        Eq. 2 model cost, runtime, membership risk); schedulers without
        the hook fall back to the dispatcher-level greedy rule —
        earliest start pricing the model fetch from the reader replica's
        published cache bitmaps.  Cache awareness matters under churn: a
        crash of a cache-hot worker would otherwise dump its whole
        working set onto whichever heir happened to be least loaded,
        serializing a refetch storm on one PCIe pipe."""
        task = js.job.dfg.tasks[tid]
        mid = task.model_id
        cands = [
            w
            for w in self._live_workers()
            if (mid is None or self.memories[w].can_host(mid))
            and self._reachable(from_worker, w)
        ]
        if not cands:
            return None
        reader = None
        if from_worker is not None and self._serving(from_worker):
            reader = from_worker  # the failing-over sender reads its own view
        if reader is None:
            reader = self._live_origin(js.origin)
        if reader is None or not self._reachable(from_worker, reader):
            reader = cands[0]
        sstv = self.sst.view(reader, self._now)
        locs, sizes = self._recovery_inputs(js, tid)
        choice = self.scheduler.select_recovery_worker(
            js.job, tid, self._now, sstv, locs, sizes, cands
        )
        if choice is not None:
            return choice

        def est(w: int) -> Tuple[float, int]:
            start = max(self._now, sstv[w].ft_estimate_s)
            if mid is not None and not (sstv[w].cache_bitmap >> mid) & 1:
                start += self.profiles.td_model(mid)
            return (start, w)

        return min(cands, key=est)

    def _ship_inputs(
        self, js: _JobState, tid: str, from_worker: Optional[int] = None
    ) -> None:
        """(Re-)stage a recovered task: re-run producers whose outputs
        died (or sit across an open cut — the recovering side cannot tell
        the difference), pick a serving target on ``from_worker``'s side,
        re-home its prefetch intent, and ship whatever inputs are already
        available; the rest arrive as their producers (re-)complete."""
        run = js.tasks[tid]
        dfg = js.job.dfg
        preds = list(dfg.preds[tid])
        for p in preds:
            rp = js.tasks[p]
            if rp.finished is not None and (
                not self._output_alive(rp)
                or not self._reachable(from_worker, rp.worker)
            ):
                # Groups are equivalence classes, so an output reachable
                # from ``from_worker`` is reachable from any target picked
                # on the same side.
                self._reexec_producer(js, p, from_worker=from_worker)
        if (
            not self.scheduler.plans_at_arrival
            and preds
            and not all(js.tasks[p].finished is not None for p in preds)
        ):
            return  # JIT re-assigns when the last producer (re-)completes
        target = self._recovery_target(js, tid, from_worker=from_worker)
        if target is None:
            mid = dfg.tasks[tid].model_id
            if not self._fleet_can_serve(mid):
                raise ValueError(
                    f"task {tid!r} (model {mid}) fits no current or "
                    f"future fleet member; the job can never finish"
                )
            # A capable worker will (re)join — or the cut will heal
            # (validate_schedule guarantees every partition heals); retry
            # then, without the cut-side restriction (by the retry the
            # failing-over sender's identity no longer matters).
            self._post(
                self._now + 0.5, "reroute_retry", js, tid, run.generation,
                from_worker,
            )
            return
        assert js.adfg is not None
        js.adfg[tid] = target
        task = dfg.tasks[tid]
        if self.prefetch_plane is not None and task.model_id is not None:
            ctrl = self._xfer_time(INTENT_WIRE_BYTES, from_worker, target)
            orphan = self._orphaned_intents.pop((js.job.job_id, tid), None)
            if orphan is not None:
                intent = self.prefetch_plane.rehome(orphan, target, self._now)
            else:
                intent = self.prefetch_plane.make_intent(
                    js.job, tid, target, self._now
                )
            if intent is not None:
                self._post(self._now + ctrl, "intent", target, [intent])
        if not preds:
            origin = self._entry_origin(js, target)
            delay = (
                0.0
                if target == origin
                else self._xfer_time(
                    task.input_bytes, origin, target, register=True
                )
            )
            self._post_input(
                self._now + delay, js, tid, "", target,
                run.generation, origin,
            )
            return
        ready = [p for p in preds if js.tasks[p].finished is not None]
        if not ready:
            return  # everything arrives via _route_successors later
        delay = 0.0
        for p in ready:
            if js.tasks[p].worker != target:
                delay = max(
                    delay,
                    self._xfer_time(
                        dfg.tasks[p].output_bytes, js.tasks[p].worker,
                        target, register=True,
                    ),
                )
        for p in ready:
            self._post_input(
                self._now + delay, js, tid, p, target,
                run.generation, js.tasks[p].worker,
            )

    def _entry_origin(self, js: _JobState, target: int) -> int:
        """A live holder of the job's entry payload the ``target`` can
        reach: the preferred origin when possible, else the nearest
        serving same-side replica, else the target itself (whole side
        gone except the target)."""
        n = self.cluster.n_workers
        for d in range(n):
            w = (js.origin + d) % n
            if self._serving(w) and self._reachable(target, w):
                return w
        return target

    def _on_reroute_retry(
        self,
        js: _JobState,
        tid: str,
        gen: int,
        from_worker: Optional[int] = None,
    ) -> None:
        run = js.tasks[tid]
        if gen != run.generation or run.finished is not None:
            return
        # Re-resolve the cut side at fire time: a healed partition lifts
        # the restriction because ``_reachable`` consults current state.
        self._ship_inputs(js, tid, from_worker=from_worker)

    # -- gossip plane (decentralized SST, §5.2) ------------------------------------
    def _on_gossip(self, worker: int, session: int) -> None:
        """One gossip round: the plane computes the diff messages (drops
        already sampled); delivery is delayed by the network model, so a
        reader's view lags by period + wire time.  A dead worker's chain
        dies with it (stale session); a join starts a fresh chain."""
        assert self.gossip is not None and isinstance(self.sst, GossipPlane)
        if session != self._session[worker] or not self._up[worker]:
            return
        if self._health is not None:
            self._refresh_health_digest(worker)
        for peer, updates, nbytes in self.sst.exchange(worker, self._now):
            delay = self._xfer_time(nbytes, worker, peer)
            if self._rec is not None:
                self._rec.emit(
                    self._now, "gossip.exchange", worker=worker,
                    peer=peer, bytes=nbytes, n=len(updates),
                )
            self._post(
                self._now + delay, "gossip_rx", peer, updates, worker
            )
        self._post(self._now + self.gossip.period_s, "gossip", worker, session)

    def _on_heartbeat(self, worker: int, session: int) -> None:
        if session != self._session[worker] or not self._up[worker]:
            return
        assert self.lease is not None
        self.sst.heartbeat(worker, self._now)
        self._post(
            self._now + self.lease.heartbeat_period_s, "heartbeat",
            worker, session,
        )

    # -- state publication ---------------------------------------------------------
    def _update_load(self, worker: int) -> None:
        """Recompute FT(w) = now + remaining work on the queue (§4.1)."""
        if not self._up[worker]:
            return  # a corpse publishes nothing; its row freezes
        ft = self._now
        busy = self._gpu_busy[worker]
        if busy is not None:
            js, tid = busy
            task = js.job.dfg.tasks[tid]
            # remaining = expected runtime (we don't know the noise draw)
            elapsed = self._now - (js.tasks[tid].started or self._now)
            ft += max(0.0, self.profiles.runtime(task, worker) - elapsed)
        for js, tid in self._queues[worker]:
            ft += self.profiles.runtime(js.job.dfg.tasks[tid], worker)
        self.sst.update_load(worker, ft, self._now)
        if self._health is not None:
            self._health.sample_queue(
                worker, self._now,
                len(self._queues[worker]) + (1 if busy is not None else 0),
            )

    def _publish_cache(self, worker: int) -> None:
        if not self._up[worker]:
            return
        mem = self.memories[worker]
        if self._health is not None:
            self._health.sample_memory(
                worker, self._now,
                (mem.used_bytes + mem.exec_reserved_bytes)
                / mem.capacity_bytes if mem.capacity_bytes > 0 else 0.0,
                mem.stats.evictions,
            )
        # Expected-completion advertisement: the model on the pipe and its
        # absolute ETA ride every cache publication, so remote planners can
        # discount an in-flight fetch by its *remaining* fraction instead
        # of a confidence constant.
        fm, eta = -1, 0.0
        if self._fetch_busy[worker] and self._fetch_model[worker] is not None:
            fm = self._fetch_model[worker]
            eta = self._fetch_ends[worker]
        if self.prefetch_plane is None:
            self.sst.update_cache(
                worker, mem.bitmap, mem.free_bytes, self._now,
                fetch_model_id=fm, fetch_eta_s=eta,
            )
            return
        # Under the prefetch plane the advertisement is honest about the
        # pipe: a model still in flight is not usable residency (tasks
        # wait for fetch completion), so it moves from the cache bitmap to
        # the intent bitmap, where the planner prices it at the discounted
        # remainder of the fetch.  AVC counts undemanded speculative
        # contents as available — they are the cheapest victims.
        bm = mem.bitmap
        if fm >= 0:
            bm &= ~(1 << fm)
        self.sst.update_cache(
            worker, bm, mem.available_bytes, self._now,
            fetch_model_id=fm, fetch_eta_s=eta,
        )
        self.sst.update_intent(
            worker,
            mem.bitmap | self.prefetch_plane.advertised_bits(worker),
            self._now,
        )

    def _refresh_health_digest(self, worker: int) -> None:
        """Stamp the owner's four-field health digest onto its SST row
        right before a publication/gossip round (wire lanes 12–15), so
        the replicated view's staleness is bounded by the dissemination
        period — the same discipline as the load/cache lanes."""
        assert self._health is not None
        d = self._health.digest(worker, self._now)
        self.sst.update_health(
            worker, d.queue_depth, d.mem_occupancy, d.fetch_util,
            d.p99_latency_s, self._now,
        )

    def _publish_intent(self, worker: int) -> None:
        if self.prefetch_plane is None or not self._up[worker]:
            return
        mem = self.memories[worker]
        self.sst.update_intent(
            worker,
            mem.bitmap | self.prefetch_plane.advertised_bits(worker),
            self._now,
        )
