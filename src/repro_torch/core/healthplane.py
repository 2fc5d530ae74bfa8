"""Live cluster health plane (DESIGN.md §3.5), copied from the JAX
package so that the port stands alone.

The flight recorder answers questions *after* a run from a raw
trace; a production fleet needs to answer them *while* running.  This
module is the online half of the observability plane:

* :class:`QuantileSketch` — a deterministic, mergeable t-digest-style
  quantile sketch.  Centroid compression uses the standard arcsine
  scale function but every step (buffering, sorting, merging) is pure
  deterministic float arithmetic: the same observation sequence always
  yields the same centroids, and merging per-worker sketches in worker
  order composes latency distributions fleet-wide without collecting
  raw samples.  Property tests pin the rank error against exact
  quantiles.

* :class:`HealthMonitor` — streaming windowed time-series per worker
  (queue depth, GPU-memory occupancy, fetch-pipe utilization,
  per-uplink bytes in flight), sampled by the engines on the events
  they already process.  Windows are fixed-size and keyed to simulated
  time (``floor(t / window_s)``), so two runs of the same seed produce
  byte-identical series — the chaos suite's determinism oracle extends
  to the health plane.

* **Health digests** — a four-field summary (queue depth, memory
  occupancy, fetch utilization, local task-latency p99) refreshed onto
  the owner's SST row right before each publication/gossip round
  (``SSTRow`` wire lanes 12–15), so every worker holds a
  staleness-bounded view of fleet health with no oracle — the same
  metadata-plane discipline as load/cache/membership.

* **Online detectors** — straggler, queue-buildup, memory-thrash and
  spine-saturation detectors run inside the sampling hooks, emit typed
  ``health.*`` events into the flight recorder (when attached) and
  accumulate a per-kind ledger surfaced by
  ``SimReport.health_summary()``.

* **Cost-model calibration** — :func:`calibrate` joins each task's
  placement-provenance Eq. 2 cost vector against its measured
  span breakdown and maintains per-component residual statistics
  (queue, input-transfer, model-fetch, runtime), exported through the
  MetricsRegistry and surfaced by ``bench_trace.py --calibration``.

Zero overhead when off: like the flight recorder, the engines guard
every sampling site with ``if self._health is not None`` — the CI
``trace-smoke`` tracemalloc guard covers this file too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

HEALTH_SCHEMA_VERSION = 1

#: Typed detector event kinds (also the trace-event kinds they emit).
STRAGGLER = "health.straggler"
QUEUE_BUILDUP = "health.queue_buildup"
MEMORY_THRASH = "health.memory_thrash"
SPINE_SATURATION = "health.spine_saturation"

DETECTOR_KINDS = (STRAGGLER, QUEUE_BUILDUP, MEMORY_THRASH, SPINE_SATURATION)


# --------------------------------------------------------------------------
# Deterministic mergeable quantile sketch
# --------------------------------------------------------------------------
class QuantileSketch:
    """Merging t-digest with the arcsine scale function, deterministic by
    construction.

    Observations buffer until ``4 * compression`` points, then compress
    into weighted centroids whose width shrinks toward the tails
    (k(q) = c/2π · asin(2q−1)); ``merge`` feeds another sketch's
    centroids through the same pass.  All arithmetic is plain float ops
    over sorted sequences — no randomness, no hashing — so reruns and
    replicas agree bit-for-bit, and the chaos byte-diff can cover
    health summaries.  Rank error is O(1/compression) at the tails
    (property-tested against exact quantiles in
    ``tests/test_healthplane.py``).
    """

    __slots__ = ("compression", "_means", "_weights", "_buf",
                 "count", "sum", "min", "max")

    def __init__(self, compression: int = 100) -> None:
        if compression < 20:
            raise ValueError("compression < 20 gives useless accuracy")
        self.compression = compression
        self._means: List[float] = []
        self._weights: List[float] = []
        self._buf: List[Tuple[float, float]] = []
        self.count = 0.0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    # -- scale function -----------------------------------------------------
    def _k(self, q: float) -> float:
        q = min(1.0, max(0.0, q))
        return self.compression / (2.0 * math.pi) * math.asin(2.0 * q - 1.0)

    def _k_inv(self, k: float) -> float:
        return (math.sin(2.0 * math.pi * k / self.compression) + 1.0) / 2.0

    # -- ingestion ----------------------------------------------------------
    def add(self, x: float, w: float = 1.0) -> None:
        if w <= 0:
            return
        self._buf.append((float(x), float(w)))
        self.count += w
        self.sum += x * w
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._buf) >= 4 * self.compression:
            self._compress()

    def merge(self, other: "QuantileSketch") -> None:
        """Fold ``other`` into this sketch (deterministic given call
        order; per-worker sketches merged in worker order compose the
        fleet distribution)."""
        other._compress()
        for m, w in zip(other._means, other._weights):
            self._buf.append((m, w))
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        self._compress()

    def _compress(self) -> None:
        if not self._buf:
            return
        pts = sorted(
            list(zip(self._means, self._weights)) + self._buf
        )
        self._buf = []
        total = sum(w for _, w in pts)
        means: List[float] = []
        weights: List[float] = []
        cur_m, cur_w = pts[0]
        w_done = 0.0  # weight fully emitted so far
        limit = self._k_inv(self._k(0.0) + 1.0) * total
        for m, w in pts[1:]:
            if w_done + cur_w + w <= limit:
                cur_m += (m - cur_m) * (w / (cur_w + w))
                cur_w += w
            else:
                means.append(cur_m)
                weights.append(cur_w)
                w_done += cur_w
                limit = self._k_inv(self._k(w_done / total) + 1.0) * total
                cur_m, cur_w = m, w
        means.append(cur_m)
        weights.append(cur_w)
        self._means = means
        self._weights = weights

    # -- queries -------------------------------------------------------------
    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile by midpoint interpolation across
        centroids, anchored at the exact min/max."""
        self._compress()
        if not self._means:
            return 0.0
        if len(self._means) == 1:
            return self._means[0]
        q = min(1.0, max(0.0, q))
        target = q * self.count
        # Cumulative midpoints: centroid i covers rank cum + w_i/2.
        cum = 0.0
        prev_pos, prev_val = 0.0, self.min
        for m, w in zip(self._means, self._weights):
            pos = cum + w / 2.0
            if target <= pos:
                span = pos - prev_pos
                frac = 0.0 if span <= 0 else (target - prev_pos) / span
                return prev_val + (m - prev_val) * frac
            cum += w
            prev_pos, prev_val = pos, m
        span = self.count - prev_pos
        frac = 0.0 if span <= 0 else (target - prev_pos) / span
        return prev_val + (self.max - prev_val) * frac

    def centroids(self) -> Tuple[Tuple[float, float], ...]:
        """Flushed (mean, weight) pairs — the determinism fingerprint."""
        self._compress()
        return tuple(zip(self._means, self._weights))

    def as_dict(self) -> Dict[str, float]:
        if self.count <= 0:
            return {"count": 0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {
            "count": int(self.count),
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
        }


# --------------------------------------------------------------------------
# Streaming windowed time-series
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Window:
    """One fixed-size aggregation window (index = floor(t / window_s))."""

    index: int
    count: int = 0
    sum: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    last: float = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.last = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class WindowedSeries:
    """Bounded ring of :class:`Window` aggregates for one signal.

    Windows are keyed to simulated time, never wall clock, and samples
    arrive in non-decreasing ``t`` from a deterministic event loop —
    so the series is a pure function of the run."""

    __slots__ = ("window_s", "max_windows", "windows")

    def __init__(self, window_s: float, max_windows: int) -> None:
        self.window_s = window_s
        self.max_windows = max_windows
        self.windows: List[Window] = []

    def observe(self, t: float, v: float) -> Window:
        idx = int(t // self.window_s)
        if not self.windows or self.windows[-1].index != idx:
            self.windows.append(Window(idx))
            if len(self.windows) > self.max_windows:
                del self.windows[0]
        w = self.windows[-1]
        w.observe(v)
        return w

    @property
    def last(self) -> Optional[Window]:
        return self.windows[-1] if self.windows else None

    def overall_max(self) -> float:
        return max((w.max for w in self.windows), default=0.0)

    def overall_mean(self) -> float:
        n = sum(w.count for w in self.windows)
        return sum(w.sum for w in self.windows) / n if n else 0.0


class _PipeUtilization:
    """Busy-time integrator for the per-worker fetch pipe: state changes
    (busy/idle) split into per-window busy seconds."""

    __slots__ = ("window_s", "max_windows", "_busy", "_since", "_windows")

    def __init__(self, window_s: float, max_windows: int) -> None:
        self.window_s = window_s
        self.max_windows = max_windows
        self._busy = False
        self._since = 0.0
        self._windows: List[Tuple[int, float]] = []  # (index, busy seconds)

    def _credit(self, t0: float, t1: float) -> None:
        while t0 < t1 - 1e-12:
            idx = int(t0 // self.window_s)
            edge = min(t1, (idx + 1) * self.window_s)
            if self._windows and self._windows[-1][0] == idx:
                self._windows[-1] = (idx, self._windows[-1][1] + (edge - t0))
            else:
                self._windows.append((idx, edge - t0))
                if len(self._windows) > self.max_windows:
                    del self._windows[0]
            t0 = edge

    def update(self, t: float, busy: bool) -> None:
        if self._busy:
            self._credit(self._since, t)
        self._busy = busy
        self._since = t

    def utilization(self, now: float) -> float:
        """Mean busy fraction over the retained windows (open busy
        interval credited up to ``now``)."""
        if self._busy:
            self._credit(self._since, now)
            self._since = now
        if not self._windows:
            return 0.0
        horizon = len(self._windows) * self.window_s
        return min(1.0, sum(b for _, b in self._windows) / horizon)


# --------------------------------------------------------------------------
# Monitor: per-worker series + detectors + digests
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Health-plane tunables.  Detector thresholds are deliberately
    conservative defaults; the scenario tests inject clear violations."""

    window_s: float = 1.0
    max_windows: int = 64
    sketch_compression: int = 100
    # Straggler: a task whose service time exceeds ``straggler_factor`` ×
    # its profiled expectation (and a floor, so micro-tasks never flag).
    straggler_factor: float = 3.0
    straggler_min_s: float = 0.05
    # Queue buildup: depth at/above threshold on N consecutive samples.
    queue_depth_threshold: int = 8
    queue_consecutive: int = 3
    # Memory thrash: eviction count within one window at/above threshold.
    thrash_evictions_per_window: int = 4
    # Spine saturation: fair share at/below threshold (~ >= 1/share
    # concurrent flows on the uplink) on N consecutive cross transfers.
    spine_share_threshold: float = 0.34
    spine_consecutive: int = 4
    # Events retained verbatim in the summary (counters are unbounded).
    max_events: int = 256


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One detector firing."""

    t: float
    kind: str
    worker: int          # -1 for fleet-scope (spine) events
    value: float
    threshold: float
    detail: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {"t": round(self.t, 9), "kind": self.kind,
                "worker": self.worker, "value": round(self.value, 9),
                "threshold": self.threshold, "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class HealthDigest:
    """The four-field per-worker summary gossiped on SSTRow lanes 12–15."""

    queue_depth: int
    mem_occupancy: float
    fetch_util: float
    p99_latency_s: float


class _WorkerHealth:
    __slots__ = ("queue_depth", "mem_occupancy", "uplink_bytes", "pipe",
                 "latency", "_evictions_seen", "_thrash_window",
                 "_thrash_count", "_queue_over", "_last_queue_depth")

    def __init__(self, cfg: HealthConfig) -> None:
        self.queue_depth = WindowedSeries(cfg.window_s, cfg.max_windows)
        self.mem_occupancy = WindowedSeries(cfg.window_s, cfg.max_windows)
        self.uplink_bytes = WindowedSeries(cfg.window_s, cfg.max_windows)
        self.pipe = _PipeUtilization(cfg.window_s, cfg.max_windows)
        self.latency = QuantileSketch(cfg.sketch_compression)
        self._evictions_seen = 0
        self._thrash_window = -1
        self._thrash_count = 0
        self._queue_over = 0
        self._last_queue_depth = 0


class HealthMonitor:
    """Streaming health state for one engine run.

    The engines call the ``sample_* / on_*`` hooks behind
    ``if self._health is not None`` guards (same zero-overhead-when-off
    contract as the flight recorder); ``recorder`` may be None — health
    events are then only kept in the monitor's own ledger."""

    def __init__(
        self,
        n_workers: int,
        config: Optional[HealthConfig] = None,
        recorder: Optional[Any] = None,
    ) -> None:
        self.config = config or HealthConfig()
        self.n_workers = n_workers
        self.recorder = recorder
        self.workers = [_WorkerHealth(self.config) for _ in range(n_workers)]
        # Per-uplink bytes-in-flight series, keyed by uplink label
        # ("flat" on a topology-less cluster, "rackN" spine uplinks).
        self.uplinks: Dict[str, WindowedSeries] = {}
        self.fleet_job_latency = QuantileSketch(self.config.sketch_compression)
        self.events: List[HealthEvent] = []
        self.counts: Dict[str, int] = {k: 0 for k in DETECTOR_KINDS}
        self._spine_low = 0
        self._now = 0.0

    # -- event plumbing ------------------------------------------------------
    def _fire(self, t: float, kind: str, worker: int, value: float,
              threshold: float, detail: str = "") -> None:
        self.counts[kind] += 1
        if len(self.events) < self.config.max_events:
            self.events.append(
                HealthEvent(t, kind, worker, value, threshold, detail)
            )
        if self.recorder is not None:
            self.recorder.emit(
                t, kind, worker=worker, value=round(value, 9),
                threshold=threshold, detail=detail,
            )

    # -- sampling hooks (engine call sites) ----------------------------------
    def sample_queue(self, worker: int, t: float, depth: int) -> None:
        self._now = t
        wh = self.workers[worker]
        wh.queue_depth.observe(t, float(depth))
        wh._last_queue_depth = depth
        cfg = self.config
        if depth >= cfg.queue_depth_threshold:
            wh._queue_over += 1
            if wh._queue_over == cfg.queue_consecutive:
                self._fire(
                    t, QUEUE_BUILDUP, worker, float(depth),
                    float(cfg.queue_depth_threshold),
                    f"{cfg.queue_consecutive} consecutive samples",
                )
        else:
            wh._queue_over = 0

    def sample_memory(self, worker: int, t: float, occupancy: float,
                      evictions_total: int) -> None:
        self._now = t
        wh = self.workers[worker]
        wh.mem_occupancy.observe(t, occupancy)
        cfg = self.config
        new = evictions_total - wh._evictions_seen
        wh._evictions_seen = evictions_total
        if new <= 0:
            return
        idx = int(t // cfg.window_s)
        win = wh.mem_occupancy.last
        # Count evictions into the current window via a side counter on
        # the occupancy series' window index.
        if wh._thrash_window != idx:
            wh._thrash_window = idx
            wh._thrash_count = new
        else:
            wh._thrash_count += new
        if (
            wh._thrash_count >= cfg.thrash_evictions_per_window
            and wh._thrash_count - new < cfg.thrash_evictions_per_window
        ):
            self._fire(
                t, MEMORY_THRASH, worker, float(wh._thrash_count),
                float(cfg.thrash_evictions_per_window),
                f"evictions in window {idx} (occupancy {win.last:.2f})"
                if win else "",
            )

    def fetch_state(self, worker: int, t: float, busy: bool) -> None:
        self._now = t
        self.workers[worker].pipe.update(t, busy)

    def on_transfer(self, t: float, uplink: str, nbytes: float,
                    share: float, cross: bool) -> None:
        self._now = t
        series = self.uplinks.get(uplink)
        if series is None:
            series = self.uplinks[uplink] = WindowedSeries(
                self.config.window_s, self.config.max_windows
            )
        series.observe(t, nbytes)
        cfg = self.config
        if cross:
            if share <= cfg.spine_share_threshold:
                self._spine_low += 1
                if self._spine_low == cfg.spine_consecutive:
                    self._fire(
                        t, SPINE_SATURATION, -1, share,
                        cfg.spine_share_threshold,
                        f"uplink {uplink}: {cfg.spine_consecutive} "
                        f"consecutive contended transfers",
                    )
            else:
                self._spine_low = 0

    def task_done(self, worker: int, t: float, service_s: float,
                  expected_s: float) -> None:
        self._now = t
        wh = self.workers[worker]
        wh.latency.add(service_s)
        cfg = self.config
        if (
            service_s >= cfg.straggler_min_s
            and expected_s > 0.0
            and service_s >= cfg.straggler_factor * expected_s
        ):
            self._fire(
                t, STRAGGLER, worker, service_s,
                cfg.straggler_factor * expected_s,
                f"expected {expected_s:.4f}s",
            )

    def job_done(self, t: float, latency_s: float) -> None:
        self._now = t
        self.fleet_job_latency.add(latency_s)

    # -- digests (SST lanes 12-15) -------------------------------------------
    def digest(self, worker: int, t: float) -> HealthDigest:
        """Current four-field digest for the owner's SST row; the engine
        refreshes it right before each publication/gossip round, so the
        replicated view's staleness is bounded by the dissemination
        period like every other lane."""
        wh = self.workers[worker]
        occ = wh.mem_occupancy.last
        return HealthDigest(
            queue_depth=wh._last_queue_depth,
            mem_occupancy=occ.last if occ else 0.0,
            fetch_util=wh.pipe.utilization(t),
            p99_latency_s=(
                wh.latency.quantile(0.99) if wh.latency.count else 0.0
            ),
        )

    # -- summary --------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Deterministic, schema-versioned health report
        (``schemas/health.schema.json``); the payload behind
        ``SimReport.health_summary()``."""
        fleet = QuantileSketch(self.config.sketch_compression)
        per_worker = []
        for w, wh in enumerate(self.workers):
            if wh.latency.count:
                fleet.merge(wh.latency)
            occ = wh.mem_occupancy.last
            per_worker.append({
                "worker": w,
                "queue_depth_last": wh._last_queue_depth,
                "queue_depth_max": int(wh.queue_depth.overall_max()),
                "mem_occupancy_last": round(occ.last, 9) if occ else 0.0,
                "fetch_util": round(wh.pipe.utilization(self._now), 9),
                "task_latency": _round_dict(wh.latency.as_dict()),
            })
        return {
            "schema_version": HEALTH_SCHEMA_VERSION,
            "horizon_s": round(self._now, 9),
            "workers": per_worker,
            "fleet_task_latency": _round_dict(fleet.as_dict()),
            "fleet_job_latency": _round_dict(self.fleet_job_latency.as_dict()),
            "uplink_bytes": {
                name: round(s.overall_mean(), 9)
                for name, s in sorted(self.uplinks.items())
            },
            "detectors": {k: self.counts[k] for k in sorted(self.counts)},
            "events": [e.as_dict() for e in self.events],
        }


def _round_dict(d: Dict[str, float]) -> Dict[str, float]:
    return {k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in d.items()}


# --------------------------------------------------------------------------
# Eq. 2 cost-model calibration: provenance vs measured spans
# --------------------------------------------------------------------------
#: Eq. 2 components joined against span measurements, in report order.
CALIBRATION_COMPONENTS = ("queue", "input_transfer", "model_fetch", "runtime")


@dataclasses.dataclass
class ComponentCalibration:
    """Residual statistics for one Eq. 2 component (residual =
    measured − predicted; positive means the planner was optimistic)."""

    component: str
    count: int = 0
    predicted_sum: float = 0.0
    measured_sum: float = 0.0
    residual_sum: float = 0.0
    residual_abs_sum: float = 0.0
    residuals: QuantileSketch = dataclasses.field(
        default_factory=lambda: QuantileSketch(100)
    )

    def observe(self, predicted: float, measured: float) -> None:
        r = measured - predicted
        self.count += 1
        self.predicted_sum += predicted
        self.measured_sum += measured
        self.residual_sum += r
        self.residual_abs_sum += abs(r)
        self.residuals.add(r)

    def as_dict(self) -> Dict[str, Any]:
        n = max(1, self.count)
        return {
            "component": self.component,
            "count": self.count,
            "predicted_mean_s": self.predicted_sum / n,
            "measured_mean_s": self.measured_sum / n,
            "residual_mean_s": self.residual_sum / n,
            "residual_abs_mean_s": self.residual_abs_sum / n,
            "residual_p50_s": self.residuals.quantile(0.5),
            "residual_p90_s": self.residuals.quantile(0.9),
            "residual_p99_s": self.residuals.quantile(0.99),
        }


@dataclasses.dataclass
class CalibrationReport:
    """Per-component Eq. 2 residuals for one traced run."""

    scheduler: str
    components: Dict[str, ComponentCalibration]
    joined: int = 0        # spans matched to a placement decision
    unmatched: int = 0     # completed spans with no usable decision

    def to_metrics(self, registry) -> None:
        """Export the residual statistics as gauges/counters on the
        run's MetricsRegistry (schema-compatible with
        ``schemas/metrics.schema.json``)."""
        registry.counter("calibration.joined",
                         scheduler=self.scheduler).inc(self.joined)
        registry.counter("calibration.unmatched",
                         scheduler=self.scheduler).inc(self.unmatched)
        for name in CALIBRATION_COMPONENTS:
            c = self.components[name]
            d = c.as_dict()
            labels = {"component": name, "scheduler": self.scheduler}
            registry.counter("calibration.samples", **labels).inc(c.count)
            for key in ("residual_mean_s", "residual_abs_mean_s",
                        "residual_p50_s", "residual_p90_s",
                        "residual_p99_s"):
                registry.gauge(f"calibration.{key}", **labels).set(d[key])

    def format_table(self) -> str:
        lines = [
            f"calibration[{self.scheduler}]: {self.joined} spans joined, "
            f"{self.unmatched} unmatched",
            f"{'component':>16} {'n':>6} {'pred_mean':>10} {'meas_mean':>10}"
            f" {'resid_mean':>11} {'|resid|':>9} {'p50':>9} {'p90':>9}"
            f" {'p99':>9}",
        ]
        for name in CALIBRATION_COMPONENTS:
            d = self.components[name].as_dict()
            lines.append(
                f"{name:>16} {d['count']:>6d}"
                f" {d['predicted_mean_s']:>10.4f}"
                f" {d['measured_mean_s']:>10.4f}"
                f" {d['residual_mean_s']:>11.4f}"
                f" {d['residual_abs_mean_s']:>9.4f}"
                f" {d['residual_p50_s']:>9.4f}"
                f" {d['residual_p90_s']:>9.4f}"
                f" {d['residual_p99_s']:>9.4f}"
            )
        return "\n".join(lines)

    def worst_component(self) -> str:
        return max(
            CALIBRATION_COMPONENTS,
            key=lambda n: abs(self.components[n].as_dict()["residual_mean_s"]),
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "scheduler": self.scheduler,
            "joined": self.joined,
            "unmatched": self.unmatched,
            "components": {
                n: self.components[n].as_dict()
                for n in CALIBRATION_COMPONENTS
            },
        }


def calibrate(report) -> CalibrationReport:
    """Join placement provenance against measured spans.

    For every completed (job, task) with recorded decisions, take the
    *last* decision whose chosen worker is where the final attempt
    actually ran (plan→adjust chains re-place; the final decision is
    the one the execution realized) and compare its chosen candidate's
    Eq. 2 terms against the span's measured breakdown:

    ====================  =============================================
    predicted             measured (span component)
    ====================  =============================================
    queue   max(0, FT(w) − max(AT_inputs, t))   dispatch wait past readiness
    input   max(0, AT_inputs − t)               critical-input shipping
    model   TD_model charged (model_s)          fetch wait past readiness
    runtime R(t, w)                             compute time
    ====================  =============================================

    ``report`` is a ``core.telemetry.SimReport``.  Residuals are
    measured − predicted, so positive = planner optimistic.
    """
    rec = report.recorder
    out = CalibrationReport(
        scheduler=report.result.scheduler,
        components={
            n: ComponentCalibration(n) for n in CALIBRATION_COMPONENTS
        },
    )
    for (job_id, task_id) in sorted(rec._placement_index):
        decisions = rec.decisions(job_id, task_id)
        try:
            span = report.final_span(job_id, task_id)
        except KeyError:
            out.unmatched += 1
            continue
        decision = None
        for d in reversed(decisions):
            if d.chosen == span.worker:
                decision = d
                break
        if decision is None:
            out.unmatched += 1  # every decision was overtaken by recovery
            continue
        cand = decision.candidate(decision.chosen)
        if cand is None or cand.total_s == float("inf"):
            out.unmatched += 1
            continue
        t0 = decision.t
        pred_input = max(0.0, cand.input_s - t0)
        pred_queue = max(0.0, cand.queue_s - max(cand.input_s, t0))
        out.components["queue"].observe(pred_queue, span.queue_s)
        out.components["input_transfer"].observe(pred_input, span.input_s)
        out.components["model_fetch"].observe(cand.model_s, span.fetch_s)
        out.components["runtime"].observe(cand.runtime_s, span.compute_s)
        out.joined += 1
    return out
