"""Flight-recorder observability plane (DESIGN.md §3.4), copied from the
JAX package so that the port stands alone.

Compass's headline claims are latency *decompositions* — where a job's
completion time goes and why a placement won — so the repo needs more
than end-of-run aggregates.  This module is the instrument:

* :class:`FlightRecorder` — a structured event tracer.  Every simulator /
  serving-engine event (dispatch, fetch begin/complete/abort, prefetch
  intent/promotion, gossip exchange, transfer start/finish with link
  scope + contention share, churn/partition transitions, task state
  changes) lands as a typed record on a per-worker ring buffer.  The
  whole trace exports as Chrome-trace/Perfetto JSON and as a
  deterministic JSONL stream (same seed + config ⇒ byte-identical
  bytes — a far stronger regression oracle than aggregate counters).

* **Span model** — :func:`build_spans` stitches raw events into
  per-task-attempt spans and :class:`SimReport` walks the critical path
  of a job's DAG to produce a queue / input-transfer / model-fetch-wait
  / compute / output-ship latency breakdown whose components sum to the
  measured JCT exactly (telescoping differences, no estimation).

* **Placement provenance** — planners record the per-candidate Eq. 2
  cost vector (queue drain, data/path term, model term, intent
  discount, runtime, liveness penalty, staleness margin) for every
  decision, so ``explain(task_id)`` answers "why worker 3 and not
  worker 5" from the trace alone.

* :class:`MetricsRegistry` — named, labeled counters/gauges that absorb
  the engines' ad-hoc result counters into a stable, versioned export
  schema (``schemas/metrics.schema.json``).

Zero overhead when off: the engines guard every emission site with
``if self._rec is not None`` and never call into this module from the
hot event loop while tracing is disabled — the CI ``trace-smoke`` guard
benchmark asserts the tracing-off loop performs *zero* allocations
attributable to this file.
"""

from __future__ import annotations

import collections
import dataclasses
import gzip
import io
import json
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

TRACE_SCHEMA_VERSION = 1
METRICS_SCHEMA_VERSION = 1

#: Cluster-scope events (churn, plan, job lifecycle) ride a dedicated
#: ring instead of a worker's.
GLOBAL = -1


# --------------------------------------------------------------------------
# Metrics registry
# --------------------------------------------------------------------------
class Counter:
    """Monotone named counter (int or float)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]) -> None:
        self.name = name
        self.labels = labels
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins named value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]) -> None:
        self.name = name
        self.labels = labels
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram (cumulative counts + sum/count/min/max)."""

    __slots__ = ("name", "labels", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")

    def __init__(
        self,
        name: str,
        labels: Tuple[Tuple[str, str], ...],
        bounds: Sequence[float],
    ) -> None:
        self.name = name
        self.labels = labels
        self.bounds = tuple(bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1


def _label_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Named, labeled counters/gauges/histograms with a stable export
    schema.  One registry per simulation/serving run; the engines'
    legacy result fields are derived views over it."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def _get(self, cls, name: str, labels: Mapping[str, str], *args):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], *args)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{dict(key[1])} already registered as "
                f"{type(m).__name__}"
            )
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, bounds: Sequence[float] = (), **labels: str
    ) -> Histogram:
        return self._get(Histogram, name, labels, bounds)

    def value(self, name: str, default: float = 0, **labels: str) -> float:
        """Current value of a counter/gauge (``default`` if absent)."""
        m = self._metrics.get((name, _label_key(labels)))
        return default if m is None else m.value

    def sum_values(self, name: str) -> float:
        """Sum of a counter family's values across all label sets."""
        return sum(
            m.value
            for (n, _), m in self._metrics.items()
            if n == name and isinstance(m, (Counter, Gauge))
        )

    def export(self) -> Dict[str, Any]:
        """Versioned, deterministic export (sorted by name + labels)."""
        out: List[Dict[str, Any]] = []
        for (name, labels), m in sorted(self._metrics.items()):
            rec: Dict[str, Any] = {
                "name": name,
                "type": type(m).__name__.lower(),
                "labels": dict(labels),
            }
            if isinstance(m, Histogram):
                rec["count"] = m.count
                rec["sum"] = m.sum
                rec["bounds"] = list(m.bounds)
                rec["bucket_counts"] = list(m.bucket_counts)
                if m.count:
                    rec["min"] = m.min
                    rec["max"] = m.max
            else:
                rec["value"] = m.value
            out.append(rec)
        return {"schema_version": METRICS_SCHEMA_VERSION, "metrics": out}


# --------------------------------------------------------------------------
# Placement provenance
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """Per-candidate Eq. 2 cost vector for one placement decision.

    All terms are seconds.  ``total_s`` is the selection cost the argmin
    ran over: ``max(queue_s, input_s) + model_s + runtime_s +
    liveness_s (+ staleness_margin_s where the decision applies one)``.
    ``intent_discount_s`` is how much the prefetch-intent lane shaved
    off the undiscounted model term (0 when inert).
    """

    worker: int
    queue_s: float            # published FT(w) queue-drain estimate (abs)
    input_s: float            # AT_allInputs / data-path term (abs arrival)
    model_s: float            # Eq. 2 TD_model actually charged
    intent_discount_s: float  # fetch seconds saved by the intent lane
    runtime_s: float          # R(t, w)
    liveness_s: float         # membership penalty (inf = DEAD in view)
    total_s: float            # selection cost (argmin input)
    staleness_margin_s: float = 0.0  # hysteresis margin applied (adjust)

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: (repr(v) if v in (float("inf"),) else v)
                for k, v in d.items()}


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """One planner decision with its full candidate table."""

    t: float
    job_id: int
    task_id: str
    phase: str                # plan | jit | adjust | recovery
    scheduler: str
    reader: int               # worker whose SST replica was read
    chosen: int
    candidates: Tuple[CandidateCost, ...]
    note: str = ""            # e.g. herd-sticky override, hysteresis hold

    def candidate(self, worker: int) -> Optional[CandidateCost]:
        for c in self.candidates:
            if c.worker == worker:
                return c
        return None

    def explain(self) -> str:
        lines = [
            f"[{self.phase}] job {self.job_id} task {self.task_id!r} "
            f"@t={self.t:.6f}s  scheduler={self.scheduler}  "
            f"reader=w{self.reader}  chosen=w{self.chosen}"
            + (f"  ({self.note})" if self.note else "")
        ]
        lines.append(
            "  worker   queue_s   input_s   model_s  -intent_s runtime_s"
            "    live_s   total_s"
        )
        for c in sorted(self.candidates, key=lambda c: c.worker):
            mark = "→" if c.worker == self.chosen else " "
            lines.append(
                f" {mark}w{c.worker:<4d}"
                + "".join(
                    f"{v:>10.4f}" if v != float("inf") else f"{'inf':>10}"
                    for v in (
                        c.queue_s, c.input_s, c.model_s, c.intent_discount_s,
                        c.runtime_s, c.liveness_s, c.total_s,
                    )
                )
            )
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Flight recorder
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Flight-recorder tunables."""

    # Events retained per ring (one ring per worker + one cluster ring).
    # Old events are dropped FIFO once a ring fills; drops are counted
    # and surfaced by SimReport.
    ring_capacity: int = 1 << 20
    # Record per-candidate planner cost vectors (placement provenance).
    provenance: bool = True


class FlightRecorder:
    """Per-worker ring-buffer event tracer + provenance store.

    ``emit`` is the single hot entry point; the engines only call it
    behind an ``is not None`` guard, so a disabled recorder costs one
    attribute load + branch per site and zero allocations.
    """

    def __init__(
        self, n_workers: int, config: Optional[TraceConfig] = None
    ) -> None:
        self.config = config or TraceConfig()
        self.n_workers = n_workers
        cap = self.config.ring_capacity
        # rings[w] for workers, rings[n_workers] is the cluster ring.
        self._rings: List[collections.deque] = [
            collections.deque(maxlen=cap) for _ in range(n_workers + 1)
        ]
        self._emitted: List[int] = [0] * (n_workers + 1)
        self._seq = 0
        self.placements: List[PlacementDecision] = []
        self._placement_index: Dict[Tuple[int, str], List[int]] = {}

    # -- hot path ------------------------------------------------------------
    def emit(self, t: float, kind: str, worker: int = GLOBAL, **data) -> None:
        ring = self._rings[worker if 0 <= worker < self.n_workers
                           else self.n_workers]
        ring.append((self._seq, t, kind, worker, data))
        self._emitted[worker if 0 <= worker < self.n_workers
                      else self.n_workers] += 1
        self._seq += 1

    # -- provenance sink (planners call this) ---------------------------------
    def record_placement(self, decision: PlacementDecision) -> None:
        if not self.config.provenance:
            return
        self._placement_index.setdefault(
            (decision.job_id, decision.task_id), []
        ).append(len(self.placements))
        self.placements.append(decision)
        self.emit(
            decision.t,
            "sched.place",
            worker=decision.reader,
            job=decision.job_id,
            task=decision.task_id,
            phase=decision.phase,
            chosen=decision.chosen,
            n_candidates=len(decision.candidates),
        )

    def decisions(self, job_id: int, task_id: str) -> List[PlacementDecision]:
        return [
            self.placements[i]
            for i in self._placement_index.get((job_id, task_id), [])
        ]

    # -- inspection -----------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events lost to ring wrap-around (0 ⇒ the trace is complete)."""
        return sum(
            e - len(r) for e, r in zip(self._emitted, self._rings)
        )

    def ring_stats(self) -> Dict[str, Tuple[int, int]]:
        """Per-ring (emitted, dropped) counts keyed by ring name
        (``worker<N>`` / ``cluster``) — the engines fold these into the
        MetricsRegistry export (``trace.emitted`` / ``trace.dropped``)
        so a drop-rate alert needs no trace access."""
        out: Dict[str, Tuple[int, int]] = {}
        for i, (e, r) in enumerate(zip(self._emitted, self._rings)):
            name = f"worker{i}" if i < self.n_workers else "cluster"
            out[name] = (e, e - len(r))
        return out

    def events(self) -> List[Tuple[int, float, str, int, Dict[str, Any]]]:
        """All retained events in emission order (seq-sorted)."""
        out: List[Tuple[int, float, str, int, Dict[str, Any]]] = []
        for ring in self._rings:
            out.extend(ring)
        out.sort(key=lambda e: e[0])
        return out

    # -- exports --------------------------------------------------------------
    def to_jsonl(self) -> str:
        """Deterministic JSONL stream: one event per line, stable key
        order, seq-sorted.  Same seed + config ⇒ byte-identical output
        (the chaos suite asserts this)."""
        lines = []
        for seq, t, kind, worker, data in self.events():
            rec = {"seq": seq, "t": round(t, 9), "kind": kind,
                   "worker": worker}
            for k in sorted(data):
                v = data[k]
                if isinstance(v, float):
                    v = round(v, 9)
                rec[k] = v
            lines.append(json.dumps(rec, separators=(",", ":")))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON (``chrome://tracing`` object
        format).  pid = worker, tids split execution / fetch-pipe /
        network lanes; instant events carry churn and scheduling
        markers."""
        US = 1e6
        tev: List[Dict[str, Any]] = []
        for w in range(self.n_workers):
            tev.append({"ph": "M", "name": "process_name", "pid": w,
                        "tid": 0, "args": {"name": f"worker{w}"}})
            for tid, nm in ((0, "exec"), (1, "fetch-pipe"), (2, "net-out")):
                tev.append({"ph": "M", "name": "thread_name", "pid": w,
                            "tid": tid, "args": {"name": nm}})
        tev.append({"ph": "M", "name": "process_name", "pid": self.n_workers,
                    "tid": 0, "args": {"name": "cluster"}})

        open_exec: Dict[Tuple[int, str], Tuple[float, Dict[str, Any]]] = {}
        open_fetch: Dict[int, Tuple[float, Dict[str, Any]]] = {}
        for seq, t, kind, worker, data in self.events():
            pid = worker if 0 <= worker < self.n_workers else self.n_workers
            if kind == "task.start":
                open_exec[(pid, f"{data['job']}:{data['task']}")] = (t, data)
            elif kind == "task.done":
                key = (pid, f"{data['job']}:{data['task']}")
                t0, d0 = open_exec.pop(key, (t, data))
                tev.append({
                    "ph": "X", "cat": "task", "name": key[1], "pid": pid,
                    "tid": 0, "ts": t0 * US, "dur": (t - t0) * US,
                    "args": {"gen": data.get("gen", 0),
                             "model": d0.get("model", -1),
                             "miss": d0.get("miss", False)},
                })
            elif kind == "fetch.start":
                open_fetch[pid] = (t, data)
            elif kind in ("fetch.done", "fetch.abort"):
                t0, d0 = open_fetch.pop(pid, (t, data))
                tev.append({
                    "ph": "X", "cat": "fetch",
                    "name": f"m{d0.get('model', data.get('model', -1))}"
                            f"/{d0.get('fetch_kind', '?')}",
                    "pid": pid, "tid": 1, "ts": t0 * US,
                    "dur": (t - t0) * US,
                    "args": {"outcome": kind.split(".")[1],
                             "bytes": d0.get("bytes", 0.0)},
                })
            elif kind == "net.xfer":
                tev.append({
                    "ph": "X", "cat": "net",
                    "name": f"→w{data.get('dst', -1)}"
                            f"/{data.get('scope', 'flat')}",
                    "pid": pid, "tid": 2, "ts": t * US,
                    "dur": data.get("dur", 0.0) * US,
                    "args": {"bytes": data.get("bytes", 0.0),
                             "scope": data.get("scope", "flat"),
                             "share": data.get("share", 1.0)},
                })
            elif kind in ("churn.crash", "churn.join", "churn.drain",
                          "churn.partition", "churn.heal", "job.arrive",
                          "job.done", "sched.adjust", "sched.place",
                          "task.bounce", "task.dead_letter",
                          "task.recover", "gossip.exchange",
                          "intent.admit", "intent.cancel",
                          "fetch.promote", "health.straggler",
                          "health.queue_buildup", "health.memory_thrash",
                          "health.spine_saturation"):
                tev.append({
                    "ph": "i", "s": "p" if pid < self.n_workers else "g",
                    "cat": kind.split(".")[0], "name": kind,
                    "pid": pid, "tid": 0, "ts": t * US,
                    "args": {k: v for k, v in sorted(data.items())
                             if isinstance(v, (int, float, str, bool))},
                })
        return {
            "schema_version": TRACE_SCHEMA_VERSION,
            "displayTimeUnit": "ms",
            "traceEvents": tev,
        }

    def export_jsonl(self, path: str, compress: bool = False) -> None:
        """Write the JSONL stream to ``path``; with ``compress=True`` the
        stream is gzipped (``mtime=0`` so the archive, like the
        uncompressed stream, is byte-deterministic across reruns — long
        open-loop traces shrink ~10×)."""
        payload = self.to_jsonl().encode("utf-8")
        if compress:
            raw = io.BytesIO()
            with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as gz:
                gz.write(payload)
            with open(path, "wb") as f:
                f.write(raw.getvalue())
        else:
            with open(path, "wb") as f:
                f.write(payload)

    def write(self, jsonl_path: Optional[str] = None,
              chrome_path: Optional[str] = None) -> None:
        if jsonl_path:
            self.export_jsonl(jsonl_path)
        if chrome_path:
            with open(chrome_path, "w") as f:
                json.dump(self.to_chrome_trace(), f, indent=1,
                          sort_keys=True)


# --------------------------------------------------------------------------
# Span model: raw events → per-task-attempt spans → latency breakdown
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TaskSpan:
    """One task attempt (generation), stitched from trace events."""

    job_id: int
    task_id: str
    gen: int
    worker: Optional[int] = None
    model: Optional[int] = None
    miss: bool = False
    # src -> (t_send, t_arrive, from_worker); "" is the entry payload.
    inputs: Dict[str, Tuple[float, float, Optional[int]]] = dataclasses.field(
        default_factory=dict
    )
    t_start: Optional[float] = None
    t_done: Optional[float] = None
    model_ready: Optional[float] = None  # fetch.done that unblocked it

    # -- derived components ---------------------------------------------------
    @property
    def t_send(self) -> float:
        """When this attempt's inputs left their producers (max over
        inputs — siblings ship together or the last sender gates)."""
        return max((s for s, _, _ in self.inputs.values()), default=0.0)

    @property
    def t_ready(self) -> float:
        """When the last input landed (dispatch-eligible)."""
        return max((a for _, a, _ in self.inputs.values()), default=0.0)

    @property
    def input_s(self) -> float:
        """Input/output shipping time on this attempt's critical input."""
        return max(0.0, self.t_ready - self.t_send)

    @property
    def fetch_s(self) -> float:
        """Model-fetch wait past input readiness (0 on a hit or when the
        fetch fully overlapped the input transfer)."""
        if self.model_ready is None or self.t_start is None:
            return 0.0
        return max(0.0, min(self.model_ready, self.t_start) - self.t_ready)

    @property
    def queue_s(self) -> float:
        """Dispatch wait after inputs + model were both available."""
        if self.t_start is None:
            return 0.0
        return max(0.0, self.t_start - self.t_ready - self.fetch_s)

    @property
    def compute_s(self) -> float:
        if self.t_start is None or self.t_done is None:
            return 0.0
        return self.t_done - self.t_start

    @property
    def total_s(self) -> float:
        """send → done; telescopes along the critical path."""
        if self.t_done is None:
            return 0.0
        return self.t_done - self.t_send


def build_spans(
    events: Iterable[Tuple[int, float, str, int, Dict[str, Any]]],
) -> Dict[Tuple[int, str, int], TaskSpan]:
    """Stitch raw events into per-(job, task, generation) spans.

    Re-shipments of the same (task, src, generation) overwrite earlier
    ones (the last posted copy is the one that landed — dead-letter
    failover re-ships under the same generation).  ``model_ready`` is
    the last fetch completion on the span's worker for its model at or
    before execution start.
    """
    spans: Dict[Tuple[int, str, int], TaskSpan] = {}
    # (worker, model) -> list of fetch.done times (ascending by seq).
    fetch_done: Dict[Tuple[int, int], List[float]] = {}

    def span(job: int, task: str, gen: int) -> TaskSpan:
        key = (job, task, gen)
        s = spans.get(key)
        if s is None:
            s = spans[key] = TaskSpan(job, task, gen)
        return s

    for seq, t, kind, worker, data in events:
        if kind == "task.input":
            s = span(data["job"], data["task"], data["gen"])
            s.inputs[data["src"]] = (t, data["arrive"], data.get("frm"))
            s.worker = data["to"]
        elif kind == "fetch.done":
            fetch_done.setdefault(
                (worker, data["model"]), []
            ).append(t)
        elif kind == "task.start":
            s = span(data["job"], data["task"], data["gen"])
            s.worker = worker
            s.t_start = t
            s.model = data.get("model")
            s.miss = bool(data.get("miss", False))
            if s.miss and s.model is not None:
                done = fetch_done.get((worker, s.model), ())
                ready = None
                for ft in done:
                    if ft <= t:
                        ready = ft
                s.model_ready = ready
        elif kind == "task.done":
            s = span(data["job"], data["task"], data["gen"])
            s.worker = worker
            s.t_done = t
    return spans


@dataclasses.dataclass
class JobBreakdown:
    """Critical-path latency decomposition of one job.

    ``queue_s + input_transfer_s + output_ship_s + fetch_wait_s +
    compute_s == jct_s`` exactly (telescoping differences; any
    recovery/re-staging stall is folded into ``queue_s``).
    """

    job_id: int
    arrival: float
    finish: float
    critical_path: List[Tuple[str, int]]  # (task_id, gen) exit → entry order
    queue_s: float = 0.0
    input_transfer_s: float = 0.0   # entry payload shipping
    output_ship_s: float = 0.0      # inter-task intermediate transfers
    fetch_wait_s: float = 0.0       # model-fetch wait past input readiness
    compute_s: float = 0.0

    @property
    def jct_s(self) -> float:
        return self.finish - self.arrival

    @property
    def components_sum_s(self) -> float:
        return (
            self.queue_s + self.input_transfer_s + self.output_ship_s
            + self.fetch_wait_s + self.compute_s
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "jct_s": self.jct_s,
            "queue_s": self.queue_s,
            "input_transfer_s": self.input_transfer_s,
            "output_ship_s": self.output_ship_s,
            "fetch_wait_s": self.fetch_wait_s,
            "compute_s": self.compute_s,
            "critical_path": [t for t, _ in self.critical_path],
        }


class SimReport:
    """Post-run analysis API over a traced simulation result.

    Construct from a ``SimResult`` whose ``trace`` is a
    :class:`FlightRecorder` (``Simulation(..., trace=True)``), or pass
    the recorder explicitly.
    """

    def __init__(self, result, recorder: Optional[FlightRecorder] = None):
        self.result = result
        rec = recorder if recorder is not None else getattr(
            result, "trace", None
        )
        if rec is None:
            raise ValueError(
                "SimReport needs a traced run: pass trace=True to the "
                "Simulation (result.trace is None)"
            )
        self.recorder: FlightRecorder = rec
        self._spans: Optional[Dict[Tuple[int, str, int], TaskSpan]] = None
        self._done_times: Optional[Dict[Tuple[int, str],
                                        List[Tuple[float, int]]]] = None

    # -- span access ----------------------------------------------------------
    @property
    def spans(self) -> Dict[Tuple[int, str, int], TaskSpan]:
        if self._spans is None:
            if self.recorder.dropped:
                raise ValueError(
                    f"trace dropped {self.recorder.dropped} events (ring "
                    f"too small for this horizon); raise "
                    f"TraceConfig.ring_capacity"
                )
            self._spans = build_spans(self.recorder.events())
        return self._spans

    def _completions(self) -> Dict[Tuple[int, str], List[Tuple[float, int]]]:
        """(job, task) -> [(t_done, gen)] ascending by completion time."""
        if self._done_times is None:
            out: Dict[Tuple[int, str], List[Tuple[float, int]]] = {}
            for (job, task, gen), s in self.spans.items():
                if s.t_done is not None:
                    out.setdefault((job, task), []).append((s.t_done, gen))
            for v in out.values():
                v.sort()
            self._done_times = out
        return self._done_times

    def final_span(self, job_id: int, task_id: str) -> TaskSpan:
        done = self._completions().get((job_id, task_id))
        if not done:
            raise KeyError(
                f"no completed attempt for job {job_id} task {task_id!r}"
            )
        return self.spans[(job_id, task_id, done[-1][1])]

    # -- critical path + breakdown --------------------------------------------
    def _record(self, job_id: int):
        for r in self.result.records:
            if r.job_id == job_id:
                return r
        raise KeyError(f"job {job_id} has no completion record")

    def critical_path(self, job_id: int) -> List[Tuple[str, int]]:
        """(task, gen) chain from the job's last-finishing task back to
        an entry task, following the time-binding dependency at each
        step: the predecessor whose completion gated this attempt's
        input shipment (exact match on ``t_send``), else the
        latest-arriving input's producer."""
        comps = self._completions()
        tasks = [(t, d) for (j, t), d in comps.items() if j == job_id]
        if not tasks:
            raise KeyError(f"job {job_id} not in trace")
        # Last-finishing attempt overall = the job's finishing task.
        task_id, done = max(tasks, key=lambda td: td[1][-1][0])
        gen = done[-1][1]
        path: List[Tuple[str, int]] = []
        seen = set()
        while True:
            path.append((task_id, gen))
            seen.add((task_id, gen))
            s = self.spans[(job_id, task_id, gen)]
            preds = [src for src in s.inputs if src != ""]
            if not preds:
                return path
            t_send = s.t_send
            nxt: Optional[Tuple[str, int]] = None
            # A predecessor completion exactly at t_send gated the send.
            for p in sorted(preds):
                for t_done, g in comps.get((job_id, p), ()):
                    if abs(t_done - t_send) < 1e-12:
                        nxt = (p, g)
                        break
                if nxt:
                    break
            if nxt is None:
                # Fall back to the latest-arriving input's producer, at
                # the generation that completed at/before the send.
                p = max(
                    sorted(preds), key=lambda p: s.inputs[p][1]
                )
                cand = [
                    (t_done, g)
                    for t_done, g in comps.get((job_id, p), ())
                    if t_done <= t_send + 1e-12
                ]
                pick = cand[-1] if cand else comps[(job_id, p)][-1]
                nxt = (p, pick[1])
            if nxt in seen:  # defensive: malformed trace
                return path
            task_id, gen = nxt

    def latency_breakdown(
        self, job_id: Optional[int] = None
    ) -> Any:
        """Per-job critical-path decomposition; with no ``job_id``, the
        aggregate over every completed job (component sums + shares)."""
        if job_id is None:
            return self._aggregate_breakdown()
        rec = self._record(job_id)
        path = self.critical_path(job_id)
        bd = JobBreakdown(
            job_id=job_id, arrival=rec.arrival, finish=rec.finish,
            critical_path=path,
        )
        for i, (task_id, gen) in enumerate(path):
            s = self.spans[(job_id, task_id, gen)]
            bd.compute_s += s.compute_s
            bd.fetch_wait_s += s.fetch_s
            bd.queue_s += s.queue_s
            entry = "" in s.inputs and i == len(path) - 1
            if entry:
                bd.input_transfer_s += s.input_s
                # Any gap between job arrival and the entry shipment
                # (client retry, recovery re-staging) is queueing.
                bd.queue_s += max(0.0, s.t_send - rec.arrival)
            else:
                bd.output_ship_s += s.input_s
                # Gap between the gating predecessor's completion and
                # this attempt's shipment (recovery stalls) is queueing.
                nxt = self.spans[(job_id,) + path[i + 1]]
                if nxt.t_done is not None:
                    bd.queue_s += max(0.0, s.t_send - nxt.t_done)
        return bd

    def _aggregate_breakdown(self) -> Dict[str, Any]:
        parts = ["queue_s", "input_transfer_s", "output_ship_s",
                 "fetch_wait_s", "compute_s"]
        agg = {p: 0.0 for p in parts}
        jct = 0.0
        n = 0
        for r in self.result.records:
            bd = self.latency_breakdown(r.job_id)
            for p in parts:
                agg[p] += getattr(bd, p)
            jct += bd.jct_s
            n += 1
        out: Dict[str, Any] = {"jobs": n, "jct_s": jct}
        out.update(agg)
        if jct > 0:
            out["shares"] = {p: agg[p] / jct for p in parts}
        return out

    # -- provenance -----------------------------------------------------------
    def explain(self, task_id: str, job_id: Optional[int] = None) -> str:
        """Human-readable account of every placement decision made for
        the task, each with its per-candidate Eq. 2 cost vector, plus
        the task's measured latency breakdown."""
        if job_id is None:
            jobs = sorted(
                j for (j, t) in self._placement_keys() if t == task_id
            )
            if not jobs:
                # No provenance (hash/heft read no state) — fall back to
                # any job with a completed span for the task.
                jobs = sorted(
                    j for (j, t) in self._completions() if t == task_id
                )
            if not jobs:
                raise KeyError(
                    f"no decisions or spans recorded for task {task_id!r}"
                )
            job_id = jobs[0]
        decisions = self.recorder.decisions(job_id, task_id)
        blocks = [d.explain() for d in decisions]
        try:
            s = self.final_span(job_id, task_id)
            blocks.append(
                f"measured: worker=w{s.worker} input={s.input_s:.4f}s "
                f"fetch={s.fetch_s:.4f}s queue={s.queue_s:.4f}s "
                f"compute={s.compute_s:.4f}s "
                f"(miss={s.miss}, gen={s.gen})"
            )
        except KeyError:
            pass
        if not blocks:
            blocks.append(
                f"no decisions or spans for job {job_id} task {task_id!r} "
                f"(hash/heft record no provenance: their placement reads "
                f"no state)"
            )
        return "\n".join(blocks)

    def _placement_keys(self):
        return self.recorder._placement_index.keys()

    # -- health plane (core/healthplane.py) -----------------------------------
    def health_summary(self) -> Dict[str, Any]:
        """Deterministic health report for the run (windowed series
        aggregates, fleet latency sketches, detector ledger); requires
        ``Simulation(..., health=True)``."""
        health = getattr(self.result, "health", None)
        if health is None:
            raise ValueError(
                "SimReport.health_summary needs a health-monitored run: "
                "pass health=True to the engine (result.health is None)"
            )
        return health.summary()

    def calibration(self):
        """Eq. 2 cost-model calibration: per-component residuals of this
        run's placement provenance against its measured spans (see
        ``core.healthplane.calibrate``)."""
        from repro_torch.core.healthplane import calibrate

        return calibrate(self)


# --------------------------------------------------------------------------
# Minimal JSON-Schema validator (dependency-free)
# --------------------------------------------------------------------------
def validate_schema(obj: Any, schema: Mapping[str, Any], path: str = "$"):
    """Validate ``obj`` against the subset of JSON Schema the checked-in
    schemas use (type, required, properties, items, enum, minimum,
    additionalProperties: false).  Raises ``ValueError`` naming the
    offending path.  Dependency-free so CI and the container need no
    ``jsonschema`` install."""
    types = {
        "object": dict, "array": list, "string": str, "boolean": bool,
        "null": type(None),
    }
    t = schema.get("type")
    if t is not None:
        ts = t if isinstance(t, list) else [t]
        ok = False
        for name in ts:
            if name == "number":
                ok = ok or (isinstance(obj, (int, float))
                            and not isinstance(obj, bool))
            elif name == "integer":
                ok = ok or (isinstance(obj, int)
                            and not isinstance(obj, bool))
            else:
                ok = ok or isinstance(obj, types[name])
        if not ok:
            raise ValueError(
                f"{path}: expected {t}, got {type(obj).__name__}"
            )
    if "enum" in schema and obj not in schema["enum"]:
        raise ValueError(f"{path}: {obj!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(obj, (int, float)) \
            and not isinstance(obj, bool) and obj < schema["minimum"]:
        raise ValueError(f"{path}: {obj} < minimum {schema['minimum']}")
    if "const" in schema and obj != schema["const"]:
        raise ValueError(f"{path}: {obj!r} != const {schema['const']!r}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                raise ValueError(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        for k, v in obj.items():
            if k in props:
                validate_schema(v, props[k], f"{path}.{k}")
            elif schema.get("additionalProperties") is False:
                raise ValueError(f"{path}: unexpected key {k!r}")
    if isinstance(obj, list) and "items" in schema:
        for i, v in enumerate(obj):
            validate_schema(v, schema["items"], f"{path}[{i}]")
