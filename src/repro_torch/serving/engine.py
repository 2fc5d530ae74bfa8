"""Serving cluster engine: Navigator-scheduled ML pipelines over real
PyTorch models, mirroring ``repro.serving.engine``.

Each *worker* hosts a GPU model cache (``GpuMemoryManager``) and an
execution queue; the Navigator scheduler places pipeline tasks from the
shared state table; the execution engine runs each task as a
teacher-forced prefill through ``decode_step`` followed by greedy decode,
replaying one CUDA graph of the step per (model, batch, cache capacity).

All workers share one physical device, so transfer and fetch *costs*
advance a virtual clock from the profiled cost model (exactly the
simulator's), while the model compute itself is real and its wall time is
measured.  The cluster's four options are the reference's: ``gossip``
(each worker plans from its own gossiped SST replica, ``GossipPlane``),
``prefetch`` (intent-driven speculative model fetches through each
worker's fetch pipe, ``PrefetchPlane``), ``trace`` (a ``FlightRecorder``
on the virtual clock) and ``health`` (a ``HealthMonitor`` whose digests
ride the SST rows).  A fifth, ``spans``, marks the engine's work in
PyTorch's profiler timeline on the wall clock (``torch.profiler.record_function``,
names under ``compass.``: each task's ``run_task``, and inside it the
``capture`` of a new graph, the ``zero_cache``, one ``replay`` a step and
the copy ``to_host``), where the profiler puts them on the clock of the
card's records; on a card the engine also times each task's replays with
one pair of CUDA events (``ExecutionEngine.task_times``).  Off, the served
path makes neither call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import ContextManager, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import (
    ClusterSpec,
    GpuMemoryManager,
    Job,
    NavigatorConfig,
    PrefetchConfig,
    PrefetchPlane,
    ProfileRepository,
    SharedStateTable,
)
from repro_torch.core.healthplane import HealthConfig, HealthMonitor
from repro_torch.core.scheduler import Scheduler, make_scheduler
from repro_torch.core.sst_exchange import GossipConfig, GossipPlane
from repro_torch.core.telemetry import FlightRecorder, TraceConfig
from repro_torch.core.types import DFG, MLModel
from repro_torch.device import Device, resolve_device
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import ModelConfig, ParamTree, decode_step, init_cache
from repro_torch.models.model import Cache

#: The kernel wrappers whose launch counters a capture reads, by name.
KERNELS = {"decode_attention": _da, "flash_attention": _fa, "ssd_scan": _ssd,
           "moe_gmm": _gmm}
#: (model id, batch, cache capacity): what a graph and a cache are kept by.
StepKey = Tuple[int, int, int]
#: The prefix of every profiler range the served path opens.
SPAN = "compass."
_NO_SPAN = contextlib.nullcontext()


def span(on: bool, name: str) -> ContextManager:
    """The profiler range ``compass.<name>`` where ``on``; where not, a
    context that does nothing."""
    return torch.profiler.record_function(SPAN + name) if on else _NO_SPAN


class TaskTime(NamedTuple):
    """One task's replays on the card, timed by a CUDA event before its
    first replay and one after its last: every replay of a key runs the
    same graph over the same positions."""

    key: StepKey
    replays: int
    #: Device seconds between the two events, gaps between replays included.
    device_s: float
    #: ``time.perf_counter()`` once the task's synchronise returned.
    host_s: float


@dataclasses.dataclass
class HostedModel:
    """A zoo model registered with the serving cluster; its params are
    moved to ``device`` if they lie elsewhere."""

    model_id: int
    cfg: ModelConfig
    params: ParamTree
    device: Device = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device)

    @property
    def size_bytes(self) -> float:
        """Bytes of all parameter tensors: the reference's per-leaf sum, so
        fetch costs and placements match it."""
        return float(sum(p.nbytes for p in self.params.parameters()))


@dataclasses.dataclass
class DecodeGraph:
    """One captured decode step of a model at one (batch, capacity): the
    step reads ``tokens`` and the cache it was captured on, and writes
    ``logits`` and their greedy argmax ``next``, all at fixed addresses.
    ``launches`` and ``by_body`` are the kernel launches one replay makes
    (by kernel, and by kernel and body), read from the wrappers' counters
    during the capture."""

    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor
    logits: torch.Tensor
    next: torch.Tensor
    launches: Dict[str, int]
    by_body: Dict[str, Dict[str, int]]
    capture_s: float
    pool_bytes: int
    replays: int = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


def _counters() -> Dict[str, Tuple[int, Dict[str, int]]]:
    return {name: (mod.launches, dict(mod.launches_by_body)) for name, mod in KERNELS.items()}


def _take_counts(before: Dict[str, Tuple[int, Dict[str, int]]]):
    """The launches counted since ``before``, by kernel and by kernel and
    body; the counters are set back to ``before``, since a capture only
    records the launches and each replay makes them."""
    launches, by_body = {}, {}
    for name, mod in KERNELS.items():
        n0, b0 = before[name]
        launches[name] = mod.launches - n0
        by_body[name] = {k: v - b0.get(k, 0) for k, v in mod.launches_by_body.items()
                         if v != b0.get(k, 0)}
        mod.launches = n0
        mod.launches_by_body.clear()
        mod.launches_by_body.update(b0)
    return launches, by_body


class ExecutionEngine:
    """Per-framework plug-in layer (§3): here, one plug-in — PyTorch.

    On a CUDA device every decode step is a replay of a CUDA graph: the
    counterpart of the reference's ``jax.jit`` of ``decode_step``
    (``ExecutionEngine._get_step``), and kept, as the jit cache keeps its
    compilations, by model, batch and cache capacity.  A graph holds one
    ``decode_step`` and its argmax.  MoE layers decode with the ``sorted``
    dispatch on a card, so that a step reads only the routed experts'
    weights (the grouped-matmul kernel), and with ``scan`` on the CPU, as
    the reference serves MoE (``moe_dispatch``).  A graph is captured at
    first use, after one eager warm-up
    step on the capture stream that builds and loads every kernel it runs
    (those launches are real and counted by the wrappers as such), under
    ``torch.cuda.set_sync_debug_mode("error")``, so nothing on the step
    waits for the card; it has its own memory pool.  A capture or replay
    that fails raises: nothing carries on eagerly.

    The cache of each (model, batch, capacity) is allocated once and
    zeroed before each task, on the CPU too, so that a graph reads it at
    fixed addresses.  The wrappers' counters count calls of their Python
    code, so the engine moves a capture's count out of them and into the
    graph (``DecodeGraph.launches``); ``replayed_launches`` and
    ``replayed_by_body`` are the launches its replays made.
    """

    def __init__(
        self,
        models: Dict[int, HostedModel],
        decode_tokens: int = 8,
        *,
        device: Device = "cuda",
        impl: str = "auto",
        spans: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        for mid, h in models.items():
            if h.device != self.device:
                raise ValueError(
                    f"model {mid} is hosted on {h.device}, the engine runs on {self.device}"
                )
        if self.device.type == "cuda":
            # fp32 matmuls in full precision (no TF32), so fp32 tokens match
            # the reference's.  This is PyTorch's default; it is set here so
            # that nothing else in the process can change it unseen.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.models = models
        self.decode_tokens = decode_tokens
        self.impl = impl
        #: The MoE dispatch of every decode step, by the device.
        self.moe_dispatch = "sorted" if self.device.type == "cuda" else "scan"
        self.caches: Dict[StepKey, Cache] = {}
        self.graphs: Dict[StepKey, DecodeGraph] = {}
        self.captures = 0
        self._stream: Optional["torch.cuda.Stream"] = None
        self._spans = spans
        #: With ``spans`` on a card: one entry a task since the counts were
        #: last reset.
        self.task_times: List[TaskTime] = []
        self._events: Optional[Tuple["torch.cuda.Event", "torch.cuda.Event"]] = None

    # -- graphs and caches ---------------------------------------------------------
    def _cache(self, key: StepKey) -> Cache:
        """The cache of ``key``, allocated at first use."""
        if key not in self.caches:
            mid, b, capacity = key
            self.caches[key] = init_cache(self.models[mid].cfg, b, capacity, device=self.device)
        return self.caches[key]

    def _graph(self, key: StepKey, cache: Cache) -> DecodeGraph:
        """Capture the graph of ``key`` over ``cache``.  The warm-up step
        writes into ``cache``: the caller zeroes it after."""
        hosted = self.models[key[0]]
        tokens = torch.zeros(key[1], dtype=torch.long, device=self.device)

        def step():
            logits, _ = decode_step(hosted.params, cache, tokens, hosted.cfg, impl=self.impl,
                                    moe_dispatch=self.moe_dispatch)
            return logits, torch.argmax(logits, dim=-1)

        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            step()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = _counters()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self._stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits, nxt = step()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        capture_s = time.perf_counter() - t0
        launches, by_body = _take_counts(before)
        g = DecodeGraph(graph, tokens, logits, nxt, launches, by_body, capture_s,
                        torch.cuda.memory_reserved(self.device) - reserved)
        self.graphs[key] = g
        self.captures += 1
        return g

    @property
    def replays(self) -> int:
        """Graph replays since the counts were last reset."""
        return sum(g.replays for g in self.graphs.values())

    @property
    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches made by the graphs' replays, by kernel."""
        return {name: sum(g.launches[name] * g.replays for g in self.graphs.values())
                for name in KERNELS}

    @property
    def replayed_by_body(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches made by the graphs' replays, by kernel and body."""
        out: Dict[str, Dict[str, int]] = {name: {} for name in KERNELS}
        for g in self.graphs.values():
            for name, bodies in g.by_body.items():
                for body, n in bodies.items():
                    out[name][body] = out[name].get(body, 0) + n * g.replays
        return out

    def reset_counts(self) -> None:
        """Set every graph's replay count to 0, and drop the task times."""
        for g in self.graphs.values():
            g.replays = 0
        self.task_times.clear()

    def close(self) -> None:
        """Drop every graph and cache, and with them their device memory."""
        self.graphs.clear()
        self.caches.clear()
        self._stream = None

    # -- tasks -------------------------------------------------------------------------
    @torch.inference_mode()
    def run_task(self, mid: int, prompt: np.ndarray) -> Tuple[np.ndarray, float]:
        """Prefill ``prompt`` then greedily decode a few tokens.  Returns
        (generated token ids (B, decode_tokens) int32, wall seconds)."""
        hosted = self.models[mid]
        t0 = time.perf_counter()
        on = self._spans
        b, s = prompt.shape
        with span(on, "run_task"):
            key = (mid, b, s + self.decode_tokens + 1)
            cache = self._cache(key)
            toks = torch.as_tensor(prompt, device=self.device)
            cuda = self.device.type == "cuda"
            if cuda:
                g = self.graphs.get(key)
                if g is None:
                    with span(on, "capture"):
                        g = self._graph(key, cache)

                def step(tokens: torch.Tensor) -> torch.Tensor:
                    g.tokens.copy_(tokens)
                    g.replay()
                    return g.next
            else:
                def step(tokens: torch.Tensor) -> torch.Tensor:
                    logits, _ = decode_step(hosted.params, cache, tokens, hosted.cfg,
                                            impl=self.impl, moe_dispatch=self.moe_dispatch)
                    return torch.argmax(logits, dim=-1)
            with span(on, "zero_cache"):
                for t in cache.values():  # the last task's, or the capture's warm-up step
                    t.zero_()
            timed = on and cuda
            if timed:
                if self._events is None:
                    self._events = (torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))
                self._events[0].record()
            out = []
            # teacher-forced prefill through the decode path (seeds the cache)
            for i in range(s):
                with span(on, "replay"):
                    nxt = step(toks[:, i])
            for _ in range(self.decode_tokens):
                with span(on, "replay"):
                    out.append(nxt.clone())
                    nxt = step(nxt)
            if timed:
                self._events[1].record()
            if cuda:
                torch.cuda.synchronize(self.device)
            if timed:
                self.task_times.append(TaskTime(
                    key, s + self.decode_tokens,
                    self._events[0].elapsed_time(self._events[1]) / 1e3, time.perf_counter()))
            with span(on, "to_host"):
                tokens = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return tokens, time.perf_counter() - t0


@dataclasses.dataclass
class RequestResult:
    job_id: int
    dfg_name: str
    latency_s: float
    virtual_latency_s: float
    outputs: Dict[str, np.ndarray]
    assignment: Dict[str, int]


class ServingCluster:
    """N Navigator workers serving pipeline requests over hosted models."""

    def __init__(
        self,
        cluster: ClusterSpec,
        hosted: Sequence[HostedModel],
        scheduler: str = "navigator",
        navigator_config: Optional[NavigatorConfig] = None,
        decode_tokens: int = 8,
        gossip: Optional[GossipConfig] = None,
        prefetch: Optional[PrefetchConfig] = None,
        trace: Union[bool, TraceConfig] = False,
        health: Union[bool, HealthConfig] = False,
        spans: bool = False,
        *,
        device: Device = "cuda",
        impl: str = "auto",
    ) -> None:
        dev = resolve_device(device)
        self.cluster = cluster
        self.hosted = {h.model_id: h for h in hosted}
        self.catalog = {
            mid: MLModel(mid, h.cfg.name, h.size_bytes)
            for mid, h in self.hosted.items()
        }
        self.profiles = ProfileRepository(cluster, self.catalog)
        self.scheduler: Scheduler = make_scheduler(
            scheduler, self.profiles, navigator_config
        )
        # Flight recorder (core/telemetry.py): events land on the virtual
        # clock, so serving traces line up with simulator traces of the
        # same workload; placement provenance comes from the scheduler.
        self.recorder: Optional[FlightRecorder] = None
        if trace:
            self.recorder = FlightRecorder(
                cluster.n_workers,
                trace if isinstance(trace, TraceConfig) else None,
            )
            self.scheduler.recorder = self.recorder
        # Health plane (core/healthplane.py) on the virtual clock: same
        # zero-overhead-when-off ``is not None`` guard as the recorder.
        self.health: Optional[HealthMonitor] = None
        if health:
            self.health = HealthMonitor(
                cluster.n_workers,
                health if isinstance(health, HealthConfig) else None,
                recorder=self.recorder,
            )
        # ``gossip`` swaps the single-snapshot table for the decentralized
        # per-worker view plane: the planner then reads the *origin
        # worker's* replica, which lags peers by up to a gossip period.
        self.gossip = gossip
        if gossip is not None:
            self.sst = GossipPlane(cluster.n_workers, gossip)
        else:
            self.sst = SharedStateTable(cluster.n_workers)
        self.memories = [
            GpuMemoryManager(
                cluster.gpu_capacity(w),
                self.catalog,
                cluster.link,
                compression_ratio=cluster.compression_ratio,
            )
            for w in cluster.workers()
        ]
        self.engine = ExecutionEngine(
            self.hosted, decode_tokens, device=dev, impl=impl, spans=spans
        )
        self._vclock = [0.0] * cluster.n_workers  # per-worker virtual time
        # Predictive prefetch plane (core/prefetch.py) on the virtual
        # clock: planned intents stage models through the per-worker fetch
        # pipe *before* their tasks reach the front of the queue.
        self.prefetch_plane: Optional[PrefetchPlane] = None
        if prefetch is not None:
            self.prefetch_plane = PrefetchPlane(
                cluster.n_workers, prefetch,
                fetch_time_fn=self.profiles.td_model,
            )
        self._pipe_free_at = [0.0] * cluster.n_workers
        # worker -> {model_id: virtual time the speculative transfer lands}
        self._prefetch_ready_at: List[Dict[int, float]] = [
            {} for _ in cluster.workers()
        ]
        self._jobid = 0
        for w in cluster.workers():
            self.sst.update_cache(w, 0, cluster.gpu_capacity(w), 0.0)
            self.sst.push(w, 0.0)
        self.results: List[RequestResult] = []

    # -- pipeline registration --------------------------------------------------
    def register_pipeline(self, dfg: DFG) -> None:
        self.profiles.register(dfg)

    # -- request handling ----------------------------------------------------------
    def submit(
        self, dfg: DFG, inputs: Dict[str, np.ndarray], origin: int = 0
    ) -> RequestResult:
        """Schedule + execute one pipeline request synchronously.

        ``inputs`` maps entry-task ids → prompt token arrays (B, S)."""
        now = max(self._vclock)
        job = Job(self._jobid, dfg, arrival_time=now)
        self._jobid += 1
        if self.gossip is not None:
            # Run the gossip rounds due up to the request's arrival; the
            # origin worker then plans from its own (possibly stale) view.
            self.sst.advance(now)
        adfg = self.scheduler.plan(job, now, origin, self.sst.view(origin))
        if adfg is None:
            raise NotImplementedError("serving engine drives planned schedulers")
        if self.prefetch_plane is not None:
            self._issue_prefetches(job, adfg, now)
        rec = self.recorder
        if rec is not None:
            # Cluster-scope lifecycle events ride the GLOBAL ring, same
            # as the simulator (parity-tested: identical taxonomy).
            rec.emit(now, "job.arrive", job=job.job_id,
                     dfg=dfg.name, origin=origin, n_tasks=len(dfg.tasks))

        wall0 = time.perf_counter()
        outputs: Dict[str, np.ndarray] = {}
        finish: Dict[str, float] = {}
        for ti, tid in enumerate(dfg.topo_order):
            task = dfg.tasks[tid]
            w = adfg[tid]
            mem = self.memories[w]
            start = max(
                self._vclock[w],
                max((finish[p] for p in dfg.preds[tid]), default=now),
            )
            # transfer delay for remote inputs
            for p in dfg.preds[tid]:
                if adfg[p] != w:
                    dur = self.cluster.network.transfer_time(
                        dfg.tasks[p].output_bytes
                    )
                    start += dur
                    if rec is not None:
                        rec.emit(finish[p], "net.xfer", worker=adfg[p],
                                 dst=w, bytes=dfg.tasks[p].output_bytes,
                                 dur=dur, scope="flat", share=1.0)
                    if self.health is not None:
                        self.health.on_transfer(
                            finish[p], "flat", dfg.tasks[p].output_bytes,
                            1.0, cross=False,
                        )
            if rec is not None:
                if not dfg.preds[tid]:
                    rec.emit(now, "task.input", worker=w, job=job.job_id,
                             task=tid, gen=0, src="", frm=origin, to=w,
                             arrive=now)
                else:
                    for p in dfg.preds[tid]:
                        arrive = finish[p] if adfg[p] == w else start
                        rec.emit(arrive, "task.input", worker=w,
                                 job=job.job_id, task=tid, gen=0, src=p,
                                 frm=adfg[p], to=w, arrive=arrive)
            was_miss = False
            if task.model_id is not None:
                upcoming = [task.model_id]
                res = mem.ensure(task.model_id, upcoming)
                ready = (
                    self._prefetch_ready_at[w].pop(task.model_id, None)
                    if self.prefetch_plane is not None
                    else None
                )
                if res is not None:
                    fetch_s, _ = res
                    was_miss = fetch_s > 0.0
                    if rec is not None and fetch_s > 0.0:
                        rec.emit(start, "fetch.start", worker=w,
                                 fetch_kind="demand", model=task.model_id,
                                 bytes=mem.cached_size(task.model_id),
                                 dur=fetch_s, job=job.job_id, task=tid)
                        rec.emit(start + fetch_s, "fetch.done", worker=w,
                                 model=task.model_id, spec=False)
                    if self.health is not None and fetch_s > 0.0:
                        self.health.fetch_state(w, start, True)
                        self.health.fetch_state(w, start + fetch_s, False)
                    if fetch_s > 0.0 and self.prefetch_plane is not None:
                        # Demand miss: demand preempts speculation on the
                        # single fetch pipe — the transfer starts now, and
                        # every speculative transfer still in flight is
                        # pushed back behind it.
                        t0 = start
                        start += fetch_s
                        self._pipe_free_at[w] = max(
                            self._pipe_free_at[w] + fetch_s, start
                        )
                        for m, t in self._prefetch_ready_at[w].items():
                            if t > t0:
                                self._prefetch_ready_at[w][m] = t + fetch_s
                    elif fetch_s > 0.0:
                        start += fetch_s
                    elif ready is not None:
                        # Cache hit thanks to a speculative transfer that
                        # may still be in flight on the virtual clock.
                        start = max(start, ready)
                        if rec is not None:
                            rec.emit(start, "fetch.promote", worker=w,
                                     model=task.model_id, job=job.job_id,
                                     task=tid)
                self.sst.update_cache(w, mem.bitmap, mem.free_bytes, start)
                if self.health is not None:
                    self.health.sample_memory(
                        w, start,
                        (mem.used_bytes + mem.exec_reserved_bytes)
                        / mem.capacity_bytes
                        if mem.capacity_bytes > 0 else 0.0,
                        mem.stats.evictions,
                    )
                if self.prefetch_plane is not None:
                    self.sst.update_intent(
                        w,
                        mem.bitmap | self.prefetch_plane.advertised_bits(w),
                        start,
                    )
                prompt = self._task_input(tid, dfg, inputs, outputs)
                out, wall = self.engine.run_task(task.model_id, prompt)
                outputs[tid] = out
                runtime = wall
            else:
                # host-side aggregation vertex
                preds = dfg.preds[tid]
                outputs[tid] = np.concatenate(
                    [outputs[p] for p in preds], axis=-1
                ) if preds else np.zeros((1, 0), np.int32)
                runtime = 1e-4
            finish[tid] = start + runtime
            if rec is not None:
                rec.emit(start, "task.start", worker=w, job=job.job_id,
                         task=tid, gen=0,
                         model=-1 if task.model_id is None else task.model_id,
                         miss=was_miss)
                rec.emit(finish[tid], "task.done", worker=w, job=job.job_id,
                         task=tid, gen=0)
            self._vclock[w] = finish[tid]
            self.sst.update_load(w, self._vclock[w], finish[tid])
            if self.health is not None:
                # Virtual-queue depth: this job's tasks still bound to w
                # (including the one just finished draining to 0 marks
                # the backlog the next probe would see).
                depth = sum(
                    1 for t2 in dfg.topo_order[ti + 1:] if adfg[t2] == w
                )
                self.health.sample_queue(w, finish[tid], depth)
                self.health.task_done(
                    w, finish[tid], runtime,
                    self.profiles.runtime(task, w),
                )
                # Digest refresh rides the publication, same as the sim.
                d = self.health.digest(w, finish[tid])
                self.sst.update_health(
                    w, d.queue_depth, d.mem_occupancy, d.fetch_util,
                    d.p99_latency_s, finish[tid],
                )
            if self.gossip is not None:
                self.sst.advance(finish[tid])
            else:
                self.sst.push(w, finish[tid])
        t_end = max(finish.values())
        if rec is not None:
            rec.emit(t_end, "job.done", job=job.job_id,
                     latency=t_end - now)
        if self.health is not None:
            self.health.job_done(t_end, t_end - now)
        result = RequestResult(
            job_id=job.job_id,
            dfg_name=dfg.name,
            latency_s=time.perf_counter() - wall0,
            virtual_latency_s=max(finish.values()) - now,
            outputs=outputs,
            assignment=dict(adfg.assignment),
        )
        self.results.append(result)
        return result

    def _issue_prefetches(self, job: Job, adfg, now: float) -> None:
        """Virtual-clock analogue of the simulator's speculative fetch
        path: every intended model is staged through the worker's fetch
        pipe at plan time, so by the time its task reaches the front of
        the queue the transfer has (partially) overlapped queue wait."""
        plane = self.prefetch_plane
        assert plane is not None
        per = plane.plan_intents(job, adfg, self.profiles, now)
        for w, intents in per.items():
            plane.admit(w, intents, now)
            mem = self.memories[w]
            t_pipe = max(now, self._pipe_free_at[w])
            while True:
                intent, _ = plane.next_intent(w, now, mem.has, 0)
                if intent is None:
                    break
                res = mem.begin_prefetch(
                    intent.model_id,
                    allow_evict=plane.config.evict_for_prefetch,
                )
                if res is None:
                    # No room: fall back to demand fetching at task start.
                    plane.stall_inflight(w, now)
                    break
                fetch_s, _ = res
                if self.recorder is not None:
                    # Same key set as the simulator's speculative
                    # fetch.start (no job/task: nothing demanded it yet).
                    self.recorder.emit(
                        t_pipe, "fetch.start", worker=w,
                        fetch_kind="prefetch", model=intent.model_id,
                        bytes=mem.cached_size(intent.model_id),
                        dur=fetch_s,
                    )
                if self.health is not None:
                    self.health.fetch_state(w, t_pipe, True)
                t_pipe += fetch_s
                if self.recorder is not None:
                    self.recorder.emit(t_pipe, "fetch.done", worker=w,
                                       model=intent.model_id, spec=True)
                if self.health is not None:
                    self.health.fetch_state(w, t_pipe, False)
                mem.complete_prefetch(intent.model_id)
                plane.complete_inflight(w)
                self._prefetch_ready_at[w][intent.model_id] = t_pipe
            self._pipe_free_at[w] = t_pipe
            self.sst.update_cache(w, mem.bitmap, mem.available_bytes, now)
            self.sst.update_intent(
                w, mem.bitmap | plane.advertised_bits(w), now
            )

    def _task_input(self, tid, dfg, inputs, outputs) -> np.ndarray:
        if not dfg.preds[tid]:
            return inputs[tid]
        parts = [outputs[p] for p in dfg.preds[tid]]
        return np.concatenate(parts, axis=1)

    # -- metrics ---------------------------------------------------------------------
    def cache_hit_rate(self) -> float:
        hits = sum(m.stats.hits for m in self.memories)
        total = hits + sum(m.stats.misses for m in self.memories)
        return hits / total if total else 1.0

    def workers_used(self) -> List[int]:
        return [
            w
            for w in self.cluster.workers()
            if self.memories[w].stats.hits + self.memories[w].stats.misses > 0
        ]
