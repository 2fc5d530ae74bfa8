"""Vectorized Navigator planning (Alg. 1) in PyTorch, on the card.

The counterpart of the JAX package's ``core/jax_planner.py``.  The Python
planner loops over workers per task; here the worker dimension is a
torch vector, so the per-task argmin (Alg. 1 lines 7–11) becomes a vector
min over W.  Task order (upward ranks) is static per DFG, so the task loop
is a Python loop of a few (W,) vector ops per task; W can be hundreds (the
Fig. 10 regime).

On a card, :class:`TorchNavigatorPlanner` captures that loop once per
(DFG, ``return_components``) as a CUDA graph and replays it, which is the
counterpart of the reference's ``jax.jit`` (keyed on the static inputs,
the config, W, the worker speeds and ``return_components``; the config
and W are fixed per planner, and ``plan`` passes no speeds).  A graph reads
the feed from fixed device buffers that one host→device copy fills per
plan; capture follows one eager warm-up and runs under
``torch.cuda.set_sync_debug_mode("error")``.  On the CPU the loop runs
eagerly.  Graph and eager runs launch the same kernels and agree bit for
bit.

Arithmetic is float32 throughout, as the reference's (JAX without x64):
scalars taken from :class:`StaticPlanInputs` are computed in numpy on the
host, as the reference's trace folds them, and only the (W,) vector ops
run in torch.  The worker index chosen for a task stays a device tensor
through the rest of the plan, so nothing inside the task loop waits for
the card.

Equivalence with the Python planner and with the JAX planner is tested
in ``tests/test_torch_planner.py``.  Neither package's serving engine
plans with this planner (``ServingCluster`` uses the Python Navigator).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packed import PackedViews
from repro_torch.core.profiles import ProfileRepository
from repro_torch.core.scheduler import NavigatorConfig
from repro_torch.core.state import DEAD, SUSPECT
from repro_torch.core.types import ADFG, DFG, Job
from repro_torch.device import Device, resolve_device

# (64,) shift vector for the vectorized bitmap → (W, 64) bool unpack,
# done in numpy on the host.
_BIT_SHIFTS = np.arange(64, dtype=np.uint64)
_INF = float("inf")


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: cached per DFG
class StaticPlanInputs:
    """Per-DFG static arrays (built once per DFG, cached)."""

    order: Tuple[str, ...]                 # tasks in rank order
    runtimes: np.ndarray                   # (T,) base R(t)
    model_ids: np.ndarray                  # (T,) int, -1 = no model
    fetch_times: np.ndarray                # (T,) TD_model on miss
    cached_sizes: np.ndarray               # (T,) compressed model bytes
    full_sizes: np.ndarray                 # (T,) decompressed model bytes
    td_outputs: np.ndarray                 # (T,) TD_output(t)
    td_inputs: np.ndarray                  # (T,) TD_input(t) (entry tasks)
    output_bytes: np.ndarray               # (T,) raw output sizes (topology)
    input_bytes: np.ndarray                # (T,) raw input sizes (topology)
    preds: Tuple[Tuple[int, ...], ...]     # indices into `order`
    is_entry: np.ndarray                   # (T,) bool


def build_static_inputs(
    profiles: ProfileRepository, dfg: DFG
) -> StaticPlanInputs:
    order = tuple(profiles.rank_order(dfg))
    pos = {t: i for i, t in enumerate(order)}
    t_arr = [dfg.tasks[t] for t in order]
    preds = tuple(
        tuple(pos[p] for p in dfg.preds[t]) for t in order
    )
    return StaticPlanInputs(
        order=order,
        runtimes=np.array([t.runtime_s for t in t_arr], np.float32),
        model_ids=np.array(
            [-1 if t.model_id is None else t.model_id for t in t_arr], np.int32
        ),
        fetch_times=np.array(
            [profiles.td_model(t.model_id) for t in t_arr], np.float32
        ),
        cached_sizes=np.array(
            [profiles.cached_model_size(t.model_id) for t in t_arr], np.float32
        ),
        full_sizes=np.array(
            [profiles.model_size(t.model_id) for t in t_arr], np.float32
        ),
        td_outputs=np.array(
            [profiles.td_output(t) for t in t_arr], np.float32
        ),
        td_inputs=np.array(
            [profiles.td_input(t) for t in t_arr], np.float32
        ),
        output_bytes=np.array(
            [t.output_bytes for t in t_arr], np.float32
        ),
        input_bytes=np.array(
            [t.input_bytes for t in t_arr], np.float32
        ),
        preds=preds,
        is_entry=np.array([not p for p in preds], bool),
    )


def _f32(x) -> float:
    """A host scalar rounded to float32, as the reference's trace folds
    numpy scalars into the computation (exact as a Python float)."""
    return float(np.float32(x))


def _pick(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx]`` for a 0-d device index, without reading it on the host."""
    return v.index_select(0, idx.view(1)).squeeze(0)


def plan_vectorized(
    static: StaticPlanInputs,
    config: NavigatorConfig,
    n_workers: int,
    ft0: torch.Tensor,          # (W,) worker_FT_map (absolute seconds)
    cache_bits: torch.Tensor,   # (W, 64) bool — SST cache bitmaps
    avc0: torch.Tensor,         # (W,) free cache bytes
    now: torch.Tensor,          # 0-d float32
    origin_worker: torch.Tensor,  # 0-d int64
    worker_speed: Optional[Tuple[float, ...]] = None,
    intent_bits: Optional[torch.Tensor] = None,   # (W, 64) bool
    intent_fresh: Optional[torch.Tensor] = None,  # (W,) bool — row fresh
    gpu_capacity: Optional[torch.Tensor] = None,  # (W,) bytes; None = unbounded
    liveness_cost: Optional[torch.Tensor] = None,  # (W,) s; membership lane:
    # 0 = ALIVE, suspect_penalty_s = SUSPECT, +inf = DEAD/draining
    xfer_inv_bw: Optional[torch.Tensor] = None,   # (W, W) path 1/bandwidth;
    # None = flat all-pairs table (static.td_inputs / td_outputs)
    xfer_delta: Optional[torch.Tensor] = None,    # (W, W) path latency
    fetch_model: Optional[torch.Tensor] = None,   # (W,) in-flight fetch
    # model id per worker (−1 = none) — expected-completion intent lane
    fetch_eta: Optional[torch.Tensor] = None,     # (W,) absolute fetch ETA
    return_components: bool = False,  # also return stacked (T, W) Eq. 2
    # component arrays (queue, at, td_model, intent discount, runtime,
    # selection cost) for placement provenance — tracing-on path only
) -> Tuple[torch.Tensor, ...]:
    """Returns (assignment (T,) int64, planned_ft (T,) float32[, components]).

    Every tensor argument lies on one device; without ``worker_speed`` the
    call makes no host transfer and reads nothing back, so it can be
    captured in a graph."""
    t_count = len(static.order)
    dev = ft0.device
    f32 = torch.float32
    lanes = torch.arange(n_workers, device=dev)
    speed = (
        torch.ones((n_workers,), dtype=f32, device=dev)
        if worker_speed is None
        else torch.tensor(worker_speed, dtype=f32).to(dev)
    )
    ft = torch.maximum(ft0, now)
    use_intents = intent_bits is not None and config.intent_confidence > 0.0
    if intent_fresh is None:
        intent_fresh = torch.zeros((n_workers,), dtype=torch.bool, device=dev)
    no_bits = torch.zeros((n_workers,), dtype=torch.bool, device=dev)
    # Only the DFG's models' bitmap columns are read or set.
    mids = sorted({int(m) for m in static.model_ids if m >= 0})
    bits = {m: cache_bits[:, m] for m in mids}
    ibits = {
        m: (no_bits if intent_bits is None else intent_bits[:, m]) for m in mids
    }
    avc = avc0
    assign: List[torch.Tensor] = []
    task_ft: List[torch.Tensor] = []
    comps: List[Tuple[torch.Tensor, ...]] = []

    for ti in range(t_count):
        r_w = _f32(static.runtimes[ti]) / speed               # R(t, w)
        mid = int(static.model_ids[ti])
        # AT_allInputs (Eq. 3-4).
        if static.is_entry[ti]:
            if xfer_inv_bw is None:
                ship = _f32(static.td_inputs[ti])
            else:
                # Path cost of the client input: origin → each worker.
                ship = (
                    _f32(static.input_bytes[ti]) * _pick(xfer_inv_bw, origin_worker)
                    + _pick(xfer_delta, origin_worker)
                )
            at = now + torch.where(lanes == origin_worker, 0.0, ship)
        else:
            at = torch.zeros((n_workers,), dtype=f32, device=dev)
            for pi in static.preds[ti]:
                ft_p = task_ft[pi]
                w_p = assign[pi]
                if xfer_inv_bw is None:
                    ship = _f32(static.td_outputs[pi])
                else:
                    ship = (
                        _f32(static.output_bytes[pi]) * _pick(xfer_inv_bw, w_p)
                        + _pick(xfer_delta, w_p)
                    )
                arrival = ft_p + torch.where(lanes == w_p, 0.0, ship)
                at = torch.maximum(at, arrival)
        x = torch.maximum(ft, at)                             # line 8
        hit = no_bits
        intent_m = no_bits
        undiscounted = None
        fetch_s = _f32(static.fetch_times[ti])
        if mid < 0 or not config.use_model_locality:
            td_model = (
                torch.zeros((n_workers,), dtype=f32, device=dev)
                if mid < 0
                else torch.full((n_workers,), fetch_s, dtype=f32, device=dev)
            )
        else:
            hit = bits[mid]
            intent_m = ibits[mid] & intent_fresh
            fits = _f32(static.cached_sizes[ti]) <= avc
            # Eq. 2 third case: mean refetch cost of resident models.
            if config.eviction_penalty_s is not None:
                penalty = _f32(config.eviction_penalty_s)
            else:
                # approximate resident-model refetch with this model's own
                # fetch time (vector-friendly surrogate; exact per-worker
                # catalogue means are maintained by the Python planner).
                penalty = fetch_s
            miss_cost = fetch_s + torch.where(fits, 0.0, penalty)
            undiscounted = miss_cost
            if use_intents:
                # Prefetch plane: intended models cost the undiscounted
                # remainder of the fetch (core/prefetch.py).  The product
                # is the reference's numpy expression, then float32.
                miss_cost = torch.where(
                    intent_m,
                    _f32(static.fetch_times[ti] * (1.0 - config.intent_confidence)),
                    miss_cost,
                )
                if fetch_model is not None and fetch_eta is not None:
                    # Expected-completion lane: when the advertised
                    # *in-flight* fetch is this model, price the true
                    # remaining overlap past the task's earliest start —
                    # a nearly-done fetch costs ≈ 0, a just-started one
                    # ≈ the full fetch (mirrors Scheduler._td_model).
                    inflight = intent_m & (fetch_model == mid) & (fetch_eta > 0.0)
                    remaining = torch.clamp(fetch_eta - x, 0.0, fetch_s)
                    miss_cost = torch.where(inflight, remaining, miss_cost)
            td_model = torch.where(hit, 0.0, miss_cost)
        ftw = x + td_model + r_w                              # line 9
        if mid >= 0 and gpu_capacity is not None:
            # Static feasibility: cached + decompressed must fit the GPU
            # (mirrors ProfileRepository.model_fits).
            need = _f32(static.cached_sizes[ti] + static.full_sizes[ti])
            ftw = torch.where(need <= gpu_capacity, ftw, _INF)
        # Membership risk biases selection only; the recorded finish
        # estimates (planned_ft / ft_map) stay time-shaped.
        cost = ftw if liveness_cost is None else ftw + liveness_cost
        w_min = torch.argmin(cost)                            # line 10
        if (
            mid >= 0
            and config.use_model_locality
            and config.intent_herd_margin > 0.0
        ):
            # Anti-herd stickiness (mirrors Scheduler._herd_sticky_choice):
            # move to the cheapest holder/intender unless the plain argmin
            # beats it by more than the margin.
            have = hit | intent_m
            cost_have = torch.where(have, cost, _INF)
            alt = torch.argmin(cost_have)
            use_alt = (
                torch.any(have)
                & ~_pick(have, w_min)
                & (_pick(cost_have, alt)
                   <= _pick(cost, w_min) * _f32(1.0 + config.intent_herd_margin))
            )
            w_min = torch.where(use_alt, alt, w_min)
        ft_min = _pick(ftw, w_min)
        if return_components:
            base_td = (
                td_model if undiscounted is None
                else torch.where(hit, 0.0, undiscounted)
            )
            comps.append((
                ft,                                    # queue (pre-update)
                at,
                td_model,
                torch.clamp_min(base_td - td_model, 0.0),  # intent discount
                r_w,
                cost,
            ))
        assign.append(w_min)
        task_ft.append(ft_min)
        chosen = lanes == w_min
        ft = torch.where(chosen, ft_min, ft)                  # line 12
        if mid >= 0 and config.speculative_cache:
            newly = ~_pick(bits[mid], w_min)
            bits[mid] = bits[mid] | chosen
            avc = torch.where(
                chosen & newly, avc - _f32(static.cached_sizes[ti]), avc
            )
            avc = torch.clamp_min(avc, 0.0)
    out = (torch.stack(assign), torch.stack(task_ft))
    if return_components:
        return out + tuple(torch.stack([c[k] for c in comps]) for k in range(6))
    return out


class _Feed:
    """The plan's feed at fixed addresses: one host buffer (pinned on a
    card) and its device copy, moved in one transfer per plan.  A float32
    section holds ft0, avc0, liveness, fetch model and ETA (W each), now and
    the origin; a bool section the cache and intent bitmaps (W × 64 each)
    and the freshness lane."""

    def __init__(self, n: int, device: torch.device) -> None:
        self.n = n
        self.nf = 5 * n + 2
        nbytes = 4 * self.nf + 129 * n
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.host = host
        self.dev = host if device.type == "cpu" else torch.empty(
            nbytes, dtype=torch.uint8, device=device
        )
        raw = host.numpy()
        self.host_f = raw[: 4 * self.nf].view(np.float32)
        self.host_b = raw[4 * self.nf:].view(np.bool_)
        f = self.dev[: 4 * self.nf].view(torch.float32)
        b = self.dev[4 * self.nf:].view(torch.bool)
        self.ft0, self.avc0, self.live, self.fetch_model, self.fetch_eta = (
            f[i * n:(i + 1) * n] for i in range(5)
        )
        self.now = f[5 * n]
        self.origin_f = f[5 * n + 1]
        self.bits = b[: 64 * n].view(n, 64)
        self.ibits = b[64 * n: 128 * n].view(n, 64)
        self.fresh = b[128 * n:]

    def load(self, feed, now: float, origin: int) -> None:
        bits, ibits, fresh, live, ft0, avc0, fetch_model, fetch_eta = feed
        n = self.n
        hf = self.host_f
        for i, a in enumerate((ft0, avc0, live, fetch_model, fetch_eta)):
            hf[i * n:(i + 1) * n] = a
        hf[5 * n] = np.float32(now)
        hf[5 * n + 1] = origin
        hb = self.host_b
        hb[: 64 * n] = bits.reshape(-1)
        hb[64 * n: 128 * n] = ibits.reshape(-1)
        hb[128 * n:] = fresh
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)


@dataclasses.dataclass
class PlanGraph:
    """One captured plan of a DFG: it reads the planner's feed and writes
    ``out`` (assignment, planned_ft[, components]) at fixed addresses."""

    graph: "torch.cuda.CUDAGraph"
    out: Tuple[torch.Tensor, ...]
    capture_s: float
    replays: int = 0

    def replay(self) -> Tuple[torch.Tensor, ...]:
        self.graph.replay()
        self.replays += 1
        return self.out


class TorchNavigatorPlanner:
    """Drop-in planning-phase replacement built on ``plan_vectorized``,
    on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        profiles: ProfileRepository,
        config: Optional[NavigatorConfig] = None,
        *,
        device: Device = "cuda",
    ) -> None:
        self.profiles = profiles
        self.config = config or NavigatorConfig()
        self.device = resolve_device(device)
        self._static: Dict[str, StaticPlanInputs] = {}
        # Flight-recorder hook (see Scheduler.recorder): when set, plan()
        # asks for the stacked Eq. 2 component arrays and records one
        # PlacementDecision per task.  Graphs are kept per
        # ``return_components``, so the tracing-off plan is unchanged.
        self.recorder = None
        n = profiles.cluster.n_workers
        self._feed = _Feed(n, self.device)
        # Topology path-cost matrices (uncontended planner view); None on
        # flat clusters so the plan keeps the all-pairs-table code path.
        topo = profiles.cluster.topology
        self._xfer_inv_bw = self._xfer_delta = None
        if topo is not None:
            inv_bw, delta = topo.pair_matrices()
            self._xfer_inv_bw = torch.as_tensor(
                np.asarray(inv_bw, np.float32)).to(self.device)
            self._xfer_delta = torch.as_tensor(
                np.asarray(delta, np.float32)).to(self.device)
        # Static per-worker feasibility input, built once per planner.
        self._gpu_capacity = torch.as_tensor(np.asarray(
            [profiles.cluster.gpu_capacity(w) for w in range(n)], np.float32
        )).to(self.device)
        self.graphs: Dict[Tuple[str, bool], PlanGraph] = {}
        self._pool = None
        self._stream = None

    def _pack_feed(self, sst, now: float, n: int):
        """SST → feed arrays, unpacked on the host in numpy.  A
        :class:`PackedViews` read (the indexed engine's columnar path) and a
        row list give the same arrays."""
        if isinstance(sst, PackedViews):
            bitmap, intent = sst.bitmap, sst.intent
            pushed_at = sst.pushed_at
            dead, suspect = sst.dead, sst.suspect
            ft, avc = sst.ft, sst.avc
            fetch_model, fetch_eta = sst.fetch_model, sst.fetch_eta
        else:
            bitmap = np.array([r.cache_bitmap for r in sst], np.uint64)
            intent = np.array([r.intent_bitmap for r in sst], np.uint64)
            pushed_at = np.array([r.pushed_at for r in sst], np.float64)
            dead = np.array([r.liveness == DEAD for r in sst], bool)
            suspect = np.array([r.liveness == SUSPECT for r in sst], bool)
            ft = np.array([r.ft_estimate_s for r in sst], np.float64)
            avc = np.array([r.free_cache_bytes for r in sst], np.float64)
            fetch_model = np.array([r.fetch_model_id for r in sst], np.int64)
            fetch_eta = np.array([r.fetch_eta_s for r in sst], np.float64)
        one = np.uint64(1)
        bits = ((bitmap[:, None] >> _BIT_SHIFTS) & one) != 0
        ibits = ((intent[:, None] >> _BIT_SHIFTS) & one) != 0
        fresh = np.maximum(0.0, now - pushed_at) <= self.config.intent_fresh_s
        live = np.where(
            dead, np.inf, np.where(suspect, self.config.suspect_penalty_s, 0.0)
        ).astype(np.float32)
        return (
            bits, ibits, fresh, live,
            ft.astype(np.float32),
            avc.astype(np.float32),
            fetch_model.astype(np.int32),
            fetch_eta.astype(np.float32),
        )

    def _plan(self, static: StaticPlanInputs, components: bool):
        f = self._feed
        return plan_vectorized(
            static,
            self.config,
            f.n,
            f.ft0,
            f.bits,
            f.avc0,
            f.now,
            f.origin_f.long(),
            intent_bits=f.ibits,
            intent_fresh=f.fresh,
            gpu_capacity=self._gpu_capacity,
            liveness_cost=f.live,
            xfer_inv_bw=self._xfer_inv_bw,
            xfer_delta=self._xfer_delta,
            fetch_model=f.fetch_model,
            fetch_eta=f.fetch_eta,
            return_components=components,
        )

    def _graph(self, name: str, static: StaticPlanInputs, components: bool) -> PlanGraph:
        """The graph of (DFG, ``components``), captured at first use after
        one eager warm-up on the capture stream (the feed is loaded)."""
        key = (name, components)
        g = self.graphs.get(key)
        if g is not None:
            return g
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            self._plan(static, components)
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self._plan(static, components)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        g = PlanGraph(graph, out, time.perf_counter() - t0)
        self.graphs[key] = g
        return g

    def _outputs(self, name: str, static: StaticPlanInputs, components: bool):
        """The plan of the loaded feed: a replay of the DFG's graph on a
        card, the eager loop on the CPU."""
        if self.device.type == "cuda":
            return self._graph(name, static, components).replay()
        return self._plan(static, components)

    def plan(self, job: Job, now: float, origin_worker: int, sst) -> ADFG:
        dfg = job.dfg
        if dfg.name not in self._static:
            self._static[dfg.name] = build_static_inputs(self.profiles, dfg)
        static = self._static[dfg.name]
        n = self.profiles.cluster.n_workers
        feed = self._pack_feed(sst, now, n)
        self._feed.load(feed, now, origin_worker)
        components = self.recorder is not None
        out = self._outputs(dfg.name, static, components)
        assign = out[0].tolist()
        task_ft = out[1].tolist()
        adfg = ADFG(job)
        for i, tid in enumerate(static.order):
            adfg[tid] = int(assign[i])
            adfg.planned_ft[tid] = float(task_ft[i])
        if self.recorder is not None:
            from repro_torch.core.telemetry import CandidateCost, PlacementDecision

            live = feed[3]
            queue, at, td, disc, rt, cost = (a.cpu().numpy() for a in out[2:])
            for i, tid in enumerate(static.order):
                self.recorder.record_placement(PlacementDecision(
                    # The reference's label, kept so that the two packages'
                    # recorder JSONL compare byte for byte.
                    t=now, job_id=job.job_id, task_id=tid, phase="plan",
                    scheduler="navigator-jax", reader=origin_worker,
                    chosen=int(assign[i]),
                    candidates=tuple(
                        CandidateCost(
                            worker=w,
                            queue_s=float(queue[i, w]),
                            input_s=float(at[i, w]),
                            model_s=float(td[i, w]),
                            intent_discount_s=float(disc[i, w]),
                            runtime_s=float(rt[i, w]),
                            liveness_s=float(live[w]),
                            total_s=float(cost[i, w]),
                        )
                        for w in range(n)
                    ),
                ))
        return adfg
