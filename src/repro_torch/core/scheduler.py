"""Navigator scheduler (§4) and the baseline schemes (§6.2.1).

Planning phase (Alg. 1): HEFT-style upward-rank ordering, then per-task
argmin over workers of

    FT(t, w) = max(worker_FT_map[w], AT_allInputs(t, w)) + TD_model(m_t, w) + R(t, w)

with the model-locality term TD_model from Eq. 2 (0 on a cache hit, fetch
time on a miss that fits, fetch time + eviction penalty otherwise) and
input arrival times from Eq. 3–4.

Dynamic adjustment phase (Alg. 2): when a task's predecessor finishes, if
the planned worker's queue wait exceeds ``threshold × R(t, w)`` and the
task is not a join, re-select the worker with the earliest start, adding
TD_input for workers other than the one holding the task's inputs.

Baselines:
* JIT   — per-task assignment at readiness, earliest-start-first.
* HEFT  — classic HEFT: rank + earliest finish, but no worker load, no
          model locality, no dynamic adjustment.
* Hash  — uniform task spreading by hash(task, job).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import bitmaps
from repro_torch.core.packed import PackedViews
from repro_torch.core.profiles import ProfileRepository
from repro_torch.core.state import DEAD, SSTRow, SUSPECT
from repro_torch.core.telemetry import (
    CandidateCost,
    FlightRecorder,
    PlacementDecision,
)
from repro_torch.core.types import ADFG, DFG, Job, TaskSpec


@dataclasses.dataclass(frozen=True)
class NavigatorConfig:
    """Tunables + ablation switches (§6.3.1)."""

    # Alg. 2 line 2: reschedule when queue wait > R(t, w) * threshold.
    adjustment_threshold: float = 2.0
    # Eq. 2 third case.  None → estimate as the mean refetch cost of the
    # models currently resident on the candidate worker (the expected cost
    # of bringing back whatever we evict); float → fixed seconds.
    eviction_penalty_s: Optional[float] = None
    # Optional hysteresis for Alg. 2 under stale metadata: move only if the
    # best candidate improves the planned worker's estimated finish by this
    # relative margin.  0.0 = the paper's unconditional argmin (which also
    # measured best in our multi-seed calibration; see EXPERIMENTS.md).
    adjustment_margin: float = 0.0
    # Staleness-aware hysteresis (decentralized gossip plane): the margin
    # grows with the age of the candidate worker's row, so the staler the
    # evidence for moving, the bigger the predicted win must be.  Effective
    # margin = adjustment_margin + staleness_margin_per_s × row age.  0.0
    # disables (and with a fresh SharedStateTable rows are near-zero age,
    # so this is a no-op for the centralized-snapshot configuration).
    staleness_margin_per_s: float = 0.0
    # Prefetch plane (core/prefetch.py): Eq. 2 discount for models a
    # worker *intends* to hold (advertised intent bitmap ⊃ cache bitmap).
    # An intended-but-not-yet-resident model costs
    # ``TD_model × (1 − intent_confidence)`` — the fetch is (probably)
    # already overlapping queue wait on that worker.  0.0 disables; the
    # discount is inert anyway while intent bitmaps are all-zero (plane
    # off).
    intent_confidence: float = 0.7
    # Intent advertisements older than this get no discount: the plan
    # that produced them has likely played out or been adjusted away
    # (anti-herd: stale evidence must not create phantom cheap workers).
    intent_fresh_s: float = 5.0
    # Anti-herd stickiness: when the cheapest worker for a model-bearing
    # task neither holds nor intends the model but another worker does,
    # prefer the intending worker unless the cheapest wins by more than
    # this relative margin — concurrent planners then converge on the
    # worker already committed to the fetch instead of spawning
    # redundant fetches from stale views.  0.0 = pure argmin.
    intent_herd_margin: float = 0.0
    # Membership lane (core/state.py LeaseConfig): additive placement cost
    # for a worker whose lease the reader's view marks SUSPECT — enough to
    # lose ties against healthy workers but not a hard exclusion (the
    # evidence is one missed heartbeat window, often just gossip lag).
    # Workers the view marks DEAD always cost ∞.  Inert (all rows ALIVE)
    # when no lease is configured.
    suspect_penalty_s: float = 5.0
    # Ablations:
    use_model_locality: bool = True      # Fig. 7 "model locality"
    use_dynamic_adjustment: bool = True  # Fig. 7 "dynamic task scheduling"
    # Track models the planner itself just decided to place (so the second
    # task in the same job using the same model sees a planned hit).
    speculative_cache: bool = True


class Scheduler:
    """Common interface the simulator/serving engine drives."""

    name = "base"
    needs_adjustment = False
    plans_at_arrival = True
    # Membership lane: additive cost for SUSPECT rows in membership-aware
    # schedulers (JIT uses this default; Navigator takes it from its
    # config).  Hash/HEFT never read the SST and stay blind.
    suspect_penalty_s = 5.0

    def __init__(self, profiles: ProfileRepository) -> None:
        self.profiles = profiles
        self.cluster = profiles.cluster
        # Flight-recorder hook: the engine attaches its recorder when
        # tracing is on; schedulers that price state (Navigator, JIT)
        # record a PlacementDecision per choice.  None ⇒ zero overhead.
        self.recorder: Optional[FlightRecorder] = None

    # Planning at job arrival.  Returns None for per-task schedulers (JIT).
    def plan(
        self,
        job: Job,
        now: float,
        origin_worker: int,
        sst: Sequence[SSTRow],
    ) -> Optional[ADFG]:
        raise NotImplementedError

    # Per-task assignment at readiness (JIT only).
    def select_worker_at_ready(
        self,
        job: Job,
        task_id: str,
        now: float,
        sst: Sequence[SSTRow],
        input_locations: Mapping[str, int],
        input_sizes: Mapping[str, float],
        self_worker: Optional[int] = None,
    ) -> int:
        raise NotImplementedError(f"{self.name} plans at arrival")

    # Dynamic adjustment when a predecessor completes (Navigator only).
    def adjust(
        self,
        job: Job,
        adfg: ADFG,
        task_id: str,
        now: float,
        sst: Sequence[SSTRow],
        current_worker: int,
        input_bytes: float,
    ) -> int:
        return adfg[task_id]

    # Recovery targeting after churn (crash / drain / partition): pick a
    # worker for a task whose assignment was lost.  ``None`` means "no
    # opinion" — the dispatcher falls back to its greedy earliest-start
    # rule.  Navigator prices the full placement cost instead.
    def select_recovery_worker(
        self,
        job: Job,
        task_id: str,
        now: float,
        sst: Sequence[SSTRow],
        input_locations: Mapping[str, int],
        input_sizes: Mapping[str, float],
        candidates: Sequence[int],
    ) -> Optional[int]:
        return None

    # -- shared helpers -------------------------------------------------------
    def _ft_map(self, now: float, sst: Sequence[SSTRow]) -> List[float]:
        """worker_FT_map: published queue-drain times, clamped to now
        (a stale estimate in the past means 'idle as far as we know')."""
        return [max(now, row.ft_estimate_s) for row in sst]

    def _liveness_cost(self, row: SSTRow, suspect_penalty_s: float = 0.0) -> float:
        """Membership term of the placement cost: ∞ for workers this
        reader's view marks DEAD (or draining), an additive penalty for
        SUSPECT ones.  Zero on a static fleet (rows default ALIVE)."""
        if row.liveness == DEAD:
            return float("inf")
        if row.liveness == SUSPECT:
            return suspect_penalty_s
        return 0.0

    def _liveness_cost_vec(
        self, pv: PackedViews, suspect_penalty_s: float = 0.0
    ) -> np.ndarray:
        """Vector twin of :meth:`_liveness_cost` over a packed view."""
        return np.where(
            pv.dead,
            float("inf"),
            np.where(pv.suspect, suspect_penalty_s, 0.0),
        )


class NavigatorScheduler(Scheduler):
    name = "navigator"
    needs_adjustment = True

    def __init__(
        self, profiles: ProfileRepository, config: Optional[NavigatorConfig] = None
    ) -> None:
        super().__init__(profiles)
        self.config = config or NavigatorConfig()
        self.needs_adjustment = self.config.use_dynamic_adjustment

    # -- Eq. 2 ------------------------------------------------------------------
    def _td_model(
        self,
        task: TaskSpec,
        worker: int,
        bitmap: int,
        avc_bytes: float,
        intent_bitmap: int = 0,
        intent_fresh: bool = False,
        fetch_model: int = -1,
        fetch_eta_s: float = 0.0,
        start_hint_s: float = 0.0,
    ) -> float:
        mid = task.model_id
        if mid is None:
            return 0.0
        if not self.config.use_model_locality:
            # Ablation: ignore cache state entirely — every worker looks the
            # same, so the locality preference disappears.
            return self.profiles.td_model(mid)
        if bitmaps.contains(bitmap, mid):
            return 0.0
        fetch = self.profiles.td_model(mid)
        if (
            intent_fresh
            and self.config.intent_confidence > 0.0
            and bitmaps.contains(intent_bitmap, mid)
        ):
            # Prefetch plane: the worker advertises an in-flight/queued
            # fetch for this model.  If the advertised *in-flight* fetch is
            # this very model, its expected-completion timestamp prices the
            # true remaining overlap: the task cannot start before
            # ``start_hint_s``, so only the part of the fetch outlasting
            # that moment is still on the critical path — a nearly-done
            # fetch costs ≈ 0, a just-started one ≈ the full fetch.
            if fetch_model == mid and fetch_eta_s > 0.0:
                return min(fetch, max(0.0, fetch_eta_s - start_hint_s))
            # Queued (not yet in-flight) intent: fall back to the constant
            # confidence discount — the fetch will (probably) overlap
            # queue wait on that worker.
            return fetch * (1.0 - self.config.intent_confidence)
        if self.profiles.cached_model_size(mid) <= avc_bytes:
            return fetch
        return fetch + self._eviction_penalty(bitmap)

    def _eviction_penalty(self, bitmap: int) -> float:
        if self.config.eviction_penalty_s is not None:
            return self.config.eviction_penalty_s
        resident = bitmaps.unpack(bitmap)
        if not resident:
            return 0.0
        # Expected cost of re-fetching whichever resident model we displace.
        return sum(self.profiles.td_model(m) for m in resident) / len(resident)

    # -- Eq. 2, batched -----------------------------------------------------------
    # The packed twins below evaluate every candidate worker in one numpy
    # expression instead of a python loop.  They replay the scalar
    # arithmetic elementwise in float64 (same operations, same order, same
    # precedence), so each element is bit-identical to the scalar call —
    # the invariant the differential parity suite (chaos family 7) pins.

    def _eviction_penalty_vec(
        self, bitmap: np.ndarray, need: np.ndarray
    ) -> np.ndarray:
        """Eviction penalty for the workers selected by ``need``: mean
        refetch cost of each worker's resident set, accumulated in
        ascending model-id order (the ``bitmaps.unpack`` order), so the
        float sum folds exactly like the scalar ``sum()``.  Adding 0.0 for
        absent models is bit-exact (all partial sums are ≥ +0.0)."""
        n = bitmap.shape[0]
        if self.config.eviction_penalty_s is not None:
            return np.full(n, self.config.eviction_penalty_s)
        sel = bitmap[need]
        union = int(np.bitwise_or.reduce(sel)) if sel.size else 0
        acc = np.zeros(n)
        cnt = np.zeros(n)
        for m in bitmaps.unpack(union):
            has = (bitmap & np.uint64(1 << m)) != 0
            acc = acc + np.where(has, self.profiles.td_model(m), 0.0)
            cnt = cnt + np.where(has, 1.0, 0.0)
        out = np.zeros(n)
        nz = cnt > 0
        out[nz] = acc[nz] / cnt[nz]
        return out

    def _td_model_vec(
        self,
        task: TaskSpec,
        bitmap: np.ndarray,
        avc: np.ndarray,
        intent: np.ndarray,
        fresh: np.ndarray,
        fetch_model: np.ndarray,
        fetch_eta: np.ndarray,
        start_hint: np.ndarray,
    ) -> np.ndarray:
        """(W,) twin of :meth:`_td_model` — same branch precedence (hit >
        in-flight intent > queued intent > fits > eviction), expressed as
        nested ``np.where`` applied innermost-first."""
        n = bitmap.shape[0]
        mid = task.model_id
        if mid is None:
            return np.zeros(n)
        fetch = self.profiles.td_model(mid)
        if not self.config.use_model_locality:
            return np.full(n, fetch)
        bit = np.uint64(1 << mid)
        hit = (bitmap & bit) != 0
        if self.config.intent_confidence > 0.0:
            intent_ok = fresh & ((intent & bit) != 0)
        else:
            intent_ok = np.zeros(n, dtype=bool)
        td = np.full(n, fetch)
        need_evp = ~hit & ~intent_ok & ~(
            self.profiles.cached_model_size(mid) <= avc
        )
        if np.any(need_evp):
            td = np.where(
                need_evp,
                fetch + self._eviction_penalty_vec(bitmap, need_evp),
                td,
            )
        td = np.where(
            intent_ok, fetch * (1.0 - self.config.intent_confidence), td
        )
        inflight = intent_ok & (fetch_model == mid) & (fetch_eta > 0.0)
        if np.any(inflight):
            remaining = np.minimum(
                fetch, np.maximum(0.0, fetch_eta - start_hint)
            )
            td = np.where(inflight, remaining, td)
        return np.where(hit, 0.0, td)

    # -- Alg. 1 -------------------------------------------------------------------
    def plan(
        self,
        job: Job,
        now: float,
        origin_worker: int,
        sst: Sequence[SSTRow],
    ) -> ADFG:
        if isinstance(sst, PackedViews):
            # Indexed engine hands packed columns; the batched path has no
            # provenance recording, so the engine only does this with the
            # flight recorder off.
            return self._plan_packed(job, now, origin_worker, sst)
        dfg = job.dfg
        workers = list(self.cluster.workers())
        ft_map = self._ft_map(now, sst)                       # line 2
        bitmap = [row.cache_bitmap for row in sst]
        avc = [row.free_cache_bytes for row in sst]
        intent = [row.intent_bitmap for row in sst]
        fresh = [
            max(0.0, now - row.pushed_at) <= self.config.intent_fresh_s
            for row in sst
        ]
        fetch_model = [row.fetch_model_id for row in sst]
        fetch_eta = [row.fetch_eta_s for row in sst]
        adfg = ADFG(job)

        live_cost = [
            self._liveness_cost(row, self.config.suspect_penalty_s)
            for row in sst
        ]
        rec = self.recorder
        for tid in self.profiles.rank_order(dfg):             # lines 4-5
            task = dfg.tasks[tid]
            fts: List[float] = []
            cands: List[CandidateCost] = []
            for w in workers:                                 # line 7
                if not self.profiles.model_fits(task.model_id, w):
                    fts.append(float("inf"))  # GPU can never host the model
                    if rec is not None:
                        cands.append(CandidateCost(
                            worker=w, queue_s=ft_map[w], input_s=0.0,
                            model_s=float("inf"), intent_discount_s=0.0,
                            runtime_s=0.0, liveness_s=live_cost[w],
                            total_s=float("inf"),
                        ))
                    continue
                at = self._at_all_inputs(job, tid, w, now, origin_worker, adfg)
                x = max(ft_map[w], at)                        # line 8
                td = self._td_model(
                    task, w, bitmap[w], avc[w], intent[w], fresh[w],
                    fetch_model[w], fetch_eta[w], x,
                )
                rt = self.profiles.runtime(task, w)
                fts.append(x + td + rt)                       # line 9
                if rec is not None:
                    # Undiscounted Eq. 2 (intent lane zeroed) prices what
                    # the prefetch plane saved on this candidate.
                    base = self._td_model(task, w, bitmap[w], avc[w])
                    cands.append(CandidateCost(
                        worker=w, queue_s=ft_map[w], input_s=at, model_s=td,
                        intent_discount_s=max(0.0, base - td),
                        runtime_s=rt, liveness_s=live_cost[w],
                        total_s=x + td + rt + live_cost[w],
                    ))
            # Selection cost = predicted finish + membership risk; the
            # penalty biases the argmin only, never the recorded estimate
            # (planned_ft / ft_map feed Eq. 3, prefetch expected-starts,
            # and Alg. 2 hysteresis, which must stay time-shaped).
            costs = [fts[w] + live_cost[w] for w in workers]
            argmin_w = min(workers, key=lambda w: costs[w])   # line 10
            best_w = self._herd_sticky_choice(
                task.model_id, argmin_w, costs, bitmap, intent, fresh, workers
            )
            if rec is not None:
                rec.record_placement(PlacementDecision(
                    t=now, job_id=job.job_id, task_id=tid, phase="plan",
                    scheduler=self.name, reader=origin_worker,
                    chosen=best_w, candidates=tuple(cands),
                    note=("herd-sticky override of "
                          f"w{argmin_w}") if best_w != argmin_w else "",
                ))
            best_ft = fts[best_w]
            adfg[tid] = best_w                                # line 11
            adfg.planned_ft[tid] = best_ft
            ft_map[best_w] = best_ft                          # line 12
            if self.config.speculative_cache and task.model_id is not None:
                if not bitmaps.contains(bitmap[best_w], task.model_id):
                    bitmap[best_w] = bitmaps.add(bitmap[best_w], task.model_id)
                    avc[best_w] = max(
                        0.0,
                        avc[best_w]
                        - self.profiles.cached_model_size(task.model_id),
                    )
        return adfg

    def _plan_packed(
        self, job: Job, now: float, origin_worker: int, pv: PackedViews
    ) -> ADFG:
        """Batched Alg. 1: per task, one vector evaluation of FT(t, ·)
        over every candidate worker — the columnar replay of :meth:`plan`
        (same arithmetic, same first-minimum tie-breaks, same speculative
        cache updates), bit-exact with the scalar loop."""
        dfg = job.dfg
        cfg = self.config
        inf = float("inf")
        ft_map = np.maximum(now, pv.ft)                       # line 2
        bitmap = pv.bitmap.copy()   # mutated by the speculative cache
        avc = pv.avc.copy()
        intent = pv.intent
        fresh = np.maximum(0.0, now - pv.pushed_at) <= cfg.intent_fresh_s
        live_cost = self._liveness_cost_vec(pv, cfg.suspect_penalty_s)
        adfg = ADFG(job)
        for tid in self.profiles.rank_order(dfg):             # lines 4-5
            task = dfg.tasks[tid]
            at = self._at_all_inputs_vec(job, tid, now, origin_worker, adfg)
            x = np.maximum(ft_map, at)                        # line 8
            td = self._td_model_vec(
                task, bitmap, avc, intent, fresh,
                pv.fetch_model, pv.fetch_eta, x,
            )
            fts = x + td + self.profiles.runtime_vec(task)    # line 9
            # GPU can never host the model ⇒ ∞ (the scalar loop skips the
            # worker before pricing it; the values it skipped are pure).
            fts = np.where(
                self.profiles.model_fits_vec(task.model_id), fts, inf
            )
            costs = fts + live_cost
            argmin_w = int(np.argmin(costs))                  # line 10
            best_w = self._herd_sticky_packed(
                task.model_id, argmin_w, costs, bitmap, intent, fresh
            )
            best_ft = float(fts[best_w])
            adfg[tid] = best_w                                # line 11
            adfg.planned_ft[tid] = best_ft
            ft_map[best_w] = best_ft                          # line 12
            if cfg.speculative_cache and task.model_id is not None:
                bit = np.uint64(1 << task.model_id)
                if not bitmap[best_w] & bit:
                    bitmap[best_w] = bitmap[best_w] | bit
                    avc[best_w] = max(
                        0.0,
                        float(avc[best_w])
                        - self.profiles.cached_model_size(task.model_id),
                    )
        return adfg

    def _at_all_inputs_vec(
        self,
        job: Job,
        task_id: str,
        now: float,
        origin_worker: int,
        adfg: ADFG,
    ) -> np.ndarray:
        """(W,) twin of :meth:`_at_all_inputs`: Eq. 3-4 arrival times for
        every candidate at once.  Zeroing the source column reproduces the
        scalar's self-transfer skip (x + 0.0 is bit-exact for the
        non-negative times involved)."""
        dfg = job.dfg
        preds = dfg.preds[task_id]
        if not preds:
            td = self.profiles.td_input_vec(dfg.tasks[task_id], origin_worker)
            td[origin_worker] = 0.0
            return now + td
        at = np.zeros(self.cluster.n_workers)
        for p in preds:
            src = adfg[p]
            td = self.profiles.td_output_vec(dfg.tasks[p], src)
            td[src] = 0.0
            at = np.maximum(at, adfg.planned_ft[p] + td)
        return at

    def _herd_sticky_packed(
        self,
        model_id: Optional[int],
        best_w: int,
        costs: np.ndarray,
        bitmap: np.ndarray,
        intent: np.ndarray,
        fresh: np.ndarray,
    ) -> int:
        """Vector twin of :meth:`_herd_sticky_choice` (same holder set,
        same first-minimum alternative, same margin comparison)."""
        margin = self.config.intent_herd_margin
        if (
            model_id is None
            or margin <= 0.0
            or not self.config.use_model_locality
        ):
            return best_w
        bit = np.uint64(1 << model_id)
        holds = ((bitmap & bit) != 0) | (fresh & ((intent & bit) != 0))
        if holds[best_w]:
            return best_w
        inf = float("inf")
        holder_costs = np.where(holds & (costs != inf), costs, inf)
        if not np.any(holder_costs != inf):
            return best_w
        alt = int(np.argmin(holder_costs))
        if holder_costs[alt] <= costs[best_w] * (1.0 + margin):
            return alt
        return best_w

    def _herd_sticky_choice(
        self,
        model_id: Optional[int],
        best_w: int,
        costs: Sequence[float],
        bitmap: Sequence[int],
        intent: Sequence[int],
        fresh: Sequence[bool],
        workers: Sequence[int],
    ) -> int:
        """Anti-herd hysteresis: if the argmin worker neither holds nor
        intends the task's model but some worker does, move to the best
        such worker unless the argmin wins by more than the margin.
        Operates on selection *costs* (finish estimate + membership
        risk), like the argmin itself."""
        margin = self.config.intent_herd_margin
        if (
            model_id is None
            or margin <= 0.0
            or not self.config.use_model_locality
        ):
            return best_w

        def holds(w: int) -> bool:
            return bitmaps.contains(bitmap[w], model_id) or (
                fresh[w] and bitmaps.contains(intent[w], model_id)
            )

        if holds(best_w):
            return best_w
        # Infinite-cost holders (infeasible GPU, or DEAD in this view —
        # a frozen row can still advertise the model) are no alternative.
        holders = [
            w for w in workers if holds(w) and costs[w] != float("inf")
        ]
        if not holders:
            return best_w
        alt = min(holders, key=lambda w: costs[w])
        if costs[alt] <= costs[best_w] * (1.0 + margin):
            return alt
        return best_w

    # -- Eq. 3-4 ----------------------------------------------------------------
    def _at_all_inputs(
        self,
        job: Job,
        task_id: str,
        worker: int,
        now: float,
        origin_worker: int,
        adfg: ADFG,
    ) -> float:
        dfg = job.dfg
        preds = dfg.preds[task_id]
        if not preds:
            # Entry task: the client input arrives at origin_worker and
            # ships along the origin → worker path.
            td = 0.0 if worker == origin_worker else self.profiles.td_input_to(
                dfg.tasks[task_id], origin_worker, worker
            )
            return now + td
        at = 0.0
        for p in preds:
            # Ranks order guarantees predecessors are already assigned.
            ft_p = adfg.planned_ft[p]
            if worker != adfg[p]:
                ft_p += self.profiles.td_output_to(
                    dfg.tasks[p], adfg[p], worker
                )
            at = max(at, ft_p)
        return at

    # -- Alg. 2 -------------------------------------------------------------------
    def adjust(
        self,
        job: Job,
        adfg: ADFG,
        task_id: str,
        now: float,
        sst: Sequence[SSTRow],
        current_worker: int,
        input_bytes: float,
    ) -> int:
        if not self.config.use_dynamic_adjustment:
            return adfg[task_id]
        if isinstance(sst, PackedViews):
            # Indexed engine hands packed columns (flight recorder off).
            return self._adjust_packed(
                job, adfg, task_id, now, sst, current_worker, input_bytes
            )
        dfg = job.dfg
        task = dfg.tasks[task_id]
        w_planned = adfg[task_id]                               # line 1
        wait = max(0.0, sst[w_planned].ft_estimate_s - now)
        above = wait > self.profiles.runtime(task, w_planned) * (
            self.config.adjustment_threshold
        )                                                       # line 2
        if dfg.is_join(task_id) or not above:                   # lines 3-5
            return w_planned
        ft_map = self._ft_map(now, sst)                         # line 6
        rec = self.recorder
        parts: Dict[int, Tuple[float, float, float, float, float]] = {}

        def est(w: int) -> float:
            if not self.profiles.model_fits(task.model_id, w):
                return float("inf")
            row = sst[w]
            live = self._liveness_cost(row, self.config.suspect_penalty_s)
            if live == float("inf"):
                return live  # DEAD in this view: never a move target
            td = self._td_model(
                task,
                w,
                row.cache_bitmap,
                row.free_cache_bytes,
                row.intent_bitmap,
                max(0.0, now - row.pushed_at)
                <= self.config.intent_fresh_s,
                row.fetch_model_id,
                row.fetch_eta_s,
                ft_map[w],
            )
            ft = ft_map[w] + td + self.profiles.runtime(task, w) + live
            path = 0.0
            if w != current_worker:                             # lines 10-11
                path = self.cluster.path_transfer_time(
                    input_bytes, current_worker, w
                )
                ft += path
            if rec is not None:
                parts[w] = (td, live, path,
                            self._td_model(task, w, row.cache_bitmap,
                                           row.free_cache_bytes),
                            self.profiles.runtime(task, w))
            return ft

        best_w, best_ft = w_planned, est(w_planned)
        for w in range(len(ft_map)):                            # line 7
            ft = est(w)
            if ft < best_ft:
                best_w, best_ft = w, ft
        # Hysteresis: require a clear predicted win before abandoning the
        # planned (cache-affine) worker.  Under the gossip plane the margin
        # scales with the age of the candidate's row — stale evidence for a
        # move must clear a higher bar (the adjuster only sees *its own*
        # replica of the candidate's state, which may lag reality).
        planned_ft = est(w_planned)
        margin = self.config.adjustment_margin
        if (
            best_w != w_planned
            and best_w != current_worker
            and self.config.staleness_margin_per_s > 0.0
        ):
            # The adjuster's own worker is never stale (local ground
            # truth); only remote rows carry age-scaled uncertainty.
            age = max(0.0, now - sst[best_w].pushed_at)
            margin += self.config.staleness_margin_per_s * age
        held = best_w != w_planned and best_ft > planned_ft * (1.0 - margin)
        chosen = w_planned if held else best_w
        if rec is not None:
            totals = {w: est(w) for w in range(len(ft_map))}
            stale = margin - self.config.adjustment_margin
            cands = tuple(
                CandidateCost(
                    worker=w, queue_s=ft_map[w],
                    # the Alg. 2 data term rides the current worker → w
                    # path, recorded in input_s (absolute = now + path)
                    input_s=now + parts[w][2] if w in parts else 0.0,
                    model_s=parts[w][0] if w in parts else float("inf"),
                    intent_discount_s=(
                        max(0.0, parts[w][3] - parts[w][0])
                        if w in parts else 0.0
                    ),
                    runtime_s=parts[w][4] if w in parts else 0.0,
                    liveness_s=parts[w][1] if w in parts else float("inf"),
                    total_s=totals[w],
                    staleness_margin_s=stale if w == best_w else 0.0,
                )
                for w in range(len(ft_map))
            )
            rec.record_placement(PlacementDecision(
                t=now, job_id=job.job_id, task_id=task_id, phase="adjust",
                scheduler=self.name, reader=current_worker, chosen=chosen,
                candidates=cands,
                note=(f"hysteresis hold on w{w_planned} "
                      f"(margin={margin:.4f})") if held else "",
            ))
        if held:
            return w_planned
        return chosen                                           # lines 12-13

    def _adjust_packed(
        self,
        job: Job,
        adfg: ADFG,
        task_id: str,
        now: float,
        pv: PackedViews,
        current_worker: int,
        input_bytes: float,
    ) -> int:
        """Batched Alg. 2: one vector evaluation of the adjustment
        estimate over every candidate, bit-exact with :meth:`adjust`
        (including the w_planned-first tie rule and the staleness-scaled
        hysteresis margin)."""
        dfg = job.dfg
        task = dfg.tasks[task_id]
        cfg = self.config
        w_planned = adfg[task_id]                               # line 1
        wait = max(0.0, float(pv.ft[w_planned]) - now)
        above = wait > self.profiles.runtime(task, w_planned) * (
            cfg.adjustment_threshold
        )                                                       # line 2
        if dfg.is_join(task_id) or not above:                   # lines 3-5
            return w_planned
        inf = float("inf")
        ft_map = np.maximum(now, pv.ft)                         # line 6
        live = self._liveness_cost_vec(pv, cfg.suspect_penalty_s)
        fresh = np.maximum(0.0, now - pv.pushed_at) <= cfg.intent_fresh_s
        td = self._td_model_vec(
            task, pv.bitmap, pv.avc, pv.intent, fresh,
            pv.fetch_model, pv.fetch_eta, ft_map,
        )
        est = ft_map + td + self.profiles.runtime_vec(task) + live
        path = self.profiles.path_time_vec(input_bytes, current_worker)
        path[current_worker] = 0.0                              # lines 10-11
        est = est + path
        # A DEAD row already prices to ∞ via `live`; unfit GPUs likewise.
        est = np.where(
            self.profiles.model_fits_vec(task.model_id), est, inf
        )
        # Scalar tie rule: the loop seeds best with w_planned, so it only
        # moves off the plan when some worker is *strictly* cheaper.
        m = float(est.min())
        best_w = (
            w_planned if float(est[w_planned]) == m else int(np.argmin(est))
        )
        best_ft = float(est[best_w])
        planned_ft = float(est[w_planned])
        margin = cfg.adjustment_margin
        if (
            best_w != w_planned
            and best_w != current_worker
            and cfg.staleness_margin_per_s > 0.0
        ):
            age = max(0.0, now - float(pv.pushed_at[best_w]))
            margin += cfg.staleness_margin_per_s * age
        held = best_w != w_planned and best_ft > planned_ft * (1.0 - margin)
        if held:
            return w_planned
        return best_w                                           # lines 12-13

    # -- recovery targeting ------------------------------------------------------
    def select_recovery_worker(
        self,
        job: Job,
        task_id: str,
        now: float,
        sst: Sequence[SSTRow],
        input_locations: Mapping[str, int],
        input_sizes: Mapping[str, float],
        candidates: Sequence[int],
    ) -> Optional[int]:
        """Full Navigator placement cost for a task stranded by churn:
        max(queue drain, input re-staging along the concrete paths) +
        Eq. 2 model cost + R(t, w) + membership risk — instead of the
        dispatcher's greedy earliest-start rule, which ignores worker
        speed, input shipping, and liveness.

        ``candidates`` is the dispatcher's ground-truth-feasible set
        (serving, reachable, can host the model), so a row the *reader's
        view* still marks DEAD is priced with the SUSPECT penalty rather
        than excluded: the evidence is stale, not authoritative."""
        task = job.dfg.tasks[task_id]
        ft_map = self._ft_map(now, sst)
        rec = self.recorder
        cands: List[CandidateCost] = []
        best_w: Optional[int] = None
        best_cost = float("inf")
        for w in candidates:
            row = sst[w]
            live = self._liveness_cost(row, self.config.suspect_penalty_s)
            if live == float("inf"):
                live = self.config.suspect_penalty_s
            td_in = 0.0
            for src, loc in input_locations.items():
                if loc != w:
                    td_in = max(
                        td_in,
                        self.cluster.path_transfer_time(
                            input_sizes.get(src, 0.0), loc, w
                        ),
                    )
            x = max(ft_map[w], now + td_in)
            td = self._td_model(
                task,
                w,
                row.cache_bitmap,
                row.free_cache_bytes,
                row.intent_bitmap,
                max(0.0, now - row.pushed_at)
                <= self.config.intent_fresh_s,
                row.fetch_model_id,
                row.fetch_eta_s,
                x,
            )
            rt = self.profiles.runtime(task, w)
            cost = x + td + rt + live
            if rec is not None:
                base = self._td_model(
                    task, w, row.cache_bitmap, row.free_cache_bytes
                )
                cands.append(CandidateCost(
                    worker=w, queue_s=ft_map[w], input_s=now + td_in,
                    model_s=td, intent_discount_s=max(0.0, base - td),
                    runtime_s=rt, liveness_s=live, total_s=cost,
                ))
            if cost < best_cost or (cost == best_cost and best_w is not None
                                    and w < best_w):
                best_w, best_cost = w, cost
        if rec is not None and best_w is not None:
            rec.record_placement(PlacementDecision(
                t=now, job_id=job.job_id, task_id=task_id, phase="recovery",
                scheduler=self.name, reader=-1, chosen=best_w,
                candidates=tuple(cands),
            ))
        return best_w


class JITScheduler(Scheduler):
    """Just-in-time baseline (§6.2.1): assigns each task as it becomes
    ready, to the worker with the earliest start (queue wait + model fetch
    + intermediate transfer).  Minimises each task's finish time in
    isolation — no intra-job coordination.

    JIT consumes Global State Monitor rows (load and cache bitmap alike,
    §6.2.1: "obtaining the start time estimates by taking worker-state
    information from Global State Monitor ... using the worker wait time,
    model fetch time and intermediate data transfer time").  What it lacks
    versus Navigator is intra-job coordination: fan-out siblings are placed
    greedily one at a time against the same snapshot, join placement cannot
    be pre-agreed, and there is no speculative model placement — which is
    why its hit rate sits between Hash's and Navigator's (Table 1).
    """

    name = "jit"
    plans_at_arrival = False

    def plan(self, job, now, origin_worker, sst) -> Optional[ADFG]:
        return None

    def select_worker_at_ready(
        self,
        job: Job,
        task_id: str,
        now: float,
        sst: Sequence[SSTRow],
        input_locations: Mapping[str, int],
        input_sizes: Mapping[str, float],
        self_worker: Optional[int] = None,
    ) -> int:
        if isinstance(sst, PackedViews):
            # Indexed engine hands packed columns (flight recorder off).
            return self._select_packed(
                job, task_id, now, sst,
                input_locations, input_sizes, self_worker,
            )
        dfg = job.dfg
        task = dfg.tasks[task_id]
        ft_map = self._ft_map(now, sst)
        rec = self.recorder
        cands: List[CandidateCost] = []
        best_w, best_ft = 0, float("inf")
        for w in range(len(ft_map)):
            if not self.profiles.model_fits(task.model_id, w):
                continue  # GPU can never host the model
            if sst[w].liveness == DEAD and w != self_worker:
                continue  # lease expired in this reader's view
            # Inputs that are not already on w must be transferred along
            # their holder → w path.
            td_in = 0.0
            for src, loc in input_locations.items():
                if loc != w:
                    td_in = max(
                        td_in,
                        self.cluster.path_transfer_time(
                            input_sizes[src], loc, w
                        ),
                    )
            td_model = 0.0
            if task.model_id is not None and not bitmaps.contains(
                sst[w].cache_bitmap, task.model_id
            ):
                td_model = self.profiles.td_model(task.model_id)
            rt = self.profiles.runtime(task, w)
            live = self._liveness_cost(sst[w], self.suspect_penalty_s)
            ft = max(ft_map[w], now + td_in) + td_model + rt + live
            if rec is not None:
                cands.append(CandidateCost(
                    worker=w, queue_s=ft_map[w], input_s=now + td_in,
                    model_s=td_model, intent_discount_s=0.0,
                    runtime_s=rt, liveness_s=live, total_s=ft,
                ))
            if ft < best_ft:
                best_w, best_ft = w, ft
        if rec is not None:
            rec.record_placement(PlacementDecision(
                t=now, job_id=job.job_id, task_id=task_id, phase="jit",
                scheduler=self.name,
                reader=self_worker if self_worker is not None else -1,
                chosen=best_w, candidates=tuple(cands),
            ))
        return best_w

    def _select_packed(
        self,
        job: Job,
        task_id: str,
        now: float,
        pv: PackedViews,
        input_locations: Mapping[str, int],
        input_sizes: Mapping[str, float],
        self_worker: Optional[int],
    ) -> int:
        """Batched JIT pick: one vector evaluation of the earliest-start
        estimate, bit-exact with the scalar loop (skipped workers price
        to ∞; ``np.argmin`` is the scalar's strict-< first minimum, and an
        all-∞ row degenerates to worker 0 exactly like the scalar seed)."""
        task = job.dfg.tasks[task_id]
        n = pv.n_workers
        ft_map = np.maximum(now, pv.ft)
        td_in = np.zeros(n)
        for src, loc in input_locations.items():
            v = self.profiles.path_time_vec(input_sizes[src], loc)
            v[loc] = 0.0
            td_in = np.maximum(td_in, v)
        if task.model_id is None:
            td_model = np.zeros(n)
        else:
            bit = np.uint64(1 << task.model_id)
            td_model = np.where(
                (pv.bitmap & bit) != 0,
                0.0,
                self.profiles.td_model(task.model_id),
            )
        live = self._liveness_cost_vec(pv, self.suspect_penalty_s)
        ft = (
            np.maximum(ft_map, now + td_in)
            + td_model
            + self.profiles.runtime_vec(task)
            + live
        )
        skip = ~self.profiles.model_fits_vec(task.model_id)
        dead_skip = pv.dead.copy()
        if self_worker is not None:
            dead_skip[self_worker] = False
        ft = np.where(skip | dead_skip, float("inf"), ft)
        return int(np.argmin(ft))


class HEFTScheduler(Scheduler):
    """Classic HEFT (§6.2.1): upward ranks + earliest-finish-time worker
    selection considering task parallelism and inter-task transfers, but
    with *no* notion of current worker queue load and *no* model locality;
    the plan is locked at job arrival (no dynamic adjustment)."""

    name = "heft"

    def plan(
        self,
        job: Job,
        now: float,
        origin_worker: int,
        sst: Sequence[SSTRow],
    ) -> ADFG:
        dfg = job.dfg
        workers = list(self.cluster.workers())
        # Worker availability *within this job only* — HEFT has no view of
        # the global queues.
        avail = {w: now for w in workers}
        adfg = ADFG(job)
        for tid in self.profiles.rank_order(dfg):
            task = dfg.tasks[tid]
            best_w, best_ft = -1, float("inf")
            for w in workers:
                at = now
                preds = dfg.preds[tid]
                if not preds:
                    if w != origin_worker:
                        at = now + self.profiles.td_input_to(
                            task, origin_worker, w
                        )
                else:
                    for p in preds:
                        ft_p = adfg.planned_ft[p]
                        if w != adfg[p]:
                            ft_p += self.profiles.td_output_to(
                                dfg.tasks[p], adfg[p], w
                            )
                        at = max(at, ft_p)
                # Every task pays the average model fetch cost regardless of
                # cache state: HEFT is model-locality-blind, but the fetch
                # is still part of the task's execution on the testbed.
                ft = max(avail[w], at) + self.profiles.runtime(task, w)
                if ft < best_ft:
                    best_w, best_ft = w, ft
            adfg[tid] = best_w
            adfg.planned_ft[tid] = best_ft
            avail[best_w] = best_ft
        return adfg


class HashScheduler(Scheduler):
    """Randomized hash placement (§6.2.1): uniform task spreading, the
    scheme "commonly used for workflow scheduling and load balancing"."""

    name = "hash"

    def plan(
        self,
        job: Job,
        now: float,
        origin_worker: int,
        sst: Sequence[SSTRow],
    ) -> ADFG:
        adfg = ADFG(job)
        for tid in job.dfg.topo_order:
            key = f"{tid}:{job.job_id}".encode()
            adfg[tid] = zlib.crc32(key) % self.cluster.n_workers
            adfg.planned_ft[tid] = now
        return adfg


SCHEDULERS = {
    "navigator": NavigatorScheduler,
    "jit": JITScheduler,
    "heft": HEFTScheduler,
    "hash": HashScheduler,
}


def make_scheduler(
    name: str,
    profiles: ProfileRepository,
    config: Optional[NavigatorConfig] = None,
) -> Scheduler:
    if name == "navigator":
        return NavigatorScheduler(profiles, config)
    try:
        return SCHEDULERS[name](profiles)
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}") from None
