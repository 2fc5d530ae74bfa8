"""Predictive prefetch plane: intent-driven GPU memory co-scheduling,
copied from the JAX package so that the port stands alone.

The paper's headline claim is *unified* co-scheduling of task placement
and GPU memory management, but a purely reactive memory layer only starts
a model fetch once a task is already enqueued with inputs present — the
fetch serializes behind the upstream computation instead of overlapping
it.  This subsystem closes the loop in the other direction: the planning
phase (Alg. 1) already knows, at job arrival, which models each worker
will need and roughly when.  We turn that plan into **memory intents**:

* When Navigator plans (or adjusts, Alg. 2) a job, every assigned worker
  receives :class:`PrefetchIntent` records for the models of its future
  tasks — ``(job, task, model, expected start)`` — capped per worker by
  ``lookahead_depth``.
* Each worker keeps a small intent queue.  Whenever its single fetch pipe
  (one PCIe transfer in flight per worker, §3.2) is idle and no *demand*
  fetch is pending, the earliest-needed intent issues a **speculative
  fetch**.  Demand always preempts prefetch: an in-flight speculative
  transfer for a different model is aborted (partial bytes are wasted and
  accounted) the moment a queued task needs the pipe.  A speculative
  fetch whose model a task demands mid-flight is *promoted* to a demand
  fetch and becomes non-preemptible.
* Workers advertise an **intent bitmap** — resident ∪ in-flight ∪
  queued-to-fetch — through both metadata planes (the ``SharedStateTable``
  row and ``GossipPlane`` diffs, lanes 6–7 of the wire row).  The
  planner's placement cost discounts ``TD_model`` for intended models by
  a confidence factor (``NavigatorConfig.intent_confidence``) when the
  advertisement is fresh.

Anti-herd hysteresis (two layers, both needed because every view is
stale):

1. **Planner-side stickiness** (``NavigatorConfig.intent_herd_margin``):
   when the cheapest worker for a model-bearing task does *not* hold or
   intend the model but some other worker does, the planner moves the
   task to the intending worker unless the cheapest worker wins by more
   than the margin — so concurrent planners converge on the worker that
   already committed to the fetch instead of each starting their own.
2. **Worker-side deferral** (``PrefetchConfig.herd_backoff_s``): a worker
   holds off issuing a *non-urgent* speculative fetch for a model some
   peer already advertises (resident or intended); Alg. 2 adjustment may
   well move the task there, making the local fetch redundant.  Once the
   expected start closes to within ``fetch + urgency_slack_s`` the fetch
   is issued regardless — by then the placement is as good as committed.

The plane is engine-agnostic, mirroring ``GossipPlane``: it holds no
clock and samples no randomness; the driving engine decides when intent
control messages arrive, when fetches start/finish, and feeds residency
predicates in.  The reference's simulator drives it with discrete events;
``serving/engine.py`` folds it into its virtual clock.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import bitmaps
from repro_torch.core.types import ADFG, Job

#: Control-message payload per intent on the wire (job id, task id hash,
#: model id, expected start — comfortably one cache line with headers).
INTENT_WIRE_BYTES = 64.0


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    """Worker-side tunables of the prefetch plane.

    Planner-side knobs (confidence discount, herd margin, freshness
    window) live on ``NavigatorConfig`` so the jitted vectorized planner
    can treat them as static arguments.
    """

    # How many future model-bearing tasks per worker one plan converts
    # into intents (deeper = more speculation, more potential waste).
    lookahead_depth: int = 4
    # Defer non-urgent speculative fetches for models a peer already
    # advertises by this much (anti-herd layer 2).  0 disables deferral.
    herd_backoff_s: float = 0.5
    # A prefetch is *urgent* (never deferred) once the expected task
    # start is within fetch_time + this slack.
    urgency_slack_s: float = 0.5
    # Intents older than this are dropped unissued: the plan that created
    # them has long since played out (or been adjusted away).
    intent_ttl_s: float = 30.0
    # Per-worker intent queue bound; beyond it the latest-needed intents
    # are dropped (the plan is re-derived on the next arrival anyway).
    max_queue: int = 16
    # Allow a speculative fetch to evict resident models (per the cache
    # policy; pinned and soon-needed models are protected, and unused
    # speculative contents are always the first victims).  On by default:
    # the multi-seed bursty-trace calibration (EXPERIMENTS.md) has it
    # strictly better on P50 and P99 than fill-free-memory-only.
    evict_for_prefetch: bool = True


# Intent lifecycle states.
QUEUED = "queued"
INFLIGHT = "inflight"
DONE = "done"
CANCELLED = "cancelled"


@dataclasses.dataclass
class PrefetchIntent:
    """One planned future model need on one worker."""

    job_id: int
    task_id: str
    model_id: int
    worker: int
    issued_at: float
    # Planner's estimate of when the task starts on the worker
    # (planned_ft − R(t, w)); orders the queue and gates urgency.
    expected_start_s: float
    state: str = QUEUED
    # Anti-herd deferral: not eligible for issue before this time.
    deferred_until: float = 0.0

    def key(self) -> Tuple[int, str]:
        return (self.job_id, self.task_id)


@dataclasses.dataclass
class PrefetchStats:
    intents_issued: int = 0      # admitted to a worker queue
    intents_cancelled: int = 0   # plan adjusted away / job done
    intents_migrated: int = 0    # moved to another worker by Alg. 2
    intents_consumed: int = 0    # demand reached the worker first
    intents_expired: int = 0     # TTL elapsed before issue
    intents_dropped: int = 0     # queue-bound overflow
    intents_orphaned: int = 0    # owning worker crashed/drained
    intents_rehomed: int = 0     # orphan re-issued on the task's heir worker
    already_resident: int = 0    # satisfied with no fetch needed
    prefetches_started: int = 0
    prefetches_completed: int = 0
    prefetches_promoted: int = 0  # demanded mid-flight → demand fetch
    prefetches_preempted: int = 0  # aborted for a demand fetch
    deferrals: int = 0           # anti-herd hold-offs
    stalls: int = 0              # chosen but no cache room; parked


class PrefetchPlane:
    """Cluster-wide book-keeping for per-worker prefetch queues.

    One instance per engine; state is strictly per-worker (a worker only
    ever reads/writes its own queue), so the centralized object is a
    modelling convenience, not a coordination point — exactly like
    ``GossipPlane`` holding every worker's replica.
    """

    def __init__(
        self,
        n_workers: int,
        config: Optional[PrefetchConfig] = None,
        fetch_time_fn: Optional[Callable[[int], float]] = None,
    ) -> None:
        self.n_workers = n_workers
        self.config = config or PrefetchConfig()
        # TD_model(m) estimator used for urgency; defaults to 0 (always
        # urgent) if the engine provides none.
        self._fetch_time = fetch_time_fn or (lambda mid: 0.0)
        # queues[w]: (job_id, task_id) -> intent, insertion-ordered;
        # scans sort by expected start (queues are ≤ max_queue long).
        self.queues: List[Dict[Tuple[int, str], PrefetchIntent]] = [
            {} for _ in range(n_workers)
        ]
        # The speculative fetch currently occupying w's fetch pipe.
        self.inflight: List[Optional[PrefetchIntent]] = [None] * n_workers
        self.stats = PrefetchStats()

    # -- intent derivation (planner side) -----------------------------------
    def plan_intents(
        self, job: Job, adfg: ADFG, profiles, now: float
    ) -> Dict[int, List[PrefetchIntent]]:
        """Turn a fresh ADFG into per-worker intents: for each worker the
        first ``lookahead_depth`` model-bearing tasks by expected start.
        The caller delivers each worker's list as a control message (with
        whatever transport delay its network model implies) and then
        calls :meth:`admit`."""
        per: Dict[int, List[PrefetchIntent]] = {}
        ordered = sorted(
            adfg.assignment, key=lambda t: adfg.planned_ft.get(t, now)
        )
        for tid in ordered:
            task = job.dfg.tasks[tid]
            if task.model_id is None:
                continue
            w = adfg[tid]
            lst = per.setdefault(w, [])
            if len(lst) >= self.config.lookahead_depth:
                continue
            est = adfg.planned_ft.get(tid, now) - profiles.runtime(task, w)
            lst.append(
                PrefetchIntent(
                    job_id=job.job_id,
                    task_id=tid,
                    model_id=task.model_id,
                    worker=w,
                    issued_at=now,
                    expected_start_s=max(now, est),
                )
            )
        return per

    def make_intent(
        self, job: Job, task_id: str, worker: int, now: float,
        expected_start_s: Optional[float] = None,
    ) -> Optional[PrefetchIntent]:
        """Single-task intent (Alg. 2 migration target)."""
        task = job.dfg.tasks[task_id]
        if task.model_id is None:
            return None
        return PrefetchIntent(
            job_id=job.job_id,
            task_id=task_id,
            model_id=task.model_id,
            worker=worker,
            issued_at=now,
            expected_start_s=(
                now if expected_start_s is None else expected_start_s
            ),
        )

    # -- intent queue maintenance (worker side) ------------------------------
    def admit(
        self, worker: int, intents: Sequence[PrefetchIntent], now: float
    ) -> None:
        """An intent control message arrived at ``worker``."""
        queue = self.queues[worker]
        for intent in intents:
            key = intent.key()
            prev = queue.get(key)
            if prev is not None:
                # Re-plan of the same task: keep the newer estimate.
                prev.expected_start_s = intent.expected_start_s
                prev.issued_at = intent.issued_at
                continue
            intent.worker = worker
            queue[key] = intent
            self.stats.intents_issued += 1
        # Bound the queue: drop the latest-needed surplus.
        over = len(queue) - self.config.max_queue
        if over > 0:
            by_need = sorted(
                queue.values(), key=lambda i: -i.expected_start_s
            )
            for victim in by_need[:over]:
                del queue[victim.key()]
                self.stats.intents_dropped += 1

    def cancel(
        self, worker: int, job_id: int, task_id: str, migrated: bool = False
    ) -> Optional[PrefetchIntent]:
        """Remove the intent for (job, task) on ``worker``.  Returns the
        in-flight intent if the cancellation hits a fetch the engine must
        abort (the caller owns the fetch pipe), else None."""
        key = (job_id, task_id)
        intent = self.queues[worker].pop(key, None)
        if intent is not None:
            intent.state = CANCELLED
            if migrated:
                self.stats.intents_migrated += 1
            else:
                self.stats.intents_cancelled += 1
            return None
        cur = self.inflight[worker]
        if cur is not None and cur.key() == key:
            # The speculative fetch belongs to a cancelled intent.  If
            # another queued intent wants the same model, transfer
            # ownership instead of wasting the transfer.
            heir = self._heir(worker, cur.model_id)
            if heir is not None:
                del self.queues[worker][heir.key()]
                heir.state = INFLIGHT
                self.inflight[worker] = heir
                if migrated:
                    self.stats.intents_migrated += 1
                else:
                    self.stats.intents_cancelled += 1
                return None
            cur.state = CANCELLED
            self.inflight[worker] = None
            if migrated:
                self.stats.intents_migrated += 1
            else:
                self.stats.intents_cancelled += 1
            return cur
        return None

    def _heir(self, worker: int, model_id: int) -> Optional[PrefetchIntent]:
        cands = [
            i for i in self.queues[worker].values() if i.model_id == model_id
        ]
        if not cands:
            return None
        return min(cands, key=lambda i: i.expected_start_s)

    def drop_worker(self, worker: int) -> List[PrefetchIntent]:
        """The worker left the fleet (crash or drain): its queued intents
        are orphaned and its in-flight speculative transfer is void (the
        engine owns the fetch pipe and the partial-bytes accounting).

        Returns the orphaned queue in expected-start order so the engine
        can re-home each intent on the heir worker its task is re-routed
        to (:meth:`rehome` stamps the move)."""
        orphans = sorted(
            self.queues[worker].values(), key=lambda i: i.expected_start_s
        )
        self.queues[worker] = {}
        cur = self.inflight[worker]
        if cur is not None:
            self.inflight[worker] = None
            cur.state = CANCELLED
            orphans.append(cur)
        for intent in orphans:
            intent.state = CANCELLED
            self.stats.intents_orphaned += 1
        return orphans

    def rehome(
        self, intent: PrefetchIntent, worker: int, now: float
    ) -> PrefetchIntent:
        """Mint the heir copy of an orphaned intent for the worker the
        engine's recovery re-routed its task to; the fresh issue time
        restarts the TTL (the old plan's clock died with the old worker).
        The caller delivers it like any other intent control message."""
        heir = PrefetchIntent(
            job_id=intent.job_id,
            task_id=intent.task_id,
            model_id=intent.model_id,
            worker=worker,
            issued_at=now,
            expected_start_s=max(now, intent.expected_start_s),
        )
        self.stats.intents_rehomed += 1
        return heir

    def consume(self, worker: int, job_id: int, task_id: str) -> None:
        """The task itself reached ``worker``'s execution queue — demand
        fetching takes over from here; the intent is spent."""
        intent = self.queues[worker].pop((job_id, task_id), None)
        if intent is not None:
            intent.state = DONE
            self.stats.intents_consumed += 1

    # -- fetch-pipe interface (engine side) ----------------------------------
    def next_intent(
        self,
        worker: int,
        now: float,
        is_resident: Callable[[int], bool],
        peer_bits: int = 0,
    ) -> Tuple[Optional[PrefetchIntent], Optional[float]]:
        """Pick the next intent to speculatively fetch on ``worker``.

        ``is_resident`` is the worker's local cache predicate (resident
        models need no fetch); ``peer_bits`` is the union of *other*
        workers' advertised cache∪intent bitmaps from this worker's own
        (possibly stale) SST view — the anti-herd evidence.

        Returns ``(intent, retry_at)``: ``intent`` is marked in-flight
        and removed from the queue when chosen; when every eligible
        intent is deferred, ``intent`` is None and ``retry_at`` is the
        earliest time a deferral expires (the engine may poke then).
        """
        queue = self.queues[worker]
        retry_at: Optional[float] = None
        for intent in sorted(queue.values(), key=lambda i: i.expected_start_s):
            if now - intent.issued_at > self.config.intent_ttl_s:
                del queue[intent.key()]
                intent.state = CANCELLED
                self.stats.intents_expired += 1
                continue
            if is_resident(intent.model_id):
                del queue[intent.key()]
                intent.state = DONE
                self.stats.already_resident += 1
                continue
            if now < intent.deferred_until:
                retry_at = (
                    intent.deferred_until
                    if retry_at is None
                    else min(retry_at, intent.deferred_until)
                )
                continue
            fetch_s = self._fetch_time(intent.model_id)
            urgent = (
                intent.expected_start_s - now
                <= fetch_s + self.config.urgency_slack_s
            )
            if (
                not urgent
                and self.config.herd_backoff_s > 0.0
                and bitmaps.contains(peer_bits, intent.model_id)
            ):
                # A peer already holds or intends this model and our need
                # is not imminent: hold off — adjustment may route the
                # task there and make this fetch pure waste.
                intent.deferred_until = now + self.config.herd_backoff_s
                self.stats.deferrals += 1
                retry_at = (
                    intent.deferred_until
                    if retry_at is None
                    else min(retry_at, intent.deferred_until)
                )
                continue
            del queue[intent.key()]
            intent.state = INFLIGHT
            self.inflight[worker] = intent
            self.stats.prefetches_started += 1
            return intent, None
        return None, retry_at

    def complete_inflight(self, worker: int) -> Optional[PrefetchIntent]:
        intent = self.inflight[worker]
        self.inflight[worker] = None
        if intent is not None:
            intent.state = DONE
            self.stats.prefetches_completed += 1
        return intent

    def promote_inflight(self, worker: int) -> None:
        """A queued task demanded the model mid-flight: the speculative
        fetch becomes a demand fetch (non-preemptible)."""
        if self.inflight[worker] is not None:
            self.stats.prefetches_promoted += 1

    def stall_inflight(self, worker: int, until: float) -> None:
        """The chosen intent could not be staged (no cache room without
        eviction): park it back on the queue, deferred until ``until``."""
        intent = self.inflight[worker]
        self.inflight[worker] = None
        if intent is None:
            return
        intent.state = QUEUED
        intent.deferred_until = until
        self.queues[worker][intent.key()] = intent
        self.stats.stalls += 1

    def preempt_inflight(self, worker: int, requeue: bool) -> Optional[PrefetchIntent]:
        """A demand fetch claimed the pipe.  ``requeue`` puts the intent
        back on the queue (the task still needs the model later)."""
        intent = self.inflight[worker]
        self.inflight[worker] = None
        if intent is None:
            return None
        self.stats.prefetches_preempted += 1
        if requeue:
            intent.state = QUEUED
            intent.deferred_until = 0.0
            self.queues[worker][intent.key()] = intent
        else:
            intent.state = CANCELLED
        return intent

    # -- advertisement --------------------------------------------------------
    def advertised_bits(self, worker: int) -> int:
        """Queued ∪ in-flight model bits for ``worker`` — the engine ORs
        these with the cache bitmap to form the advertised intent bitmap
        (resident ∪ in-flight ∪ queued-to-fetch)."""
        bits = 0
        for intent in self.queues[worker].values():
            bits = bitmaps.add(bits, intent.model_id)
        cur = self.inflight[worker]
        if cur is not None:
            bits = bitmaps.add(bits, cur.model_id)
        return bits

    def queue_depth(self, worker: int) -> int:
        return len(self.queues[worker])
