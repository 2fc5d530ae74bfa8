"""Decentralized Global State Monitor — the Shared State Table (§3.4, §5.2).

Every worker holds a replica of a one-row-per-worker table:

    [ FT estimate | cache bitmap (u64) | free cache bytes | push timestamp ]

A worker updates *its own* row locally at any time, but replicas on peers
only see the value as of the worker's last *push*.  Pushes are rate-limited
by ``push_interval_s`` (paper default 200 ms = 5 pushes/s, §5.2/§6.3.2);
the staleness a reader observes is therefore bounded by the interval.

``SharedStateTable`` models exactly this: ``local`` rows are ground truth
for the owning worker, ``published`` rows are what remote schedulers see.
The simulator calls ``push(worker, now)`` on the dissemination schedule.
Separate intervals for the load field and the cache field support the
staleness sensitivity study (Fig. 8), which varies them independently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# Membership states a *reader* assigns to a peer's row from its own view.
# There is no oracle: two workers can (and under partitions/drops do)
# disagree about whether a third is alive.
ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """Heartbeat/lease tunables for the membership lane.

    Each worker stamps its own row with a heartbeat (``heartbeat_s``)
    every ``heartbeat_period_s``; the stamp disseminates like any other
    row mutation.  A reader classifies a peer from the *replicated* stamp
    age — ALIVE below ``suspect_after_s``, SUSPECT up to ``dead_after_s``,
    DEAD beyond — so detection latency includes dissemination lag, and
    every worker decides from its own, possibly stale, evidence.

    Defaults assume the paper's 200 ms gossip cadence: a lease survives a
    few dropped rounds (no flapping) but a crash is declared dead within
    ~4 s, well under typical re-execution costs.
    """

    heartbeat_period_s: float = 0.25
    suspect_after_s: float = 1.5
    dead_after_s: float = 4.0
    # RPC/connection timeout a dispatcher pays before concluding that a
    # worker it shipped work to is unreachable and failing over — the
    # per-contact price of acting on a stale ALIVE verdict.
    dead_letter_timeout_s: float = 1.0

    @property
    def detection_delay_s(self) -> float:
        """Time from a silent crash to the moment a peer's replicated
        heartbeat age crosses ``dead_after_s``: the lease bound plus the
        dissemination lag of the last heartbeat it did send."""
        return self.dead_after_s + 2.0 * self.heartbeat_period_s

    def classify(self, heartbeat_age_s: float) -> str:
        if heartbeat_age_s > self.dead_after_s:
            return DEAD
        if heartbeat_age_s > self.suspect_after_s:
            return SUSPECT
        return ALIVE


@dataclasses.dataclass
class SSTRow:
    """One worker's row.  ``ft_estimate_s`` is FT(w): the absolute time at
    which the worker expects to have drained its execution queue (§4.1).
    ``cache_bitmap`` encodes Navigator-cache contents; ``free_cache_bytes``
    is AVC(w)."""

    ft_estimate_s: float = 0.0
    cache_bitmap: int = 0
    free_cache_bytes: float = 0.0
    pushed_at: float = 0.0
    # Monotonic per-owner version; the gossip plane (sst_exchange.py) uses
    # it to merge replicas newest-wins and to ship version-vector diffs.
    version: int = 0
    # Prefetch-plane advertisement: resident ∪ in-flight ∪ queued-to-fetch
    # models (core/prefetch.py).  Superset of ``cache_bitmap`` when the
    # plane is enabled; 0 (inert) otherwise.
    intent_bitmap: int = 0
    # Membership lane: the owner's last self-stamped heartbeat time, its
    # incarnation (bumped on every rejoin so pre-crash rows can never
    # overwrite post-rejoin state), and a graceful-departure flag.
    heartbeat_s: float = 0.0
    epoch: int = 0
    draining: bool = False
    # Prefetch-plane expected-completion advertisement: the model id of
    # the owner's *in-flight* fetch (−1 = none) and its absolute expected
    # completion time.  Planners use the remaining transfer fraction to
    # scale the intent discount (a nearly-done fetch is nearly free).
    fetch_model_id: int = -1
    fetch_eta_s: float = 0.0
    # Health-digest lane (core/healthplane.py): the owner's four-field
    # health summary, refreshed right before each publication so every
    # reader holds a staleness-bounded view of fleet health with no
    # oracle — wire lanes 12–15 in sst_exchange.py.
    health_queue_depth: int = 0
    health_mem_occupancy: float = 0.0
    health_fetch_util: float = 0.0
    health_p99_latency_s: float = 0.0
    # Reader-side annotation (NOT wire state): the membership state the
    # reader that produced this view assigns the row.  Filled by
    # ``view(..., now=...)`` when a lease is configured; planners cost
    # SUSPECT rows with a penalty and DEAD rows at infinity.
    liveness: str = ALIVE

    def copy(self) -> "SSTRow":
        return SSTRow(
            self.ft_estimate_s,
            self.cache_bitmap,
            self.free_cache_bytes,
            self.pushed_at,
            self.version,
            self.intent_bitmap,
            self.heartbeat_s,
            self.epoch,
            self.draining,
            self.fetch_model_id,
            self.fetch_eta_s,
            self.health_queue_depth,
            self.health_mem_occupancy,
            self.health_fetch_util,
            self.health_p99_latency_s,
            self.liveness,
        )

    def merge_key(self) -> "tuple[int, int]":
        """Newest-wins merge order across crash boundaries: a rejoined
        worker restarts version at 1 but bumps epoch, so (epoch, version)
        keeps post-rejoin rows strictly newer than any pre-crash replica."""
        return (self.epoch, self.version)


class SharedStateTable:
    """Replicated per-worker state with bounded-staleness publication.

    For simplicity we model a single published copy (all peers see the same
    snapshot age); per-peer divergence below one push interval does not
    change scheduling behaviour, which only depends on the staleness bound.
    Load and cache fields may be published on different cadences, matching
    the two axes of Fig. 8.
    """

    def __init__(
        self,
        n_workers: int,
        push_interval_s: float = 0.2,
        cache_push_interval_s: Optional[float] = None,
        lease: Optional[LeaseConfig] = None,
    ) -> None:
        self.n_workers = n_workers
        self.push_interval_s = push_interval_s
        self.cache_push_interval_s = (
            push_interval_s if cache_push_interval_s is None else cache_push_interval_s
        )
        # Membership lane (None = static fleet, rows always ALIVE).
        self.lease = lease
        self.local: List[SSTRow] = [SSTRow() for _ in range(n_workers)]
        self.published: List[SSTRow] = [SSTRow() for _ in range(n_workers)]
        self._pushes = 0
        # Open network partition: (worker -> group id, cut start time), or
        # None when fully connected.  See ``set_partition``.
        self._partition: Optional[tuple] = None
        self._partition_groups: Optional[np.ndarray] = None
        # Columnar mirror of ``published`` for the packed read path
        # (``view_arrays``), kept in sync O(1) per push/join.  Deferred
        # import: packed.py imports this module for the row types.
        from repro_torch.core.packed import ColumnStore

        self._cols = ColumnStore(n_workers)

    # -- local updates (free, instantaneous) -------------------------------
    # ``now`` stamps the local row's modification time (the same signature
    # the gossip plane uses), so a reader substituting its own local row
    # sees a current ``pushed_at`` and staleness-aware consumers don't
    # mistake own ground truth for ancient data.
    def update_load(
        self, worker: int, ft_estimate_s: float, now: float = 0.0
    ) -> None:
        row = self.local[worker]
        row.ft_estimate_s = ft_estimate_s
        row.pushed_at = max(row.pushed_at, now)

    def update_cache(
        self,
        worker: int,
        cache_bitmap: int,
        free_cache_bytes: float,
        now: float = 0.0,
        fetch_model_id: int = -1,
        fetch_eta_s: float = 0.0,
    ) -> None:
        row = self.local[worker]
        row.cache_bitmap = cache_bitmap
        row.free_cache_bytes = free_cache_bytes
        row.fetch_model_id = fetch_model_id
        row.fetch_eta_s = fetch_eta_s
        row.pushed_at = max(row.pushed_at, now)

    def update_intent(
        self, worker: int, intent_bitmap: int, now: float = 0.0
    ) -> None:
        """Prefetch-plane advertisement (resident ∪ in-flight ∪ queued);
        rides the cache-field publication cadence."""
        row = self.local[worker]
        row.intent_bitmap = intent_bitmap
        row.pushed_at = max(row.pushed_at, now)

    def update_health(
        self,
        worker: int,
        queue_depth: int,
        mem_occupancy: float,
        fetch_util: float,
        p99_latency_s: float,
        now: float = 0.0,
    ) -> None:
        """Health-digest lane (core/healthplane.py): the engine refreshes
        the owner's four-field digest right before each publication, so
        the replicated view's staleness is bounded by the push interval
        like every other lane."""
        row = self.local[worker]
        row.health_queue_depth = queue_depth
        row.health_mem_occupancy = mem_occupancy
        row.health_fetch_util = fetch_util
        row.health_p99_latency_s = p99_latency_s
        row.pushed_at = max(row.pushed_at, now)

    # -- membership (heartbeat/lease lane) -----------------------------------
    def heartbeat(self, worker: int, now: float) -> None:
        """Owner self-stamp; reaches peers on the next push (so lease age
        as observed includes publication lag, same as the gossip plane)."""
        row = self.local[worker]
        row.heartbeat_s = max(row.heartbeat_s, now)
        row.pushed_at = max(row.pushed_at, now)

    def set_draining(self, worker: int, draining: bool, now: float = 0.0) -> None:
        row = self.local[worker]
        row.draining = draining
        row.pushed_at = max(row.pushed_at, now)

    def join(self, worker: int, now: float) -> None:
        """A (re)joining worker: new incarnation, empty row.  The single
        published snapshot makes bootstrap trivial here; the gossip plane
        models the real anti-entropy full-sync path."""
        old = self.local[worker]
        fresh = SSTRow(heartbeat_s=now, pushed_at=now, epoch=old.epoch + 1)
        self.local[worker] = fresh
        self.published[worker] = fresh.copy()
        self._cols.set_row(worker, fresh)

    # -- publication --------------------------------------------------------
    def push_load(self, worker: int, now: float) -> None:
        self.published[worker].ft_estimate_s = self.local[worker].ft_estimate_s
        # The liveness lane rides every publication.
        self.published[worker].heartbeat_s = self.local[worker].heartbeat_s
        self.published[worker].draining = self.local[worker].draining
        self.published[worker].epoch = self.local[worker].epoch
        # The health-digest lane rides the load cadence (both describe
        # the owner's instantaneous busyness).
        self.published[worker].health_queue_depth = self.local[worker].health_queue_depth
        self.published[worker].health_mem_occupancy = self.local[worker].health_mem_occupancy
        self.published[worker].health_fetch_util = self.local[worker].health_fetch_util
        self.published[worker].health_p99_latency_s = self.local[worker].health_p99_latency_s
        self.published[worker].pushed_at = now
        pub, cols = self.published[worker], self._cols
        cols.ft[worker] = pub.ft_estimate_s
        cols.heartbeat[worker] = pub.heartbeat_s
        cols.draining[worker] = pub.draining
        cols.pushed_at[worker] = now
        self._pushes += 1

    def push_cache(self, worker: int, now: float) -> None:
        self.published[worker].cache_bitmap = self.local[worker].cache_bitmap
        self.published[worker].free_cache_bytes = self.local[worker].free_cache_bytes
        self.published[worker].intent_bitmap = self.local[worker].intent_bitmap
        self.published[worker].fetch_model_id = self.local[worker].fetch_model_id
        self.published[worker].fetch_eta_s = self.local[worker].fetch_eta_s
        self.published[worker].heartbeat_s = self.local[worker].heartbeat_s
        self.published[worker].draining = self.local[worker].draining
        self.published[worker].epoch = self.local[worker].epoch
        self.published[worker].pushed_at = now
        pub, cols = self.published[worker], self._cols
        cols.bitmap[worker] = pub.cache_bitmap
        cols.avc[worker] = pub.free_cache_bytes
        cols.intent[worker] = pub.intent_bitmap
        cols.fetch_model[worker] = pub.fetch_model_id
        cols.fetch_eta[worker] = pub.fetch_eta_s
        cols.heartbeat[worker] = pub.heartbeat_s
        cols.draining[worker] = pub.draining
        cols.pushed_at[worker] = now
        self._pushes += 1

    def push(self, worker: int, now: float) -> None:
        self.push_load(worker, now)
        self.push_cache(worker, now)

    @property
    def total_pushes(self) -> int:
        return self._pushes

    # -- partitions ----------------------------------------------------------
    def set_partition(
        self, group_of: Optional[List[int]], now: float = 0.0
    ) -> None:
        """Install (or with ``None`` heal) a network cut, as a worker ->
        group-id map.  The single published snapshot models a table
        replicated on every side of the cut: writes keep landing on the
        writer's own side, but a *reader* stops receiving heartbeats from
        workers across the cut, so ``view`` classifies those rows from the
        frozen pre-cut heartbeat — per-reader lease verdicts disagree
        across the cut while every same-side verdict stays fresh, matching
        the gossip plane's behaviour without per-reader row copies (the
        planner ignores the payload of SUSPECT/DEAD rows anyway)."""
        self._partition = None if group_of is None else (list(group_of), now)
        self._partition_groups = (
            None if group_of is None else np.asarray(group_of, dtype=np.int64)
        )

    # -- reads ---------------------------------------------------------------
    def view(
        self,
        reader_worker: Optional[int] = None,
        now: Optional[float] = None,
    ) -> List[SSTRow]:
        """Snapshot as a scheduler on ``reader_worker`` sees it: its own row
        is always fresh (local), remote rows are the last published values.
        ``reader_worker=None`` returns the pure published view (used by a
        hypothetical external observer).  With a lease configured and
        ``now`` given, each row is annotated with the membership state the
        reader derives from the replicated heartbeat age."""
        rows = [r.copy() for r in self.published]
        if reader_worker is not None:
            rows[reader_worker] = self.local[reader_worker].copy()
        if self.lease is not None and now is not None:
            for w, row in enumerate(rows):
                if row.draining:
                    row.liveness = DEAD  # graceful departure: no new work
                elif w == reader_worker:
                    row.liveness = ALIVE  # self-evidence is never stale
                else:
                    hb = row.heartbeat_s
                    if self._partition is not None and reader_worker is not None:
                        group_of, cut_start = self._partition
                        if group_of[reader_worker] != group_of[w]:
                            # The reader's last heartbeat from across the
                            # cut is the fresher of the owner's pre-cut
                            # stamp and the cut onset.
                            hb = min(hb, cut_start)
                    row.liveness = self.lease.classify(max(0.0, now - hb))
        return rows

    def view_arrays(self, reader_worker: int, now: float):
        """Columnar twin of :meth:`view` for the indexed engine: the same
        snapshot (own row fresh, peers last-published, per-reader lease
        verdicts incl. the partition heartbeat clamp) as packed ``(W,)``
        arrays.  A handful of numpy column copies instead of W python row
        copies — the values are bit-identical to the row-list path."""
        from repro_torch.core.packed import PackedViews, classify_columns

        c = self._cols
        ft = c.ft.copy()
        bitmap = c.bitmap.copy()
        avc = c.avc.copy()
        pushed = c.pushed_at.copy()
        intent = c.intent.copy()
        fetch_model = c.fetch_model.copy()
        fetch_eta = c.fetch_eta.copy()
        hb = c.heartbeat.copy()
        draining = c.draining.copy()
        loc = self.local[reader_worker]
        ft[reader_worker] = loc.ft_estimate_s
        bitmap[reader_worker] = loc.cache_bitmap
        avc[reader_worker] = loc.free_cache_bytes
        pushed[reader_worker] = loc.pushed_at
        intent[reader_worker] = loc.intent_bitmap
        fetch_model[reader_worker] = loc.fetch_model_id
        fetch_eta[reader_worker] = loc.fetch_eta_s
        hb[reader_worker] = loc.heartbeat_s
        draining[reader_worker] = loc.draining
        if self._partition is not None and self.lease is not None:
            groups = self._partition_groups
            cut_start = self._partition[1]
            cross = groups != groups[reader_worker]
            hb = np.where(cross, np.minimum(hb, cut_start), hb)
        dead, suspect = classify_columns(
            self.lease, now, reader_worker, hb, draining
        )
        return PackedViews(
            reader=reader_worker, ft=ft, bitmap=bitmap, avc=avc,
            pushed_at=pushed, intent=intent, fetch_model=fetch_model,
            fetch_eta=fetch_eta, dead=dead, suspect=suspect,
        )
