"""Decentralized SST exchange: the metadata plane of the paper (§5.2),
copied from the JAX package so that the port stands alone.

The reference has two transports; the port has the first:

1. **GossipPlane** — the per-worker-view subsystem.  Every worker keeps a
   versioned local replica of every peer's row; a configurable periodic
   gossip/broadcast exchange (period, fan-out, drop probability; message
   delay sampled through ``core/netmodel.py`` by the driving engine)
   disseminates row updates epidemically.  Schedulers read *their own
   worker's* replica (``view(w)``), so different workers plan from
   genuinely different — possibly stale — snapshots, which is the regime
   that separates Compass from centralized baselines.

   Exchanges are **diff-based**: each worker keeps an append-only change
   log of rows it has learned and a per-peer cursor into that log, so a
   gossip round with ``k`` dirty rows ships (and costs) O(k), never a
   full-table copy (``benchmarks/bench_sst_microbench.py`` guards this).

2. **make_sst_allgather** — the collective transport: an all-gather of
   each rank's packed rows over a mesh dim (the analogue of the paper's
   RDMA one-sided row pushes), ``torch.distributed.all_gather_into_tensor``
   of the 16-lane rows that ``pack_row`` builds.

Row layout (uint32 lanes — exact bit transport; 16 lanes = 64 bytes =
exactly one cache line, keeping the wire format faithful to Fig. 5):
  [0] ft_estimate_s   (f32 bit pattern)
  [1] cache_bitmap lo 32 bits
  [2] cache_bitmap hi 32 bits
  [3] free cache KiB
  [4] queue_len
  [5] row version (monotonic per owner; merge is newest-(epoch, version))
  [6] intent_bitmap lo 32 bits (prefetch plane: resident ∪ in-flight ∪ queued)
  [7] intent_bitmap hi 32 bits
  [8] heartbeat_s     (f32 bit pattern — membership lease lane)
  [9] epoch (31 bits) | draining flag (bit 31)
  [10] in-flight fetch model id + 1 (0 = no fetch in flight)
  [11] fetch_eta_s    (f32 bit pattern — expected fetch completion)
  [12] health: queue depth            (core/healthplane.py digest lane)
  [13] health: GPU-memory occupancy   (f32 bit pattern, 0..1)
  [14] health: fetch-pipe utilization (f32 bit pattern, 0..1)
  [15] health: local task-latency p99 (f32 bit pattern, seconds)
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.state import ALIVE, DEAD, LeaseConfig, SSTRow, SUSPECT

ROW_WIDTH = 16


def pack_row(row: SSTRow, queue_len: int = 0) -> np.ndarray:
    out = np.zeros((ROW_WIDTH,), np.uint32)
    out[0] = np.float32(row.ft_estimate_s).view(np.uint32)
    out[1] = np.uint32(row.cache_bitmap & 0xFFFFFFFF)
    out[2] = np.uint32((row.cache_bitmap >> 32) & 0xFFFFFFFF)
    out[3] = np.uint32(min(row.free_cache_bytes / 1024.0, 2**32 - 1))
    out[4] = np.uint32(queue_len)
    out[5] = np.uint32(row.version & 0xFFFFFFFF)
    out[6] = np.uint32(row.intent_bitmap & 0xFFFFFFFF)
    out[7] = np.uint32((row.intent_bitmap >> 32) & 0xFFFFFFFF)
    out[8] = np.float32(row.heartbeat_s).view(np.uint32)
    out[9] = np.uint32((row.epoch & 0x7FFFFFFF) | (int(row.draining) << 31))
    out[10] = np.uint32(row.fetch_model_id + 1)
    out[11] = np.float32(row.fetch_eta_s).view(np.uint32)
    out[12] = np.uint32(min(row.health_queue_depth, 2**32 - 1))
    out[13] = np.float32(row.health_mem_occupancy).view(np.uint32)
    out[14] = np.float32(row.health_fetch_util).view(np.uint32)
    out[15] = np.float32(row.health_p99_latency_s).view(np.uint32)
    return out


def unpack_rows(table: np.ndarray) -> List[SSTRow]:
    rows = []
    for r in np.asarray(table, np.uint32):
        bitmap = int(r[1]) | (int(r[2]) << 32)
        intent = int(r[6]) | (int(r[7]) << 32)
        rows.append(
            SSTRow(
                ft_estimate_s=float(r[0:1].view(np.float32)[0]),
                cache_bitmap=bitmap,
                free_cache_bytes=float(r[3]) * 1024.0,
                version=int(r[5]),
                intent_bitmap=intent,
                heartbeat_s=float(r[8:9].view(np.float32)[0]),
                epoch=int(r[9]) & 0x7FFFFFFF,
                draining=bool(int(r[9]) >> 31),
                fetch_model_id=int(r[10]) - 1,
                fetch_eta_s=float(r[11:12].view(np.float32)[0]),
                health_queue_depth=int(r[12]),
                health_mem_occupancy=float(r[13:14].view(np.float32)[0]),
                health_fetch_util=float(r[14:15].view(np.float32)[0]),
                health_p99_latency_s=float(r[15:16].view(np.float32)[0]),
            )
        )
    return rows


def make_sst_allgather(mesh, axis: str = "data"):
    """Returns ``exchange(local_rows) -> table``: each rank's (k, ROW_WIDTH)
    uint32 rows (a tensor on the mesh's device, or a numpy array) gathered
    over the ranks of ``mesh``'s dim ``axis``, in rank order, on every one
    of them: exactly the post-push SST state every scheduler reads.  The
    collective moves the rows as int32 of the same bits (neither gloo nor
    NCCL takes uint32), so the table is bit for bit the rows."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import mesh_device

    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    dev = mesh_device(mesh)

    def exchange(local_rows):
        rows = torch.as_tensor(local_rows, device=dev).contiguous()
        if rows.dtype != torch.uint32 or rows.dim() != 2 or rows.shape[1] != ROW_WIDTH:
            raise ValueError(f"want (k, {ROW_WIDTH}) uint32 rows; got {rows.dtype} "
                             f"{tuple(rows.shape)}")
        out = torch.empty((n * rows.shape[0], ROW_WIDTH), dtype=torch.int32, device=dev)
        dist.all_gather_into_tensor(out, rows.view(torch.int32), group=group)
        return out.view(torch.uint32)

    return exchange


# --------------------------------------------------------------------------
# Per-worker SST views with diff-based gossip dissemination
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Tunables for the decentralized exchange.

    ``period_s``   — seconds between a worker's gossip rounds (the paper's
                     200 ms push cadence, §5.2, is the default).
    ``fanout``     — peers contacted per round.  ``fanout >= n-1`` degrades
                     to the paper's full broadcast; smaller fan-outs trade
                     message count for propagation hops (epidemic spread).
    ``drop_prob``  — per-message loss probability.  Lost rows are *not*
                     retransmitted point-to-point; they reach the peer via
                     relay through third parties, as in rumor mongering.
    ``wire_row_bytes`` — bytes per row update on the wire (the 16-lane
                     packed row above: exactly one 64-byte cache line,
                     owner header in-line).
    ``seed``       — peer-selection / drop-sampling RNG seed (combined
                     with the driving engine's seed for determinism).
    """

    period_s: float = 0.2
    fanout: int = 2
    drop_prob: float = 0.0
    wire_row_bytes: float = 64.0  # 16 packed lanes = one cache line
    seed: int = 0


#: One row update on the wire: (owner worker id, owner version, row).
RowUpdate = Tuple[int, int, SSTRow]

#: One outbound message: (destination worker, row updates, payload bytes).
GossipMessage = Tuple[int, List[RowUpdate], float]


class GossipPlane:
    """Decentralized Shared State Table with genuinely per-worker views.

    Unlike ``SharedStateTable`` (single published snapshot, uniform
    staleness), every worker ``w`` here holds its *own* replica of every
    peer's row, merged newest-version-wins from gossip messages.  Two
    workers generally disagree about the cluster state, and a scheduler
    running on ``w`` sees exactly ``w``'s view — the decentralized regime
    of the paper (§5).

    Complexity: a round with ``k`` dirty rows (rows this worker learned
    since it last contacted the chosen peer) does O(k) work and ships
    O(k) bytes.  Quiescent rounds are O(fanout).  This is achieved with an
    append-only per-worker change log plus a per-(worker, peer) cursor —
    a version-vector diff without the O(n) vector scan.

    The plane is engine-agnostic: ``exchange(w, now)`` returns the
    messages a round emits (drops already sampled) and the caller decides
    delivery timing — the simulator posts delayed ``deliver`` events using
    its network model; the serving engine folds delivery into its virtual
    clock via ``advance(now)``.
    """

    def __init__(
        self,
        n_workers: int,
        config: Optional[GossipConfig] = None,
        seed: int = 0,
        lease: Optional[LeaseConfig] = None,
    ) -> None:
        self.n_workers = n_workers
        self.config = config or GossipConfig()
        # Membership lane (None = static fleet: every row reads ALIVE and
        # staleness aggregation is unchanged).
        self.lease = lease
        # Stable int mix of config seed + engine seed (tuple seeding is
        # hash-based, hence process-dependent and deprecated).
        self.rng = random.Random(self.config.seed * 1_000_003 + seed * 7_919 + 17)
        # Ground truth: each worker's own row.
        self.local: List[SSTRow] = [SSTRow() for _ in range(n_workers)]
        # views[w][p]: worker w's replica of p's row.
        self.views: List[List[SSTRow]] = [
            [SSTRow() for _ in range(n_workers)] for _ in range(n_workers)
        ]
        # versions[w][p]: version of p's row that w holds.
        self.versions: List[List[int]] = [
            [0] * n_workers for _ in range(n_workers)
        ]
        # Change log: owner ids of rows w has learned, in learn order.
        # Cursor positions are *absolute* (entries ever appended);
        # ``_log_base[w]`` is how many entries have been truncated from the
        # front, so log index = absolute position - base.  A peer whose
        # cursor has fallen below the base missed truncated history and
        # gets an anti-entropy full sync on next contact.
        self._log: List[List[int]] = [[] for _ in range(n_workers)]
        self._log_base: List[int] = [0] * n_workers
        # cursor[w][q]: absolute position in w's log up to which w synced q.
        self._cursor: List[List[int]] = [
            [0] * n_workers for _ in range(n_workers)
        ]
        # Hard cap on retained log entries (strict memory bound even when
        # some peer is never contacted).
        self._max_log = max(64, 16 * n_workers)
        # Columnar mirror of ``views`` for the packed read path
        # (``view_arrays``): one (reader, owner)-indexed 2-D column per
        # planner lane, kept in sync O(1) per merged row by _bump /
        # deliver / push / join — exactly the rows those operations touch.
        # Deferred import: packed.py imports this module's row types.
        from repro_torch.core.packed import ColumnStore

        self._cols = ColumnStore((n_workers, n_workers))
        # Lazily-built full peer lists (broadcast fan-out only).
        self._all_peers: Dict[int, List[int]] = {}
        # Log length at which the next (O(n)) compaction check runs —
        # amortizes the min-cursor scan over >= n appends.
        self._compact_at: List[int] = [4 * n_workers] * n_workers
        # Stats.  *_sent counters use sender-side semantics (a dropped
        # message was still sent — the wire cost was paid); subtract
        # ``messages_dropped`` / use ``messages_delivered`` for what peers
        # actually received.
        self.messages_sent = 0
        self.messages_dropped = 0
        self.rows_sent = 0
        self.rounds = 0
        self.full_syncs = 0
        self._next_round_at = self.config.period_s  # for advance()

    # -- local updates (the owning worker's ground truth) -------------------
    def _bump(self, worker: int, now: float) -> None:
        row = self.local[worker]
        row.version += 1
        # Monotonic, like SharedStateTable: a caller omitting ``now`` must
        # not rewind the modification stamp (staleness-aware consumers
        # would misread the row as ancient).
        row.pushed_at = max(row.pushed_at, now)
        self._log[worker].append(worker)
        # Own view mirrors ground truth.
        self.views[worker][worker] = row.copy()
        self.versions[worker][worker] = row.version
        self._cols.set_row((worker, worker), row)

    def update_load(
        self, worker: int, ft_estimate_s: float, now: float = 0.0
    ) -> None:
        self.local[worker].ft_estimate_s = ft_estimate_s
        self._bump(worker, now)

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
        self._bump(worker, now)

    def update_intent(
        self, worker: int, intent_bitmap: int, now: float = 0.0
    ) -> None:
        """Prefetch-plane advertisement; disseminates like any other row
        mutation (diff-shipped, epidemically relayed)."""
        self.local[worker].intent_bitmap = intent_bitmap
        self._bump(worker, now)

    def update_health(
        self,
        worker: int,
        queue_depth: int,
        mem_occupancy: float,
        fetch_util: float,
        p99_latency_s: float,
        now: float = 0.0,
    ) -> None:
        """Health-digest lane (core/healthplane.py, wire lanes 12–15):
        refreshed by the engine right before the owner's gossip round, so
        every reader's view of fleet health is staleness-bounded by the
        dissemination period — no oracle, same discipline as load/cache."""
        row = self.local[worker]
        row.health_queue_depth = queue_depth
        row.health_mem_occupancy = mem_occupancy
        row.health_fetch_util = fetch_util
        row.health_p99_latency_s = p99_latency_s
        self._bump(worker, now)

    # -- membership (heartbeat/lease lane) ----------------------------------
    def heartbeat(self, worker: int, now: float) -> None:
        """Owner self-stamp; rides the ordinary diff machinery, so a
        reader's lease age includes gossip dissemination lag."""
        row = self.local[worker]
        row.heartbeat_s = max(row.heartbeat_s, now)
        self._bump(worker, now)

    def set_draining(self, worker: int, draining: bool, now: float = 0.0) -> None:
        """Graceful-departure advertisement: peers treat a draining row as
        DEAD for placement the moment they learn of it (no lease wait)."""
        self.local[worker].draining = draining
        self._bump(worker, now)

    def set_partition(
        self, group_of: Optional[List[int]], now: float = 0.0
    ) -> None:
        """Network-cut notification (same hook ``SharedStateTable`` has).
        The gossip plane needs no internal state for it: the simulator
        drops cross-cut deliveries, so each reader's replica of a
        cross-cut row freezes and its lease ages out naturally — and
        because rows travel as full state merged newest-(epoch, version)
        wins, post-heal rounds reconverge without replaying anything."""

    def join(self, worker: int, now: float) -> None:
        """A worker (re)joins the fleet with a fresh incarnation.

        The crashed process lost its replicas, change log, and cursors, so
        they reset; only the epoch counter survives (one integer on stable
        storage), bumped so pre-crash rows of this worker can never
        overwrite post-rejoin state (``SSTRow.merge_key``).  The join
        announcement rewinds every peer's cursor toward the joiner below
        its log base, so the next gossip contact ships an anti-entropy
        **full sync** — the joiner rebuilds its SST view through the same
        repair path that serves truncated-history laggards."""
        old_epoch = self.local[worker].epoch
        self.local[worker] = SSTRow(
            heartbeat_s=now, pushed_at=now, epoch=old_epoch + 1
        )
        self.views[worker] = [SSTRow() for _ in range(self.n_workers)]
        self.versions[worker] = [0] * self.n_workers
        self._cols.reset_reader(worker)
        self._log[worker] = []
        self._log_base[worker] = 0
        self._cursor[worker] = [0] * self.n_workers
        self._compact_at[worker] = 4 * self.n_workers
        self._bump(worker, now)
        for q in range(self.n_workers):
            if q != worker:
                self._cursor[q][worker] = self._log_base[q] - 1

    def _classify_row(self, row: SSTRow, is_self: bool, now: float) -> str:
        """Single source of truth for the membership verdict a reader
        derives from one replica row.  A peer the reader has *never heard
        from* (fresh joiner before its first full sync) is SUSPECT, not
        DEAD: absence of evidence only costs a penalty, or a rejoined
        worker would dump every job on itself until the anti-entropy sync
        lands."""
        if row.draining:
            return DEAD
        if is_self:
            return ALIVE  # self-evidence is never stale
        if row.version == 0:
            return SUSPECT
        return self.lease.classify(max(0.0, now - row.heartbeat_s))

    def liveness(self, reader: int, peer: int, now: float) -> str:
        """Membership state ``reader`` assigns ``peer`` from its own
        (possibly stale) replica — no oracle."""
        if self.lease is None:
            return ALIVE
        row = self.local[reader] if peer == reader else self.views[reader][peer]
        return self._classify_row(row, peer == reader, now)

    # -- exchange ------------------------------------------------------------
    def _full_peer_list(self, worker: int) -> List[int]:
        peers = self._all_peers.get(worker)
        if peers is None:
            peers = [w for w in range(self.n_workers) if w != worker]
            self._all_peers[worker] = peers
        return peers

    def _peers(self, worker: int) -> List[int]:
        n = self.n_workers
        fanout = min(self.config.fanout, n - 1)
        if fanout <= 0:
            return []
        if fanout == n - 1:  # full broadcast
            return self._full_peer_list(worker)
        if fanout > (n - 1) // 2:
            # Dense fan-out: rejection sampling degrades; sample directly
            # from the cached full peer list instead.
            return self.rng.sample(self._full_peer_list(worker), fanout)
        # Sparse fan-out: rejection-sample distinct peers — O(fanout)
        # expected, so a quiescent round never touches O(n) state.
        chosen: List[int] = []
        seen = {worker}
        while len(chosen) < fanout:
            q = self.rng.randrange(n)
            if q not in seen:
                seen.add(q)
                chosen.append(q)
        return chosen

    def exchange(self, worker: int, now: float) -> List[GossipMessage]:
        """One gossip round for ``worker``: pick fan-out peers, ship each
        the rows learned since the last contact (deduped, newest version).
        Message drops are sampled here; only surviving messages are
        returned.

        Cost is O(log entries since that peer's last contact) — i.e. the
        rows touched since the two last spoke, never a table scan; a
        quiescent round allocates nothing.  A peer so far behind that its
        history was truncated (cursor < log base) gets an anti-entropy
        **full sync** of every row this worker knows — the standard rare
        repair path that keeps the log memory strictly bounded."""
        self.rounds += 1
        out: List[GossipMessage] = []
        base = self._log_base[worker]
        log = self._log[worker]
        head = base + len(log)
        for q in self._peers(worker):
            lo = self._cursor[worker][q]
            self._cursor[worker][q] = head
            full_sync = lo < base
            if full_sync:
                # Anti-entropy repair: truncated history, send everything.
                self.full_syncs += 1
                updates = [
                    (o, self.versions[worker][o], self.views[worker][o].copy())
                    for o in range(self.n_workers)
                ]
            else:
                entries = log[lo - base:]
                if not entries:
                    continue
                dirty: List[int] = []
                seen: Dict[int, bool] = {}
                for owner in entries:
                    if owner not in seen:
                        seen[owner] = True
                        dirty.append(owner)
                updates = [
                    (o, self.versions[worker][o], self.views[worker][o].copy())
                    for o in dirty
                ]
            self.messages_sent += 1
            self.rows_sent += len(updates)
            if self.rng.random() < self.config.drop_prob:
                self.messages_dropped += 1
                if full_sync:
                    # A lost diff is repaired by relay through other peers,
                    # but a lost full sync is the repair of last resort —
                    # rewind the cursor so the next contact retries it.
                    self._cursor[worker][q] = lo
                continue
            out.append((q, updates, self.config.wire_row_bytes * len(updates)))
        self._compact(worker)
        return out

    def deliver(self, worker: int, updates: Sequence[RowUpdate], now: float) -> None:
        """Merge a received message into ``worker``'s view (newest version
        wins) and queue accepted rows for relay to this worker's own peers
        — the epidemic step that lets updates cross the cluster even with
        ``fanout < n-1``."""
        for owner, version, row in updates:
            if owner == worker:
                continue  # own row is authoritative, never overwritten
            held = self.views[worker][owner]
            # Newest-(epoch, version) wins: a rejoined owner's fresh row
            # (higher epoch, version restarted) beats any pre-crash echo
            # still circulating — DEAD rows are never resurrected.
            if (row.epoch, version) > (held.epoch, self.versions[worker][owner]):
                self.versions[worker][owner] = version
                self.views[worker][owner] = row.copy()
                self._cols.set_row((worker, owner), row, version)
                self._log[worker].append(owner)

    def _compact(self, worker: int) -> None:
        """Bound the retained log.  First drop the prefix every peer has
        already seen; if the log still exceeds the hard cap (because some
        peer hasn't been contacted), force-truncate — laggards repair via
        the full-sync path in ``exchange``.  The O(n) min-cursor scan only
        runs once the log has grown by >= 4n entries since the last check,
        so its cost amortizes to O(1) per logged row."""
        log = self._log[worker]
        if len(log) < self._compact_at[worker] or self.n_workers <= 1:
            return
        base = self._log_base[worker]
        cursors = self._cursor[worker]
        floor = min(c for i, c in enumerate(cursors) if i != worker)
        drop = max(0, floor - base)
        if len(log) - drop > self._max_log:
            drop = len(log) - self._max_log // 2  # force: keep recent half-cap
        if drop > 0:
            self._log[worker] = log[drop:]
            self._log_base[worker] = base + drop
        self._compact_at[worker] = len(self._log[worker]) + 4 * self.n_workers

    def mark_synced(self, worker: int) -> None:
        """Consider every peer caught up with ``worker``'s log (e.g. right
        after a bootstrap broadcast, or between microbenchmark rounds) and
        drop the retained entries."""
        head = self._log_base[worker] + len(self._log[worker])
        self._cursor[worker] = [head] * self.n_workers
        self._log_base[worker] = head
        self._log[worker] = []

    # -- bootstrap / compatibility -------------------------------------------
    def push(self, worker: int, now: float) -> None:
        """Synchronous broadcast of ``worker``'s current row to every peer
        (bootstrap/warm-start only; live dissemination goes through
        ``exchange``).  Mirrors ``SharedStateTable.push``."""
        if self.local[worker].version == 0:
            self._bump(worker, now)
        row = self.local[worker]
        for q in range(self.n_workers):
            if q == worker:
                continue
            held = self.views[q][worker]
            if row.merge_key() > (held.epoch, self.versions[q][worker]):
                self.versions[q][worker] = row.version
                self.views[q][worker] = row.copy()
                self._cols.set_row((q, worker), row)

    @property
    def messages_delivered(self) -> int:
        return self.messages_sent - self.messages_dropped

    @property
    def total_pushes(self) -> int:
        return self.messages_sent

    # -- reads ----------------------------------------------------------------
    def view(
        self,
        reader_worker: Optional[int] = None,
        now: Optional[float] = None,
    ) -> List[SSTRow]:
        """The table as the scheduler on ``reader_worker`` sees it: its own
        row fresh from ground truth, peer rows from its gossip replicas.
        ``reader_worker=None`` returns ground truth for every row (an
        omniscient observer, used by diagnostics).  With a lease configured
        and ``now`` given, rows carry the reader's membership verdict
        (``liveness``): planners price SUSPECT rows up and DEAD rows out."""
        if reader_worker is None:
            rows = [r.copy() for r in self.local]
        else:
            rows = [r.copy() for r in self.views[reader_worker]]
            rows[reader_worker] = self.local[reader_worker].copy()
        if self.lease is not None and now is not None:
            for w, row in enumerate(rows):
                row.liveness = self._classify_row(
                    row, w == reader_worker, now
                )
        return rows

    def view_arrays(self, reader_worker: int, now: float):
        """Columnar twin of :meth:`view` for the indexed engine: the
        reader's replica set as packed ``(W,)`` arrays with vectorized
        membership verdicts (incl. the never-heard-from ⇒ SUSPECT rule).
        The own-row mirror maintained by ``_bump`` makes the reader's
        slice already ground-truth-fresh, so this is pure column copies
        — bit-identical values to the row-list path."""
        from repro_torch.core.packed import PackedViews, classify_columns

        c = self._cols
        dead, suspect = classify_columns(
            self.lease, now, reader_worker,
            c.heartbeat[reader_worker], c.draining[reader_worker],
            version=c.version[reader_worker],
        )
        return PackedViews(
            reader=reader_worker,
            ft=c.ft[reader_worker].copy(),
            bitmap=c.bitmap[reader_worker].copy(),
            avc=c.avc[reader_worker].copy(),
            pushed_at=c.pushed_at[reader_worker].copy(),
            intent=c.intent[reader_worker].copy(),
            fetch_model=c.fetch_model[reader_worker].copy(),
            fetch_eta=c.fetch_eta[reader_worker].copy(),
            dead=dead, suspect=suspect,
        )

    def staleness(self, now: float, reader_worker: Optional[int] = None) -> float:
        """Max age (seconds) of any remote row in the reader's view;
        aggregated over all readers when ``reader_worker`` is None.

        Rows of peers the reader has marked DEAD (lease expired or
        draining) are excluded: a departed worker's frozen row would
        otherwise inflate reported staleness forever, even though no
        scheduler consumes it."""
        readers = (
            range(self.n_workers) if reader_worker is None else [reader_worker]
        )
        worst = 0.0
        for r in readers:
            for p in range(self.n_workers):
                if p == r:
                    continue
                if self.lease is not None and self.liveness(r, p, now) == DEAD:
                    continue
                worst = max(worst, now - self.views[r][p].pushed_at)
        return worst

    # -- synchronous stepping (virtual-clock engines) -------------------------
    def advance(self, now: float) -> None:
        """Run every gossip round due up to ``now`` with immediate
        delivery (message delay folded into the round period).  Used by
        engines with a coarse virtual clock (e.g. ``serving/engine.py``);
        the discrete-event simulator drives ``exchange``/``deliver``
        itself with sampled network delays."""
        while self._next_round_at <= now:
            t = self._next_round_at
            for w in range(self.n_workers):
                for q, updates, _nbytes in self.exchange(w, t):
                    self.deliver(q, updates, t)
            self._next_round_at += self.config.period_s
