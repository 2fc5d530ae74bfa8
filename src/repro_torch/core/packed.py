"""Columnar (packed) SST views for fleet-scale planning.

The reference read path materializes a reader's view as ``List[SSTRow]``
— one python object copy per worker per plan/adjust call.  At 500
workers that alone dominates the event loop.  This module provides the
indexed alternative:

* :class:`ColumnStore` — a columnar mirror of the planner-relevant
  SSTRow lanes, maintained **O(1) per dirty row** by the metadata planes
  (``SharedStateTable`` mirrors its single published table on each push;
  ``GossipPlane`` mirrors each reader's replica on each ``_bump`` /
  ``deliver`` / ``join`` / ``push`` — exactly the rows those operations
  already touch, never a table scan).

* :class:`PackedViews` — what a reader actually hands the planners:
  parallel ``(W,)`` numpy arrays plus the reader's vectorized membership
  verdicts.  Building one is a handful of numpy column copies —
  microseconds at 500 workers — instead of W python row copies.

The planners' batched paths (``NavigatorScheduler._plan_packed`` etc.)
consume these arrays with float64 numpy arithmetic that replays the
scalar reference expressions element-for-element, so placement decisions
are bit-exact with the row-list path (pinned by chaos family 7 and
tests/test_engine_indexed.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.state import ALIVE, DEAD, SUSPECT, LeaseConfig, SSTRow

# Shape of a ColumnStore: (W,) for a single table, (R, W) for per-reader
# replica sets.
Shape = Union[int, Tuple[int, int]]


class ColumnStore:
    """Columnar mirror of the planner-relevant SSTRow lanes.

    ``set_row(idx, row, version)`` copies one row in O(1); ``idx`` is a
    worker id for a ``(W,)`` store or a ``(reader, owner)`` pair for an
    ``(R, W)`` store.  Health lanes are deliberately absent — planners
    never read them, and the health plane keeps its own digests.
    """

    __slots__ = (
        "ft", "bitmap", "avc", "pushed_at", "intent",
        "fetch_model", "fetch_eta", "heartbeat", "draining", "version",
    )

    def __init__(self, shape: Shape) -> None:
        self.ft = np.zeros(shape)
        self.bitmap = np.zeros(shape, dtype=np.uint64)
        self.avc = np.zeros(shape)
        self.pushed_at = np.zeros(shape)
        self.intent = np.zeros(shape, dtype=np.uint64)
        self.fetch_model = np.full(shape, -1, dtype=np.int64)
        self.fetch_eta = np.zeros(shape)
        self.heartbeat = np.zeros(shape)
        self.draining = np.zeros(shape, dtype=bool)
        self.version = np.zeros(shape, dtype=np.int64)

    def set_row(self, idx, row: SSTRow, version: Optional[int] = None) -> None:
        self.ft[idx] = row.ft_estimate_s
        self.bitmap[idx] = row.cache_bitmap
        self.avc[idx] = row.free_cache_bytes
        self.pushed_at[idx] = row.pushed_at
        self.intent[idx] = row.intent_bitmap
        self.fetch_model[idx] = row.fetch_model_id
        self.fetch_eta[idx] = row.fetch_eta_s
        self.heartbeat[idx] = row.heartbeat_s
        self.draining[idx] = row.draining
        self.version[idx] = row.version if version is None else version

    def reset_reader(self, reader: int) -> None:
        """Blank one reader's replica slice (gossip rejoin): every lane
        back to the fresh-``SSTRow()`` defaults."""
        self.ft[reader] = 0.0
        self.bitmap[reader] = 0
        self.avc[reader] = 0.0
        self.pushed_at[reader] = 0.0
        self.intent[reader] = 0
        self.fetch_model[reader] = -1
        self.fetch_eta[reader] = 0.0
        self.heartbeat[reader] = 0.0
        self.draining[reader] = False
        self.version[reader] = 0


@dataclasses.dataclass
class PackedViews:
    """One reader's SST view as parallel ``(W,)`` columns.

    ``dead`` / ``suspect`` carry the reader's per-peer membership
    verdicts (mutually exclusive; neither set ⇒ ALIVE), computed with the
    same precedence as the scalar classifiers: draining ⇒ DEAD beats
    everything, self-evidence is never stale, a never-heard-from gossip
    peer (version 0) is SUSPECT, otherwise the lease classifies the
    replicated heartbeat age.
    """

    reader: int
    ft: np.ndarray           # float64 — FT(w) estimates
    bitmap: np.ndarray       # uint64  — cache bitmaps
    avc: np.ndarray          # float64 — free cache bytes (AVC)
    pushed_at: np.ndarray    # float64 — last-modification stamps
    intent: np.ndarray       # uint64  — prefetch intent bitmaps
    fetch_model: np.ndarray  # int64   — in-flight fetch model id (−1 none)
    fetch_eta: np.ndarray    # float64 — absolute in-flight fetch ETA
    dead: np.ndarray         # bool
    suspect: np.ndarray      # bool

    @property
    def n_workers(self) -> int:
        return int(self.ft.shape[0])

    def liveness(self, worker: int) -> str:
        if self.dead[worker]:
            return DEAD
        if self.suspect[worker]:
            return SUSPECT
        return ALIVE

    @classmethod
    def from_rows(cls, rows: Sequence[SSTRow], reader: int = 0) -> "PackedViews":
        """Pack an already-annotated row list (tests, external callers).
        Row ``liveness`` annotations are taken at face value."""
        n = len(rows)
        pv = cls(
            reader=reader,
            ft=np.array([r.ft_estimate_s for r in rows]),
            bitmap=np.array([r.cache_bitmap for r in rows], dtype=np.uint64),
            avc=np.array([r.free_cache_bytes for r in rows]),
            pushed_at=np.array([r.pushed_at for r in rows]),
            intent=np.array([r.intent_bitmap for r in rows], dtype=np.uint64),
            fetch_model=np.array([r.fetch_model_id for r in rows], dtype=np.int64),
            fetch_eta=np.array([r.fetch_eta_s for r in rows]),
            dead=np.array([r.liveness == DEAD for r in rows], dtype=bool),
            suspect=np.array([r.liveness == SUSPECT for r in rows], dtype=bool),
        )
        assert pv.ft.shape == (n,)
        return pv


def classify_columns(
    lease: Optional[LeaseConfig],
    now: float,
    reader: int,
    heartbeat: np.ndarray,
    draining: np.ndarray,
    version: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized membership verdicts for one reader — the columnar twin
    of ``SharedStateTable.view`` / ``GossipPlane._classify_row``.

    Returns ``(dead, suspect)`` bool arrays.  ``version`` enables the
    gossip plane's never-heard-from ⇒ SUSPECT rule; ``heartbeat`` must
    already include any partition clamp the caller applies.
    """
    n = heartbeat.shape[0]
    if lease is None:
        return np.zeros(n, dtype=bool), np.zeros(n, dtype=bool)
    age = np.maximum(0.0, now - heartbeat)
    dead = age > lease.dead_after_s
    suspect = (~dead) & (age > lease.suspect_after_s)
    if version is not None:
        never_heard = version == 0
        dead = np.where(never_heard, False, dead)
        suspect = np.where(never_heard, True, suspect)
    # Self-evidence is never stale ...
    dead[reader] = False
    suspect[reader] = False
    # ... but a draining row is DEAD for placement, even the reader's own.
    dead = dead | draining
    suspect = suspect & ~draining
    return dead, suspect


__all__ = ["ColumnStore", "PackedViews", "classify_columns"]
