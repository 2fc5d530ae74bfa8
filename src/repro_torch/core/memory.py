"""GPU Memory Manager (§3.3, §5.3).

Manages the *Navigator cache*: ML model objects resident in GPU memory.
Fetching a model costs ``TD_model(m, w) = |m|/PCIe_bw + delta_PCIe`` (§4.1).
Two eviction policies are implemented exactly as described:

* **FIFO** (§5.3.1): evict non-in-use models in insertion order until the
  new model fits.
* **Queue-lookahead** (§5.3.2): inspect a fixed number of upcoming tasks on
  the worker's execution queue; models needed sooner get higher retention
  priority; models not needed in the window are evicted first (FIFO order
  among equals).

Models pinned by currently-executing tasks are never evicted.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import bitmaps
from repro_torch.core.netmodel import AcceleratorLink
from repro_torch.core.types import MLModel


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_fetched: float = 0.0
    # Speculative (plan-driven) prefetch accounting.  ``bytes_fetched``
    # stays the total PCIe traffic (demand + prefetch); the fields below
    # split out the speculative share and its outcome.
    prefetch_fetches: int = 0
    prefetch_bytes: float = 0.0
    prefetch_useful: int = 0        # prefetched model later demanded
    prefetch_aborted: int = 0       # preempted/cancelled mid-flight
    prefetch_wasted: int = 0        # never demanded before leaving cache
    prefetch_wasted_bytes: float = 0.0
    # Fleet-churn accounting: PCIe bytes thrown away because the worker
    # died/drained mid-transfer or with speculative contents nobody used.
    churn_wasted_bytes: float = 0.0
    churn_resets: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0


class GpuMemoryManager:
    """Per-worker model cache with scheduler-triggered management.

    The worker makes local fetch/evict decisions based on its assigned
    tasks (§3.3); the scheduler influences placement globally through the
    published cache bitmap.
    """

    FIFO = "fifo"
    LOOKAHEAD = "lookahead"

    def __init__(
        self,
        capacity_bytes: float,
        models: Mapping[int, MLModel],
        link: AcceleratorLink,
        policy: str = LOOKAHEAD,
        lookahead_depth: int = 8,
        compression_ratio: float = 0.6,
    ) -> None:
        if policy not in (self.FIFO, self.LOOKAHEAD):
            raise ValueError(f"unknown eviction policy {policy!r}")
        self.capacity_bytes = capacity_bytes
        self.models = dict(models)
        self.link = link
        self.policy = policy
        self.lookahead_depth = lookahead_depth
        # The Navigator cache holds models in *compressed* form; execution
        # memory holds a decompressed instance per currently-active task
        # (§3.3).  ``compression_ratio`` is compressed/decompressed bytes.
        self.compression_ratio = compression_ratio
        # Insertion-ordered contents: model_id -> cached (compressed) size.
        self._contents: "collections.OrderedDict[int, float]" = collections.OrderedDict()
        self._pinned: Dict[int, int] = {}  # model_id -> pin count
        # Decompressed execution-memory reservations: model_id -> count.
        self._executing: Dict[int, int] = {}
        # Models brought in speculatively and not yet demanded; leaving
        # the cache while in this set counts as wasted prefetch.
        self._prefetched_unused: set = set()
        self.stats = CacheStats()

    def cached_size(self, model_id: int) -> float:
        return self.models[model_id].size_bytes * self.compression_ratio

    # -- inspection ----------------------------------------------------------
    def has(self, model_id: int) -> bool:
        return model_id in self._contents

    def can_host(self, model_id: int) -> bool:
        """Whether this GPU can *ever* execute the model: one compressed
        cache copy plus one decompressed execution instance must fit."""
        return (
            self.cached_size(model_id) + self.models[model_id].size_bytes
            <= self.capacity_bytes
        )

    @property
    def used_bytes(self) -> float:
        return sum(self._contents.values())

    @property
    def exec_reserved_bytes(self) -> float:
        """Execution memory: one decompressed instance per active task."""
        return sum(
            self.models[m].size_bytes * n for m, n in self._executing.items()
        )

    @property
    def free_bytes(self) -> float:
        """AVC(w) (§4.1): capacity minus cache minus execution memory."""
        return self.capacity_bytes - self.used_bytes - self.exec_reserved_bytes

    @property
    def available_bytes(self) -> float:
        """AVC(w) as *advertised* under the prefetch plane: speculative
        contents nobody has demanded yet are the cheapest victims, so the
        space they occupy is still 'available' to the placement cost —
        otherwise speculation would make workers look full and repel the
        very tasks it prefetched for."""
        return self.free_bytes + self.unused_prefetched_bytes()

    @property
    def bitmap(self) -> int:
        return bitmaps.pack(self._contents.keys())

    def resident_models(self) -> List[int]:
        return list(self._contents.keys())

    # -- pinning (models of running tasks are not evictable) -----------------
    def pin(self, model_id: int) -> None:
        self._pinned[model_id] = self._pinned.get(model_id, 0) + 1

    def unpin(self, model_id: int) -> None:
        n = self._pinned.get(model_id, 0) - 1
        if n <= 0:
            self._pinned.pop(model_id, None)
        else:
            self._pinned[model_id] = n

    def _evictable(self) -> List[int]:
        return [m for m in self._contents if m not in self._pinned]

    # -- prefetch bookkeeping -------------------------------------------------
    def _note_demand_use(self, model_id: int) -> None:
        """First demand touch of a speculatively fetched model."""
        if model_id in self._prefetched_unused:
            self._prefetched_unused.discard(model_id)
            self.stats.prefetch_useful += 1

    def _note_departure(self, model_id: int, bytes_lost: float) -> None:
        """A model left the cache; if it was prefetched and never
        demanded, its transfer was wasted."""
        if model_id in self._prefetched_unused:
            self._prefetched_unused.discard(model_id)
            self.stats.prefetch_wasted += 1
            self.stats.prefetch_wasted_bytes += bytes_lost

    def _evict(self, model_id: int) -> None:
        size = self._contents.pop(model_id)
        self.stats.evictions += 1
        self._note_departure(model_id, size)

    def unused_prefetched_bytes(self) -> float:
        """Resident bytes brought in speculatively and never demanded so
        far (end-of-run residual waste, reported by the benchmarks)."""
        return sum(
            self._contents[m]
            for m in self._prefetched_unused
            if m in self._contents
        )

    # -- eviction ------------------------------------------------------------
    def _eviction_order(self, upcoming_model_ids: Sequence[int]) -> List[int]:
        """Victims, most-evictable first."""
        candidates = self._evictable()
        if self.policy == self.FIFO:
            return candidates  # already insertion ordered
        # Queue-lookahead: next-use position within the lookahead window;
        # models not needed in the window sort first (use position = inf),
        # then by *latest* next use; FIFO breaks ties.  Speculative
        # contents nobody demanded yet are the cheapest victims of all —
        # evicting them merely un-speculates.
        window = list(upcoming_model_ids)[: self.lookahead_depth]
        next_use: Dict[int, int] = {}
        for pos, mid in enumerate(window):
            if mid is not None and mid not in next_use:
                next_use[mid] = pos
        fifo_pos = {mid: i for i, mid in enumerate(self._contents)}
        return sorted(
            candidates,
            key=lambda m: (
                m not in self._prefetched_unused or m in next_use,
                -next_use.get(m, 10**9),
                fifo_pos[m],
            ),
        )

    def would_evict(
        self, model_id: int, upcoming_model_ids: Sequence[int] = ()
    ) -> List[int]:
        """Which models eviction for ``model_id`` would remove (no mutation)."""
        size = self.cached_size(model_id)
        if self.has(model_id) or size <= self.free_bytes:
            return []
        victims: List[int] = []
        freed = self.free_bytes
        for victim in self._eviction_order(upcoming_model_ids):
            if freed >= size:
                break
            victims.append(victim)
            freed += self._contents[victim]
        if freed < size:
            return []  # cannot free enough right now (pins)
        return victims

    # -- fetch ---------------------------------------------------------------
    def fetch_seconds(self, model_id: int) -> float:
        """TD_model(m, w) for a cache miss."""
        return self.link.fetch_time(self.models[model_id].size_bytes)

    def ensure(
        self,
        model_id: int,
        upcoming_model_ids: Sequence[int] = (),
    ) -> Optional[Tuple[float, List[int]]]:
        """Make ``model_id`` resident.

        Returns ``(fetch_seconds, evicted_ids)``; ``fetch_seconds == 0.0``
        on a cache hit.  Returns ``None`` if the model cannot currently be
        made resident (pinned working set too large) — the task dispatcher
        then leaves the task on the queue and proceeds (§3.2).
        """
        if model_id not in self.models:
            raise KeyError(f"unknown model id {model_id}")
        if self.has(model_id):
            self.stats.hits += 1
            self._note_demand_use(model_id)
            # refresh nothing: FIFO order is by insertion, not use (§5.3.1)
            return 0.0, []
        size = self.cached_size(model_id)
        if size + self.models[model_id].size_bytes > self.capacity_bytes:
            raise ValueError(
                f"model {model_id} cached+decompressed footprint exceeds GPU capacity"
            )
        victims = self.would_evict(model_id, upcoming_model_ids)
        if size > self.free_bytes and not victims:
            return None
        for v in victims:
            self._evict(v)
        self._contents[model_id] = size
        self.stats.misses += 1
        self.stats.bytes_fetched += size
        return self.fetch_seconds(model_id), victims

    # -- speculative fetch (predictive prefetch plane) ------------------------
    def begin_prefetch(
        self,
        model_id: int,
        upcoming_model_ids: Sequence[int] = (),
        allow_evict: bool = False,
    ) -> Optional[Tuple[float, List[int]]]:
        """Start a speculative fetch of ``model_id`` on the fetch pipe.

        Like :meth:`ensure` but with speculative accounting (no demand
        miss is charged) and a fetch-pin held until
        :meth:`complete_prefetch` / :meth:`abort_prefetch` — an in-flight
        speculative model is never an eviction victim.  With
        ``allow_evict=False`` (the default) the fetch only proceeds into
        free memory: speculation must not displace resident models.
        Returns ``None`` when the model is already resident or cannot be
        staged right now.
        """
        if model_id not in self.models:
            raise KeyError(f"unknown model id {model_id}")
        if self.has(model_id):
            return None
        size = self.cached_size(model_id)
        if size + self.models[model_id].size_bytes > self.capacity_bytes:
            return None
        victims: List[int] = []
        if size > self.free_bytes:
            if not allow_evict:
                return None
            victims = self.would_evict(model_id, upcoming_model_ids)
            if not victims:
                return None
        for v in victims:
            self._evict(v)
        self._contents[model_id] = size
        self._prefetched_unused.add(model_id)
        self.pin(model_id)  # fetch-pin for the transfer duration
        self.stats.prefetch_fetches += 1
        self.stats.prefetch_bytes += size
        self.stats.bytes_fetched += size
        return self.fetch_seconds(model_id), victims

    def complete_prefetch(self, model_id: int) -> None:
        """The speculative transfer finished: release the fetch-pin (the
        model stays resident, evictable per policy)."""
        self.unpin(model_id)

    def abort_prefetch(self, model_id: int, fraction_done: float = 0.0) -> None:
        """A demand fetch preempted (or a cancellation killed) the
        speculative transfer.  The partial bytes moved so far are wasted;
        the un-transferred remainder never hit the pipe."""
        self.unpin(model_id)
        size = self._contents.pop(model_id, None)
        if size is None:
            return
        frac = min(1.0, max(0.0, fraction_done))
        undone = size * (1.0 - frac)
        self.stats.bytes_fetched -= undone
        self.stats.prefetch_bytes -= undone
        self.stats.prefetch_aborted += 1
        self._prefetched_unused.discard(model_id)
        self.stats.prefetch_wasted += 1
        self.stats.prefetch_wasted_bytes += size * frac

    def abort_fetch(self, model_id: int, fraction_done: float = 0.0) -> None:
        """Tear down an in-flight *demand* fetch whose owning task died or
        was re-routed off this worker (crash/drain): release the
        fetch-pin, drop the partial model, and account the bytes moved so
        far as churn waste (the un-transferred remainder never hit the
        pipe, so it comes back off ``bytes_fetched``)."""
        self.unpin(model_id)
        size = self._contents.pop(model_id, None)
        if size is None:
            return
        frac = min(1.0, max(0.0, fraction_done))
        self.stats.bytes_fetched -= size * (1.0 - frac)
        self.stats.churn_wasted_bytes += size * frac

    def reset(self, graceful: bool = False) -> float:
        """The worker left the fleet: every resident model, pin, and
        execution reservation is gone.  Speculative contents nobody
        demanded count as wasted prefetch; on a crash (``graceful=False``)
        the lost residency is also churn waste (a drain served its cache
        until the end, so only the unused speculation is charged).
        Returns the resident bytes dropped."""
        lost = self.used_bytes
        for mid in list(self._prefetched_unused):
            size = self._contents.get(mid, 0.0)
            self.stats.prefetch_wasted += 1
            self.stats.prefetch_wasted_bytes += size
            self.stats.churn_wasted_bytes += size
        if not graceful:
            self.stats.churn_wasted_bytes += lost - self.unused_prefetched_bytes()
        self._contents.clear()
        self._pinned.clear()
        self._executing.clear()
        self._prefetched_unused.clear()
        self.stats.churn_resets += 1
        return lost

    # -- execution memory (§3.3) ----------------------------------------------
    def begin_execution(
        self, model_id: int, upcoming_model_ids: Sequence[int] = ()
    ) -> None:
        """Reserve execution memory for a decompressed instance of
        ``model_id``; evicts cached models (per policy) to make headroom.
        Pinned models are never evicted — if the pinned working set forces
        an overcommit we allow it (the real system stalls/uses host paging;
        this is rare and self-corrects when tasks finish)."""
        self._executing[model_id] = self._executing.get(model_id, 0) + 1
        self.pin(model_id)
        self._note_demand_use(model_id)
        if self.free_bytes >= 0:
            return
        for victim in self._eviction_order(upcoming_model_ids):
            if self.free_bytes >= 0:
                break
            self._evict(victim)

    def end_execution(self, model_id: int) -> None:
        n = self._executing.get(model_id, 0) - 1
        if n <= 0:
            self._executing.pop(model_id, None)
        else:
            self._executing[model_id] = n
        self.unpin(model_id)

    def drop(self, model_id: int) -> None:
        size = self._contents.pop(model_id, None)
        if size is not None:
            self._note_departure(model_id, size)

    def preload(self, model_ids: Iterable[int]) -> None:
        """Warm the cache without counting stats (test/benchmark setup)."""
        for mid in model_ids:
            size = self.cached_size(mid)
            if size > self.free_bytes:
                raise ValueError("preload exceeds capacity")
            self._contents[mid] = size
