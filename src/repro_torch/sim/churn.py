"""Fleet-churn schedules for the simulator, copied from the JAX package
so that the port stands alone.

A churn schedule is a seeded, replayable list of :class:`ChurnEvent`
records (crash / join / drain at scripted times) the simulator executes
alongside the workload — the chaos-test harness (``tests/chaos.py``)
replays the same schedule across schedulers and asserts invariants, and
``benchmarks/bench_churn.py`` sweeps MTBF × policy × fleet with it.

Semantics (enforced by ``sim/engine.py``):

* ``crash``  — the worker vanishes instantly: its GPU task, queue,
  in-flight fetch, gossip replica, and cache contents are lost.  Peers
  only learn of the death when its heartbeat lease expires in their own
  SST views.
* ``drain``  — graceful departure: the worker advertises ``draining``
  (peers stop placing work as soon as they see the flag), re-routes its
  queued tasks, aborts its in-flight fetch, finishes its running task,
  then leaves.
* ``join``   — the worker (re)enters with a cold cache, a fresh gossip
  incarnation (epoch + 1), and an empty SST view rebuilt by anti-entropy
  full-sync from the first peers to contact it.
* ``partition`` — the interconnect splits into the event's ``groups``:
  every worker stays up and keeps executing, but messages (inputs,
  outputs, gossip, intents) between groups are lost.  Cross-cut readers
  watch each other's heartbeats age to SUSPECT and then DEAD while
  same-side readers still see ALIVE — the asymmetric-reachability regime
  fail-stop churn never generates.  Workers do NOT bump their epoch (no
  process died), so healed rows win replica merges on version alone.
* ``heal``  — the cut closes; reachability is global again.  Schedules
  must heal every partition (``validate_schedule`` enforces it) so that
  work stranded behind a cut can always make progress eventually.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

CRASH = "crash"
JOIN = "join"
DRAIN = "drain"
PARTITION = "partition"
HEAL = "heal"


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    time: float
    kind: str  # CRASH | JOIN | DRAIN | PARTITION | HEAL
    worker: int = -1  # unused (-1) for partition/heal
    # PARTITION only: the connected components the fleet splits into.
    # Workers not listed form singleton groups (fully isolated).
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self) -> None:
        if self.kind not in (CRASH, JOIN, DRAIN, PARTITION, HEAL):
            raise ValueError(f"unknown churn event kind {self.kind!r}")
        if self.kind == PARTITION:
            if not self.groups or len(self.groups) < 2:
                raise ValueError(f"partition needs >= 2 groups in {self}")
        elif self.groups is not None:
            raise ValueError(f"groups only valid on partition events: {self}")
        if self.kind in (CRASH, JOIN, DRAIN) and self.worker < 0:
            raise ValueError(f"{self.kind} event needs a worker: {self}")


def churn_schedule(
    n_workers: int,
    duration_s: float,
    mtbf_s: float,
    repair_s: float = 20.0,
    seed: int = 0,
    drain_fraction: float = 0.25,
    min_live: int = 1,
    start_after_s: float = 5.0,
) -> List[ChurnEvent]:
    """Seeded Poisson churn: each failure hits a uniformly chosen live
    worker (exponential fleet inter-failure gap ``mtbf_s / n_workers``),
    is a graceful drain with probability ``drain_fraction``, and repairs
    (rejoins) after ``repair_s`` ± 25 % jitter.  At least ``min_live``
    workers stay up at all times (failures that would violate the floor
    are skipped, as a real orchestrator's disruption budget would).
    ``start_after_s`` keeps the bootstrap window quiet so the first
    heartbeats propagate before the first lease can expire.
    """
    if n_workers < 1 or mtbf_s <= 0:
        return []
    rng = random.Random(seed)
    events: List[ChurnEvent] = []
    up = set(range(n_workers))
    rejoin_at = {}  # worker -> scheduled join time
    t = start_after_s
    while True:
        t += rng.expovariate(n_workers / mtbf_s)
        if t >= duration_s:
            break
        # Apply any repairs that completed before this failure.
        for w, rt in sorted(rejoin_at.items()):
            if rt <= t:
                up.add(w)
                del rejoin_at[w]
        if len(up) <= min_live:
            continue  # disruption budget exhausted; skip this failure
        victim = rng.choice(sorted(up))
        kind = DRAIN if rng.random() < drain_fraction else CRASH
        events.append(ChurnEvent(time=t, kind=kind, worker=victim))
        up.discard(victim)
        back = t + repair_s * (0.75 + 0.5 * rng.random())
        if back < duration_s:
            events.append(ChurnEvent(time=back, kind=JOIN, worker=victim))
            rejoin_at[victim] = back
    return sorted(events, key=lambda e: (e.time, e.worker))


def partition_schedule(
    n_workers: int,
    duration_s: float,
    mtbp_s: float,
    outage_s: float = 6.0,
    seed: int = 0,
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None,
    start_after_s: float = 5.0,
) -> List[ChurnEvent]:
    """Seeded partition churn: cuts arrive with exponential gaps of mean
    ``mtbp_s`` and heal after ``outage_s`` ± 25 % jitter; cuts never
    overlap (one partition at a time, matching the engine's model).  Each
    cut uses ``groups`` when given (e.g. the rack split of a topology
    preset) or a seeded random bipartition otherwise.  Every cut is healed
    — if necessary past ``duration_s`` — so stranded work can finish."""
    if n_workers < 2 or mtbp_s <= 0:
        return []
    rng = random.Random(seed)
    events: List[ChurnEvent] = []
    t = start_after_s
    while True:
        t += rng.expovariate(1.0 / mtbp_s)
        if t >= duration_s:
            break
        if groups is not None:
            cut = groups
        else:
            members = list(range(n_workers))
            rng.shuffle(members)
            k = rng.randint(1, n_workers - 1)
            cut = (tuple(sorted(members[:k])), tuple(sorted(members[k:])))
        heal_at = t + outage_s * (0.75 + 0.5 * rng.random())
        events.append(ChurnEvent(time=t, kind=PARTITION, groups=cut))
        events.append(ChurnEvent(time=heal_at, kind=HEAL))
        t = heal_at
    return sorted(events, key=lambda e: (e.time, e.worker))


def validate_schedule(
    events: Sequence[ChurnEvent], n_workers: int, min_live: int = 1
) -> None:
    """Sanity-check a (possibly hand-written) schedule: workers in range,
    no failure of an already-down worker, no join of an up worker, the
    live floor respected, partitions well-formed (disjoint in-range
    groups, no overlapping cuts) and always healed.  Raises
    ``ValueError`` on the first violation."""
    up = set(range(n_workers))
    cut_open = False
    for ev in sorted(events, key=lambda e: (e.time, e.worker)):
        if ev.kind == PARTITION:
            if cut_open:
                raise ValueError(f"overlapping partition in {ev}")
            seen: set = set()
            for group in ev.groups or ():
                for w in group:
                    if not 0 <= w < n_workers:
                        raise ValueError(f"worker {w} out of range in {ev}")
                    if w in seen:
                        raise ValueError(f"worker {w} in two groups in {ev}")
                    seen.add(w)
            cut_open = True
            continue
        if ev.kind == HEAL:
            if not cut_open:
                raise ValueError(f"heal without open partition in {ev}")
            cut_open = False
            continue
        if not 0 <= ev.worker < n_workers:
            raise ValueError(f"worker {ev.worker} out of range in {ev}")
        if ev.kind == JOIN:
            if ev.worker in up:
                raise ValueError(f"join of live worker in {ev}")
            up.add(ev.worker)
        else:
            if ev.worker not in up:
                raise ValueError(f"{ev.kind} of down worker in {ev}")
            up.discard(ev.worker)
            if len(up) < min_live:
                raise ValueError(f"live floor {min_live} violated at {ev}")
    if cut_open:
        raise ValueError("schedule ends with an unhealed partition")
