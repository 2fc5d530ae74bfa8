"""The program's own ranges in a traced run's profile, and what is read
from them and from the engine's task times.

With ``ServingCluster(..., spans=True)`` the served path opens profiler
ranges named ``compass.*`` (``repro_torch.serving.engine``): ``run_task``
around each pipeline task's work in the engine, and inside it the
``capture`` of a new graph, ``zero_cache``, one ``replay`` a decode step
and ``to_host``.  The profiler
gives them and the CUDA runtime's launch calls in the host's time, and
CUPTI gives each of the card's records the correlation id of the call that
launched it (every kernel of a graph replay that of its
``cudaGraphLaunch``).  So a device record belongs to the innermost program
range around its launch call, and an idle gap of the card to the range of
the call that ended it: ``host_late`` the part before that call began (the
card waited for the host), ``queued`` the rest (the work was already on
its way).  The card's records come on a clock that drifts against the
host's by up to milliseconds over a deck, more than the gaps, so the split
is made on the card's clock as ``offsets`` pins it.

``read`` takes the profile's events as ``trace.profiled`` takes them (the
records after the ballast's synchronise) and keeps the harness's records
and ranges as they are, so every reading of ``trace`` is unchanged.  On a
card the engine also keeps one ``TaskTime`` a task over the whole window
(a CUDA event before its first replay and after its last): ``step_device_ms``
and ``slow_step_share`` read those.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from perfbench import trace

PROGRAM = "compass."
#: Host calls that can launch device work: ``cuda*`` and ``cu*`` API calls.
LAUNCH_PREFIX = "cu"
#: A task whose device time a replay lies more than this above its key's
#: reference is slow.
SLOW = 1.02

DeviceRecord = Tuple[int, str, int, int]  # correlation id, name, start ns, ns
HostCall = Tuple[str, int, int]  # name, start ns, end ns


@dataclasses.dataclass
class ProgramTrace:
    """What a profile holds besides the harness's records and ranges."""

    #: The card's records after the ballast, with their correlation ids.
    records: List[DeviceRecord]
    #: The host call that launched each record, by its correlation id.
    launches: Dict[int, HostCall]
    #: The program's ranges (name, start ns, end ns), ``compass.`` kept.
    spans: List[HostCall]
    #: The harness's window (start ns, end ns).
    window: Tuple[int, int]
    #: Every event of the profile: the profiler's record count.
    events: int
    #: ``cudaEventRecord`` calls in the window.
    event_records: int
    #: Device-side copies of host ranges (the profiler's annotations), left
    #: out of ``records``.
    annotations: int = 0
    #: The ``cudaDeviceSynchronize`` calls after the ballast's (start, end).
    syncs: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


def read(events) -> ProgramTrace:
    """The program's part of a profile's ``kineto_results.events()``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    records, calls, spans, syncs = [], {}, [], []
    window = None
    event_calls: List[int] = []
    n = annotations = 0
    for e in events:
        n += 1
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith((PROGRAM, trace.SPAN)):
                annotations += 1
            else:
                records.append((e.correlation_id(), name, e.start_ns(), e.duration_ns()))
            continue
        if name.startswith(PROGRAM):
            spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name == trace.SPAN + "window":
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith(LAUNCH_PREFIX):
            if name.startswith("cudaDeviceSynchronize"):
                syncs.append((e.correlation_id(), e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith("cudaEventRecord"):
                event_calls.append(e.start_ns())
            calls[e.correlation_id()] = (name, e.start_ns(), e.start_ns() + e.duration_ns())
    if window is None or not syncs:
        raise ValueError("the profile holds no harness window or no ballast synchronise")
    start = min(syncs)[0]  # the ballast's synchronise is the profile's first
    records = [r for r in records if r[0] > start]
    launches = {r[0]: calls[r[0]] for r in records if r[0] in calls}
    lo, hi = window
    return ProgramTrace(records, launches, spans, window, n,
                        sum(lo <= t < hi for t in event_calls), annotations,
                        sorted((a, b) for c, a, b in syncs if c > start))


# -- attribution ---------------------------------------------------------------------------------
def innermost(spans: Sequence[HostCall], times: Sequence[int]) -> List[Optional[int]]:
    """For each of ``times``, the index in ``spans`` of the innermost range
    holding it (ranges nest: they are opened on one thread), or None."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(order) and spans[order[j]][1] <= t:
            while stack and spans[stack[-1]][2] <= spans[order[j]][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][2] <= t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


@dataclasses.dataclass
class Attributed:
    """Each record's launch start (None where the profile lost its call)
    and the index of the program range around that call (None where none)."""

    pt: ProgramTrace
    launch: List[Optional[int]]
    span: List[Optional[int]]
    #: ``merged_first`` of the records, and its starts.
    merged: List[Tuple[int, int, int]]
    starts: List[int]
    #: (host ns, the card's clock less the host's there, ns): ``offsets``.
    anchors: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    def on_device(self, t: int) -> float:
        """Host time ``t`` on the clock of the card's records: the offset
        interpolated between the anchors, held flat beyond them."""
        if not self.anchors:
            return float(t)
        k = bisect.bisect_left(self.anchors, (t, float("-inf")))
        if k == 0:
            return t + self.anchors[0][1]
        if k == len(self.anchors):
            return t + self.anchors[-1][1]
        (t0, e0), (t1, e1) = self.anchors[k - 1], self.anchors[k]
        return t + e0 + (e1 - e0) * (t - t0) / (t1 - t0)

    def busy(self, lo: int, hi: int) -> int:
        """Nanoseconds in [lo, hi) in which some record ran."""
        i = max(0, bisect.bisect_right(self.starts, lo) - 1)
        total = 0
        while i < len(self.merged) and self.merged[i][0] < hi:
            total += max(0, min(self.merged[i][1], hi) - max(self.merged[i][0], lo))
            i += 1
        return total

    def label(self, i: Optional[int]) -> str:
        return "none" if i is None else self.pt.spans[i][0][len(PROGRAM):]


def attribute(pt: ProgramTrace) -> Attributed:
    launch = [pt.launches[c][1] if c in pt.launches else None for c, _, _, _ in pt.records]
    known = [i for i, t in enumerate(launch) if t is not None]
    inner = innermost(pt.spans, [launch[i] for i in known])
    span: List[Optional[int]] = [None] * len(pt.records)
    for i, s in zip(known, inner):
        span[i] = s
    merged = merged_first(pt.records)
    return Attributed(pt, launch, span, merged, [m[0] for m in merged], offsets(pt, launch))


def offsets(pt: ProgramTrace, launch: Sequence[Optional[int]]) -> List[Tuple[int, int]]:
    """Where the profile pins the card's clock against the host's, which
    drift apart (by up to ~2 ms a second, and back at a jump): among the
    records launched between two synchronises, the one that started
    soonest after its launch call began, as (that call's start, host ns;
    the record's start less it, ns).  No record starts before its call, and
    the first launch after a synchronise finds the card idle, so that is
    the card's clock less the host's there, plus the least launch latency."""
    starts = [a for a, _ in pt.syncs]
    best: Dict[int, Tuple[int, int]] = {}
    for (_, _, s, _), t in zip(pt.records, launch):
        if t is None:
            continue
        k = bisect.bisect_right(starts, t)
        if k not in best or s - t < best[k][1]:
            best[k] = (t, s - t)
    return [best[k] for k in sorted(best)]


def merged_first(records: Sequence[DeviceRecord]) -> List[Tuple[int, int, int]]:
    """The union of the records' intervals as sorted disjoint (start, end,
    index of the record that starts it)."""
    out: List[List[int]] = []
    for i in sorted(range(len(records)), key=lambda i: (records[i][2], records[i][0])):
        s, e = records[i][2], records[i][2] + records[i][3]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, i])
    return [tuple(x) for x in out]


# -- the readings of a profile ---------------------------------------------------------------
def idle_by_cause(at: Attributed, top: Optional[int] = 10) -> List[List]:
    """The card's idle seconds in the window by the program range around
    the launch call of the record that ended each gap: ``<range>/host_late``
    before that call began, ``<range>/queued`` after; ``client`` where no
    record ends the gap, ``unattributed/queued`` where the profile lost the
    call; the most first."""
    by = _idle_parts(at)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _idle_parts(at: Attributed) -> Dict[str, float]:
    lo, hi = at.pt.window
    by: Dict[str, float] = collections.defaultdict(float)
    edges = [(lo, lo, None)] + at.merged + [(hi, hi, None)]
    for (_, a, _), (b, _, i) in zip(edges, edges[1:]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if i is None or b == hi:
            by["client"] += b - a
        elif at.launch[i] is None:
            by["unattributed/queued"] += b - a
        else:  # no record starts before its launch call, on any clock
            late = max(0, min(at.on_device(at.launch[i]), b) - a)
            name = at.label(at.span[i])
            if late:
                by[f"{name}/host_late"] += late
            if b - a - late:
                by[f"{name}/queued"] += b - a - late
    return by


def host_late_share(at: Attributed) -> Optional[float]:
    """% of the window in which the card idled before the host had begun
    the launch call of the record that ended the gap (on the card's clock,
    ``Attributed.on_device``)."""
    lo, hi = at.pt.window
    if hi <= lo or not at.pt.records:
        return None
    late = sum(v for k, v in _idle_parts(at).items() if k.endswith("/host_late"))
    return 100.0 * late / (hi - lo)


def replays(at: Attributed) -> Dict[int, List[int]]:
    """The records of each ``compass.replay`` range, by the range's index."""
    out: Dict[int, List[int]] = collections.defaultdict(list)
    for i, s in enumerate(at.span):
        if s is not None and at.pt.spans[s][0] == PROGRAM + "replay":
            out[s].append(i)
    return out


def replay_gap_us(at: Attributed) -> Optional[float]:
    """The median idle of the card from the last record of one replay to
    the first of the next in the same ``compass.run_task``."""
    spans, recs = at.pt.spans, at.pt.records
    by_replay = replays(at)
    tasks = sorted((s[1], s[2]) for s in spans if s[0] == PROGRAM + "run_task")
    starts = [t[0] for t in tasks]
    runs: Dict[int, List[int]] = collections.defaultdict(list)
    for k, s in enumerate(spans):
        if s[0] == PROGRAM + "replay":
            j = bisect.bisect_right(starts, s[1]) - 1
            if j >= 0 and s[2] <= tasks[j][1]:
                runs[j].append(k)
    gaps = []
    for ks in runs.values():
        ks.sort(key=lambda k: spans[k][1])
        for a, b in zip(ks, ks[1:]):
            if by_replay.get(a) and by_replay.get(b):
                end = max(recs[i][2] + recs[i][3] for i in by_replay[a])
                first = min(recs[i][2] for i in by_replay[b])
                gaps.append(first - end - at.busy(end, first) if first > end else 0)
    return statistics.median(gaps) / 1e3 if gaps else None


def in_replay_idle_share(at: Attributed) -> Optional[float]:
    """% of the replays' device extents (each replay's first record's start
    to its last record's end) in which nothing ran on the card."""
    recs = at.pt.records
    extent = idle = 0
    for idx in replays(at).values():
        lo = min(recs[i][2] for i in idx)
        hi = max(recs[i][2] + recs[i][3] for i in idx)
        extent += hi - lo
        idle += hi - lo - at.busy(lo, hi)
    return 100.0 * idle / extent if extent else None


def coverage(at: Attributed) -> Dict[str, float]:
    """The check of the attribution: of the device seconds of records that
    start inside a ``compass.run_task`` range, the share launched from
    inside a program range; how many such launch calls began after their
    record on the profile's clocks, how many on the card's clock as the
    anchors align it, and the latest by how much (ns)."""
    tasks = sorted((s[1], s[2]) for s in at.pt.spans if s[0] == PROGRAM + "run_task")
    starts = [t[0] for t in tasks]
    inside = covered = late = late_aligned = 0
    worst = float("-inf")
    for i, (_, _, s, d) in enumerate(at.pt.records):
        j = bisect.bisect_right(starts, s) - 1
        if j < 0 or s >= tasks[j][1]:
            continue
        inside += d
        if at.span[i] is not None:
            covered += d
            late += at.launch[i] > s
            ahead = at.on_device(at.launch[i]) - s
            late_aligned += ahead > 0
            worst = max(worst, ahead)
    return {"run_task_device_s": inside / 1e9,
            "attributed_share": 100.0 * covered / inside if inside else 0.0,
            "launches_after_their_record": late,
            "after_alignment": late_aligned, "latest_after_alignment_ns": worst}


# -- the engine's task times over the window ---------------------------------------------------
def step_device_ms(times: Sequence) -> Optional[float]:
    """The tasks' device seconds summed over their replays, in ms."""
    n = sum(t.replays for t in times)
    return 1e3 * sum(t.device_s for t in times) / n if n else None


def references(times: Sequence) -> Dict:
    """Each graph key's reference device time a replay: the slowest of its
    fastest tenth of tasks (the fastest where it has under ten)."""
    by: Dict = collections.defaultdict(list)
    for t in times:
        by[t.key].append(t.device_s / t.replays)
    return {k: sorted(v)[math.ceil(len(v) / 10) - 1] for k, v in by.items()}


def slow(times: Sequence) -> List[bool]:
    """Whether each task's device time a replay lies more than 2 % above
    its key's reference."""
    ref = references(times)
    return [t.device_s / t.replays > SLOW * ref[t.key] for t in times]


def slow_step_share(times: Sequence) -> Optional[float]:
    """% of the tasks' device seconds in slow tasks."""
    total = sum(t.device_s for t in times)
    if not total:
        return None
    return 100.0 * sum(t.device_s for t, s in zip(times, slow(times)) if s) / total
