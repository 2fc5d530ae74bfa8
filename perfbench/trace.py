"""The profiled part of a traced run, and what is read from it.

A profile is opened with ``BALLAST`` tiny kernels and a synchronise: the
profiler loses the first device records of a session, more of them the
longer the process has run, and only the records after the ballast
count.  A profile that kept none of the ballast's records may have lost
some of the call's, and is taken again with four times the ballast (the
smoke run's ``profiled``, copied).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Sequence, Tuple

BALLAST = 4096
ATTEMPTS = 3
#: Kernel names of decode attention (the split body's two launches, the
#: single body), and of the launches the engine counts one a call.
DECODE_KERNELS = ("decode_attention_kernel", "decode_split", "decode_combine")
DECODE_MAIN = ("decode_attention_kernel", "decode_split")
SPAN = "perfbench."

Record = Tuple[str, int, int]  # name, start ns, duration or end ns


def profiled(fn: Callable[[], None]) -> Tuple[List[Record], List[Record], float, int]:
    """``fn()`` under the profiler: (device records (name, start ns, ns)
    after the ballast, the harness's host spans (name, start ns, end ns),
    the call's wall seconds, ballast records lost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    pad = torch.zeros(1, device="cuda")
    ballast = BALLAST
    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ballast):
                pad.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN + "window"):
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, syncs, spans = [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                kernels.append((e.correlation_id(), e.name(), e.start_ns(), e.duration_ns()))
                continue
            name = e.name()
            if name.startswith("cudaDeviceSynchronize"):
                syncs.append(e.correlation_id())
            elif name.startswith(SPAN):
                spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        start = min(syncs)  # the ballast's synchronise is the session's first
        kept = sum(c < start for c, _, _, _ in kernels)
        if kept:
            break
        ballast *= 4
    else:
        raise RuntimeError(f"no profile kept any of its ballast in {ATTEMPTS} attempts")
    device = [(n, s, d) for c, n, s, d in kernels if c > start]
    return device, spans, wall, max(0, ballast - kept)


def merged(device: Sequence[Record]) -> List[Tuple[int, int]]:
    """The union of the records' intervals, as sorted disjoint (start, end)."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted((s, s + d) for _, s, d in device):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def window_span(spans: Sequence[Record]) -> Tuple[int, int]:
    w = [s for s in spans if s[0] == SPAN + "window"]
    return w[0][1], w[0][2]


def busy_s(device: Sequence[Record], spans: Sequence[Record]) -> float:
    """Seconds in which some record ran on the device, in the window."""
    lo, hi = window_span(spans)
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged(device)) / 1e9


def busy_within(device: Sequence[Record], spans: Sequence[Record], name: str) -> float:
    """Seconds in which some record ran on the device inside the host
    spans called ``name`` (a task's device work ends inside its span,
    which closes on a synchronise)."""
    inside = merged([(name, s, e - s) for n, s, e in spans if n == name])
    busy = merged(device)
    total, i = 0, 0
    for lo, hi in inside:
        while i < len(busy) and busy[i][1] <= lo:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < hi:
            total += max(0, min(busy[j][1], hi) - max(busy[j][0], lo))
            j += 1
    return total / 1e9


def idle_gaps(device: Sequence[Record], spans: Sequence[Record], top: int = 10
              ) -> List[List]:
    """The device's idle time in the window by what the host was doing:
    the innermost harness span over each gap's middle (``client`` where
    none but the window's), the most idle first."""
    lo, hi = window_span(spans)
    inner = sorted((s for s in spans if s[0] != SPAN + "window"), key=lambda s: s[2] - s[1])
    by: Dict[str, float] = collections.defaultdict(float)
    edges = [(lo, lo)] + merged(device) + [(hi, hi)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        mid = (a + b) // 2
        label = next((s[0][len(SPAN):] for s in inner if s[1] <= mid < s[2]), "client")
        by[label] += (b - a) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(device: Sequence[Record], top: int = 10) -> List[List]:
    """Device seconds by record name, the most first."""
    by: Dict[str, float] = collections.defaultdict(float)
    for name, _, d in device:
        by[name] += d / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def decode_attention(device: Sequence[Record]) -> Tuple[float, int]:
    """(device seconds of decode attention's kernels, launches counted as
    the engine counts them)."""
    secs = sum(d for n, _, d in device if any(k in n for k in DECODE_KERNELS)) / 1e9
    calls = sum(any(k in n for k in DECODE_MAIN) for n, _, _ in device)
    return secs, calls
