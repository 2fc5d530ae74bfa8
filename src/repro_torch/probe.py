"""Readings of the card behind the port's H100 constants
(``core.netmodel.H100_CLUSTER``): the pinned host→device copy rate and the
latency of a small copy, which ``AcceleratorLink`` models, the latency of
a small device→device copy, and ``nvidia-smi``'s power fields.

``chip_smoke.py`` (phase 5b) prints these readings beside the constants,
and ``tests/test_torch_cuda.py`` holds the constants to them.  Both read
the link in a fresh process (``fresh_readings``): at the end of a smoke
run, after the profiler's CUDA tracing had run in the process, an H100's
4 KiB copy took 30.5 µs, against 11-18 µs in fresh processes.

    PYTHONPATH=src python -m repro_torch.probe   # prints the readings as JSON
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.device import Device, resolve_device

#: Bytes of the large copy that gives the link's rate, and of the small
#: copy that gives its latency.
LARGE_COPY = 1 << 30
SMALL_COPY = 4096
#: Small copies timed on each host core in a round, after the warm-up
#: ones, and the rounds, this far apart.
SMALL_REPS, SMALL_WARMUP = 100, 20
SMALL_ROUNDS, SMALL_GAP_S = 10, 0.2


def nvidia_smi(fields: str) -> List[str]:
    """The first card's ``fields`` as ``nvidia-smi --query-gpu`` gives
    them (``--format=csv,noheader,nounits``)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [f.strip() for f in out.stdout.strip().splitlines()[0].split(",")]


def power_limit_w() -> float:
    return float(nvidia_smi("power.limit")[0])


def idle_power_w(samples: int = 5, gap_s: float = 0.2) -> float:
    """Median ``power.draw`` over ``samples`` readings ``gap_s`` apart;
    call it while nothing runs on the card, with the caller's CUDA context
    open, as a worker's card idles (an H100 without any context draws
    about half as much)."""
    reads = []
    for i in range(samples):
        if i:
            time.sleep(gap_s)
        reads.append(float(nvidia_smi("power.draw")[0]))
    return statistics.median(reads)


def _copy_s(dst: torch.Tensor, src: torch.Tensor, reps: int, warmup: int) -> float:
    """Median host-clock seconds of one ``dst.copy_(src)`` that ends in a
    synchronize, after ``warmup`` copies."""
    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _small_copy_s(dst: torch.Tensor, src: torch.Tensor) -> float:
    """The latency of a small copy on a shared host: ``_copy_s`` on each
    host core in turn (the calling thread pinned to it), over
    ``SMALL_ROUNDS`` rounds ``SMALL_GAP_S`` apart, the least of them.  A
    shared host moves between a fast and a slow state every few tens of
    milliseconds (an H100's 4 KiB copy reads about 11 µs in one, 18-20 µs
    in the other, on every core), so one process's median of the same
    copy moves between the two from run to run."""
    cores = sorted(os.sched_getaffinity(0))
    best = []
    try:
        for r in range(SMALL_ROUNDS):
            if r:
                time.sleep(SMALL_GAP_S)
            for core in cores:
                os.sched_setaffinity(0, {core})
                best.append(_copy_s(dst, src, SMALL_REPS, SMALL_WARMUP))
    finally:
        os.sched_setaffinity(0, cores)
    return min(best)


def host_link(device: Device = "cuda", reps: int = 9) -> Dict[str, float]:
    """The pinned host→device copy rate (bytes/s, the median of ``reps``
    1 GiB copies) and the latency of a 4 KiB copy (s, host clock around a
    copy and its synchronize, ``_small_copy_s``), the two terms of
    ``AcceleratorLink``; and the latency of a 4 KiB device→device copy."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the link is read on a card")
    with torch.cuda.device(dev):
        host = torch.empty(LARGE_COPY, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(LARGE_COPY, dtype=torch.uint8, device=dev)
        rate = LARGE_COPY / _copy_s(dst, host, reps, 2)
        del host, dst
        small = torch.zeros(SMALL_COPY, dtype=torch.uint8, pin_memory=True)
        a = torch.empty(SMALL_COPY, dtype=torch.uint8, device=dev)
        b = torch.empty(SMALL_COPY, dtype=torch.uint8, device=dev)
        delta = _small_copy_s(a, small)
        d2d = _small_copy_s(b, a)
    return {"bandwidth_bytes_per_s": rate, "delta_s": delta, "d2d_delta_s": d2d}


def fresh_readings(timeout_s: float = 300.0) -> Dict[str, float]:
    """``host_link`` and ``idle_power_w`` read by a new Python process on
    the first card (with its own context open, after a second's rest)."""
    src = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-m", "repro_torch.probe"], capture_output=True,
                         text=True, timeout=timeout_s, env=env, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    time.sleep(1.0)
    readings = dict(idle_power_w=idle_power_w())
    readings.update(host_link())
    print(json.dumps(readings))


if __name__ == "__main__":
    main()
