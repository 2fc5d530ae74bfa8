"""Versioned binary trace files for fleet-scale open-loop replay, copied
from the JAX package so that the port stands alone: a file written by
either package reads back in the other, byte for byte.

``bench_scalability.py`` needs 10–100× longer workloads than the
in-memory generators were built for: a 1M-task trace as a python list of
``Job`` objects regenerated per sweep point is both slow (the generator
re-runs per fleet size) and unshareable (two sweep points must replay
the *same* arrivals for per-event costs to be comparable).  A trace file
fixes both: synthesize once, replay everywhere.

Format ``CTRC`` version 1 (little-endian throughout; see
``schemas/tracefile.md`` for the byte-level layout):

    magic    4 bytes   b"CTRC"
    version  u16       1
    n_dfgs   u32       DFG name-table size
    n_jobs   u64       record count
    names    n_dfgs ×  (u16 length + utf-8 bytes) — index i names dfg i
    records  n_jobs ×  (f64 arrival_time_s + u32 dfg_index), 12 bytes each

The file stores arrivals only; DFG *structures* are resolved by name at
load time against the caller's catalogue, so a trace is valid across
profile changes and the file stays 12 bytes/job — a 1M-job trace is
~12 MB and loads in O(n_jobs) with zero per-record python parsing
(one ``numpy.frombuffer`` over the record block).
"""

from __future__ import annotations

import random
import struct
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import DFG, Job

MAGIC = b"CTRC"
VERSION = 1
_HEADER = struct.Struct("<4sHIQ")   # magic, version, n_dfgs, n_jobs
_NAME_LEN = struct.Struct("<H")
_RECORD_DTYPE = np.dtype([("arrival", "<f8"), ("dfg", "<u4")])


class TraceFormatError(ValueError):
    """Raised for bad magic, unsupported version, or a truncated file."""


def write_trace(
    path: str,
    dfg_names: Sequence[str],
    records: Iterable[Tuple[float, int]],
) -> int:
    """Write ``(arrival_time_s, dfg_index)`` records; returns the count.

    ``records`` may be any iterable (generators stream fine — the job
    count is patched into the header after the body is written, so
    nothing is ever buffered)."""
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, len(dfg_names), 0))
        for name in dfg_names:
            raw = name.encode("utf-8")
            f.write(_NAME_LEN.pack(len(raw)))
            f.write(raw)
        n = 0
        buf = bytearray()
        for arrival, dfg_idx in records:
            if not 0 <= dfg_idx < len(dfg_names):
                raise ValueError(f"dfg index {dfg_idx} out of range")
            buf += struct.pack("<dI", arrival, dfg_idx)
            n += 1
            if len(buf) >= 1 << 20:
                f.write(buf)
                buf.clear()
        f.write(buf)
        f.seek(0)
        f.write(_HEADER.pack(MAGIC, VERSION, len(dfg_names), n))
    return n


def read_header(path: str) -> Tuple[int, List[str], int]:
    """(version, dfg names, n_jobs) without touching the record block."""
    with open(path, "rb") as f:
        raw = f.read(_HEADER.size)
        if len(raw) < _HEADER.size:
            raise TraceFormatError("truncated trace header")
        magic, version, n_dfgs, n_jobs = _HEADER.unpack(raw)
        if magic != MAGIC:
            raise TraceFormatError(f"bad magic {magic!r}")
        if version != VERSION:
            raise TraceFormatError(f"unsupported trace version {version}")
        names = []
        for _ in range(n_dfgs):
            (ln,) = _NAME_LEN.unpack(f.read(_NAME_LEN.size))
            names.append(f.read(ln).decode("utf-8"))
        return version, names, n_jobs


def load_jobs(
    path: str,
    catalogue: Mapping[str, DFG],
    limit: Optional[int] = None,
) -> List[Job]:
    """Materialize the trace as engine-ready jobs (ids are the record
    positions, so truncated replays of the same file share a prefix).
    Every trace DFG name must resolve in ``catalogue``."""
    version, names, n_jobs = read_header(path)
    missing = [nm for nm in names if nm not in catalogue]
    if missing:
        raise TraceFormatError(f"trace needs unknown DFGs {missing}")
    dfgs = [catalogue[nm] for nm in names]
    with open(path, "rb") as f:
        f.seek(_HEADER.size + sum(_NAME_LEN.size + len(nm.encode("utf-8"))
                                  for nm in names))
        body = f.read()
    if limit is not None:
        n_jobs = min(n_jobs, limit)
    if len(body) < n_jobs * _RECORD_DTYPE.itemsize:
        raise TraceFormatError("truncated trace body")
    rec = np.frombuffer(body, dtype=_RECORD_DTYPE, count=n_jobs)
    arrivals = rec["arrival"].tolist()
    dfg_idx = rec["dfg"].tolist()
    return [
        Job(job_id=i, dfg=dfgs[d], arrival_time=t)
        for i, (t, d) in enumerate(zip(arrivals, dfg_idx))
    ]


def trace_task_count(path: str, catalogue: Mapping[str, DFG]) -> int:
    """Total task count of a trace (Σ per-job DFG sizes) — the unit the
    scalability sweeps report per-event costs against."""
    _, names, n_jobs = read_header(path)
    sizes = {i: len(catalogue[nm].tasks) for i, nm in enumerate(names)}
    with open(path, "rb") as f:
        f.seek(_HEADER.size + sum(_NAME_LEN.size + len(nm.encode("utf-8"))
                                  for nm in names))
        rec = np.frombuffer(f.read(), dtype=_RECORD_DTYPE, count=n_jobs)
    counts = np.bincount(rec["dfg"], minlength=len(names))
    return int(sum(sizes[i] * int(c) for i, c in enumerate(counts)))


def synthesize_poisson_trace(
    path: str,
    dfgs: Sequence[DFG],
    rate_per_s: float,
    n_tasks: int,
    seed: int = 0,
    weights: Optional[Sequence[float]] = None,
) -> int:
    """Stream a Poisson open-loop trace to ``path`` until the cumulative
    task count reaches ``n_tasks``; returns the job count.  Mirrors
    ``workload.poisson_workload`` (same rng discipline: ``expovariate``
    inter-arrivals, mixture pick per job) but never holds the workload in
    memory — a 1M-task trace streams through a 1 MiB buffer."""
    if rate_per_s <= 0:
        raise ValueError("rate must be positive")
    rng = random.Random(seed)
    if weights is None:
        weights = [1.0] * len(dfgs)
    total_w = sum(weights)
    cum = []
    acc = 0.0
    for w in weights:
        acc += w / total_w
        cum.append(acc)
    sizes = [len(d.tasks) for d in dfgs]

    def records():
        t = 0.0
        tasks = 0
        while tasks < n_tasks:
            t += rng.expovariate(rate_per_s)
            u = rng.random()
            idx = len(dfgs) - 1
            for i, c in enumerate(cum):
                if u <= c:
                    idx = i
                    break
            tasks += sizes[idx]
            yield t, idx

    return write_trace(path, [d.name for d in dfgs], records())


__all__ = [
    "MAGIC",
    "VERSION",
    "TraceFormatError",
    "load_jobs",
    "read_header",
    "synthesize_poisson_trace",
    "trace_task_count",
    "write_trace",
]
