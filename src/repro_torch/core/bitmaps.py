"""Cache bitmap encoding (§5.2).

The SST row packs the GPU cache contents into a single 64-bit integer so
that one cache line holds a worker's whole row and RDMA pushes stay
cache-line atomic.  Model ids are 0..63; bit i set ⇔ model i resident.
"""

from __future__ import annotations

from typing import Iterable, List

from repro_torch.core.types import MAX_MODEL_ID

_MASK64 = (1 << 64) - 1


def pack(model_ids: Iterable[int]) -> int:
    bm = 0
    for mid in model_ids:
        if not (0 <= mid <= MAX_MODEL_ID):
            raise ValueError(f"model id {mid} outside 0..{MAX_MODEL_ID}")
        bm |= 1 << mid
    return bm & _MASK64


def unpack(bitmap: int) -> List[int]:
    out = []
    mid = 0
    bm = bitmap & _MASK64
    while bm:
        if bm & 1:
            out.append(mid)
        bm >>= 1
        mid += 1
    return out


def contains(bitmap: int, model_id: int) -> bool:
    return bool((bitmap >> model_id) & 1)


def add(bitmap: int, model_id: int) -> int:
    return (bitmap | (1 << model_id)) & _MASK64


def remove(bitmap: int, model_id: int) -> int:
    return bitmap & ~(1 << model_id) & _MASK64


def popcount(bitmap: int) -> int:
    return bin(bitmap & _MASK64).count("1")
