"""One-token GQA decode attention: the hand-written Hopper kernel
(``csrc/decode_attention.cu``) and its plain PyTorch twin.

The kernel replaces ``repro/kernels/decode_attention.py::decode_attention``.
It is bound by reading the KV cache, 2·B·len·KH·D·itemsize bytes; see the
note at the top of the CUDA source for what its design does about that.

The kernel has two bodies: ``split`` (flash-decoding: the cache cut into
``splits_for`` ranges of slots, one CTA per range and KV head, bf16 on the
tensor cores, then a combine launch when there is more than one range) and
``single`` (one CTA per KV head, or per 32 of its query rows, over the
whole cache, in fp32 on the CUDA cores).  :func:`body_for` picks one from
the dtype, the head dim, the query rows per KV head and the split count;
a caller may name one with ``body=`` to time or test it.

``decode_attention`` launches the kernel for CUDA tensors and counts each
call in the module-level ``launches`` (one per call, whatever the body
launches) and, by body, in ``launches_by_body``; for CPU tensors it runs
``decode_attention_plain``.

Over a cache split along T (one slice a rank of ``model``),
``decode_attention_partials`` gives one slice's partials as one fp32
record per (b, h) row, (B, H, D + 4): acc's D unnormalised values, then m
(the largest score, natural log domain), l and two zero pads
(:func:`unpack_partials` gives views of m, l and acc).  Its bodies
(:func:`partials_bodies_for`): ``cluster`` (bf16, one launch: the split
body's CTAs of a (b, kv head) as one thread-block cluster, merged through
distributed shared memory into the record) and ``split`` (the split body
into scratch, then the combine in a mode that writes the record).
``combine_partials`` takes n slices' records stacked on a leading dim, as
an all-gather leaves them, and gives the output of the whole cache
(bodies ``warp``, one warp a row, and ``block``, the first combine).  They
count their calls in ``partials_launches`` and ``combine_launches`` (and
by body), and run their plain versions for CPU tensors.  There is no
fallback: a CUDA input that the kernel does not take, or a named body that
cannot take it, raises (a refused cluster launch too), and so does a CUDA
call under grad mode with an input that requires grad (decode is not
differentiated).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import sm_count
from repro_torch.kernels._autograd import refuse_grad
from repro_torch.kernels import ref as _ref

#: Kernel calls since import (or since the caller last reset it).
launches = 0
#: The same calls by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}
#: ``decode_attention_partials`` and ``combine_partials`` calls that
#: launched their kernels, and the same calls by body.
partials_launches = 0
combine_launches = 0
partials_by_body: Dict[str, int] = {}
combine_by_body: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"single": 0, "split": 1}
#: Cache slots per tile of the split body; each split holds whole tiles.
SPLIT_TILE = 64
#: CTAs the split body aims for, an SM of the card.
CTAS_PER_SM = 2
#: The most query rows per KV head one CTA of the split body takes.
SPLIT_MAX_ROWS = {torch.bfloat16: 128, torch.float32: 64}
#: The most CTAs one cluster of the cluster body holds (non-portable above 8).
CLUSTER_MAX = 16


def splits_for(b: int, kh: int, t: int, sms: int) -> int:
    """How many ranges of cache slots the split body cuts a capacity of
    ``t`` slots into, for ``b`` batch rows of ``kh`` KV heads on a card of
    ``sms`` SMs: enough for about ``CTAS_PER_SM`` CTAs an SM, each range at
    least one tile, every range non-empty.  Reads no ``cache_len``: a range
    past a row's length does no work on the card."""
    tiles = -(-t // SPLIT_TILE)
    if tiles == 0:
        return 1
    want = max(1, min(tiles, -(-(CTAS_PER_SM * sms) // max(1, b * kh))))
    per = -(-tiles // want)  # tiles per range
    return -(-tiles // per)


def cluster_splits(b: int, kh: int, t: int, sms: int, fits: Dict[int, int]) -> int:
    """The CTAs of one cluster of the cluster body (one cluster per batch
    row and KV head, one range of slots a CTA) for a slice of ``t`` slots:
    a power of two, at most ``CLUSTER_MAX``, the slice's tiles and about
    ``CTAS_PER_SM`` CTAs an SM of ``sms``, and the largest such size of
    which the card holds all B·KH clusters at once (``fits[size]``: the
    clusters of that size it holds, cudaOccupancyMaxActiveClusters); where
    none does, the largest it holds one of (the clusters then take turns).
    Where the slice has more tiles, each CTA takes several
    (:func:`slots_per_split`)."""
    tiles = -(-t // SPLIT_TILE)
    want = max(1, min(tiles, CLUSTER_MAX, -(-(CTAS_PER_SM * sms) // max(1, b * kh))))
    sizes = [1 << i for i in range(want.bit_length() - 1, -1, -1)]  # want's power of two down
    for size in sizes:
        if fits.get(size, 0) >= b * kh:
            return size
    return next((size for size in sizes if fits.get(size, 0) >= 1), 1)


def slots_per_split(t: int, splits: int) -> int:
    """Cache slots in each of ``splits`` ranges over ``t`` slots (whole
    tiles; the last range may hold fewer valid slots)."""
    return max(1, -(-(-(-t // SPLIT_TILE)) // splits)) * SPLIT_TILE


def bodies_for(dtype: torch.dtype, d: int, g: int, splits: int) -> Tuple[str, ...]:
    """The bodies that take head dim ``d`` with ``g`` query rows per KV
    head, where the split body would cut the cache into ``splits`` ranges
    (:func:`splits_for`), the preferred one first.  bf16 prefers ``split``;
    fp32 prefers it only when it cuts the cache into more than one range:
    with one range its fp32 path gives granite's 48 query rows half the
    CTAs ``single`` gives them and takes 40 % longer (PERF.md)."""
    if dtype not in _DTYPES or d > 256 or d % 2 or (d * dtype.itemsize) % 16:
        return ()
    if g > SPLIT_MAX_ROWS[dtype]:
        return ("single",)
    if dtype == torch.float32 and splits == 1:
        return ("single", "split")
    return ("split", "single")


def body_for(dtype: torch.dtype, d: int, g: int, splits: int) -> str:
    """The body a call with these inputs runs when it names none."""
    found = bodies_for(dtype, d, g, splits)
    if not found:
        raise TypeError(f"kernel takes fp32 or bf16 with head dims up to 256 that are whole "
                        f"16-byte vectors; got {dtype} at head dim {d}")
    return found[0]


def partials_bodies_for(dtype: torch.dtype, d: int, g: int) -> Tuple[str, ...]:
    """The bodies of ``decode_attention_partials`` that take head dim ``d``
    with ``g`` query rows per KV head, the preferred one first: the split
    body's shapes (fp32 or bf16, ``d`` up to 256 in whole 16-byte vectors,
    ``g`` up to ``SPLIT_MAX_ROWS``), ``cluster`` first in bf16 and not
    taken in fp32 (``split`` alone)."""
    if "split" not in bodies_for(dtype, d, g, 2):
        return ()
    return ("cluster", "split") if dtype == torch.bfloat16 else ("split",)


def combine_bodies_for(d: int) -> Tuple[str, ...]:
    """The bodies of ``combine_partials`` that take records of head dim
    ``d``, the preferred one first: ``warp`` where D is whole float4s up to
    256, then ``block``."""
    return ("warp", "block") if d % 4 == 0 and 0 < d <= 256 else ("block",)


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
) -> torch.Tensor:
    """What the kernel computes, in PyTorch: queries grouped per KV head,
    fp32 scores, softmax and weighted sum over the valid prefix
    ``cache_len`` (clamped to [0, T]), 0 for a row with no valid slot,
    output in q's dtype.  That is the grouped oracle's arithmetic."""
    return _ref.decode_attention_grouped_ref(q, k_cache, v_cache, cache_len)


#: Floats of a partials record past acc's D: m, l and two zero pads.
RECORD_EXTRA = 4


def pack_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """m and l (..., ) and acc (..., D) as fp32 records (..., D + 4): acc,
    m, l, then two zeros."""
    pad = torch.zeros(m.shape + (2,), dtype=torch.float32, device=m.device)
    return torch.cat([acc.float(), m.float()[..., None], l.float()[..., None], pad], dim=-1)


def unpack_partials(rec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views of a record's (or stacked records') m, l and acc."""
    d = rec.shape[-1] - RECORD_EXTRA
    return rec[..., d], rec[..., d + 1], rec[..., :d]


def decode_attention_partials_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
) -> torch.Tensor:
    """One slice of a cache, in PyTorch: q (B, H, D), caches (B, T, KH, D),
    ``cache_len`` (B,) its valid slots (clamped to [0, T]) → the fp32
    record (B, H, D + 4) of m, the largest score q·k/√D over the valid
    slots; l, the sum of exp(score − m); and acc (D), the sum of
    exp(score − m)·v, not divided by l (:func:`pack_partials`).  A row with
    no valid slot gives m = -inf, l = 0, acc = 0."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    if t == 0:
        m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=q.device)
        return pack_partials(m, torch.zeros_like(m),
                             torch.zeros((b, h, d), dtype=torch.float32, device=q.device))
    qg = q.reshape(b, kh, g, d).float() * d ** -0.5
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    valid = torch.arange(t, device=q.device) < cache_len[:, None, None, None]
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
    acc = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return pack_partials(m.reshape(b, h), p.sum(dim=-1).reshape(b, h), acc.reshape(b, h, d))


def merge_partials_plain(recs: torch.Tensor) -> torch.Tensor:
    """The cluster body's merge, in PyTorch: the records of a slice's
    ranges (s, B, H, D + 4), in range order, into the slice's record, as
    the kernel merges them: every range rescaled to the largest m (in the
    exp2 domain) and l and acc summed range by range in order.  A row no
    range saw gives m = -inf, l = 0, acc = 0."""
    log2e = 1.4426950408889634
    m, l, acc = unpack_partials(recs)
    top = (m * log2e).amax(dim=0)
    seen = ~torch.isinf(top)
    w = torch.where(seen, torch.exp2(m * log2e - torch.where(seen, top, torch.zeros_like(top))),
                    torch.zeros_like(m))
    tot_l, tot_acc = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    for s in range(recs.shape[0]):
        tot_l = tot_l + l[s] * w[s]
        tot_acc = tot_acc + acc[s] * w[s][..., None]
    return pack_partials(top / log2e, tot_l, tot_acc)


def decode_attention_cluster_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    splits: int,
) -> torch.Tensor:
    """What the cluster body computes, in PyTorch: the partials of each of
    ``splits`` ranges of ``slots_per_split`` slots of the slice
    (:func:`decode_attention_partials_plain`), merged in range order
    (:func:`merge_partials_plain`) into the slice's record."""
    t = k_cache.shape[1]
    per = slots_per_split(t, splits)
    parts = []
    for s in range(splits):
        lo, hi = min(s * per, t), min((s + 1) * per, t)
        parts.append(decode_attention_partials_plain(
            q, k_cache[:, lo:hi], v_cache[:, lo:hi], (cache_len - lo).clamp(0, hi - lo)))
    return merge_partials_plain(torch.stack(parts))


def combine_partials_plain(rec: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """n slices' records (n, B, H, D + 4), in PyTorch: every slice rescaled
    to the largest m and summed, divided by the summed l, 0 for a row with
    no valid slot in any slice (a slice with m = -inf weighs 0).  Output
    (B, H, D) in ``dtype``."""
    m, l, acc = unpack_partials(rec)
    top = m.amax(dim=0)
    w = torch.exp(m - torch.where(torch.isinf(top), torch.zeros_like(top), top))  # 0 for -inf
    total = (l * w).sum(dim=0)
    out = (acc * w[..., None]).sum(dim=0)
    out = torch.where(total[..., None] > 0, out / total.clamp_min(1e-30)[..., None],
                      torch.zeros_like(out))
    return out.to(dtype)


def decode_attention_split_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    splits: int,
) -> torch.Tensor:
    """What the split body computes, in PyTorch: the partials of each of
    ``splits`` ranges of ``slots_per_split`` cache slots
    (:func:`decode_attention_partials_plain`), then their combine
    (:func:`combine_partials_plain`).  Output in q's dtype."""
    t = k_cache.shape[1]
    per = slots_per_split(t, splits)
    parts = []
    for s in range(splits):
        lo, hi = min(s * per, t), min((s + 1) * per, t)
        parts.append(decode_attention_partials_plain(
            q, k_cache[:, lo:hi], v_cache[:, lo:hi], (cache_len - lo).clamp(0, hi - lo)))
    return combine_partials_plain(torch.stack(parts), q.dtype)


def _check(q, k_cache, v_cache, cache_len) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q (B,H,D) and caches (B,T,KH,D); got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    b, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % k_cache.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}"
        )
    if cache_len.shape != (b,) or cache_len.dtype != torch.int32:
        raise ValueError("cache_len must be a (B,) int32 tensor")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"kernel takes fp32 or bf16 q/k/v of one dtype; got {q.dtype}, "
            f"{k_cache.dtype}, {v_cache.dtype}"
        )
    if d > 256 or d % 2 or (d * q.element_size()) % 16:
        raise ValueError(
            f"kernel takes head dims up to 256 that are whole 16-byte vectors; got {d}"
        )
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_len", cache_len)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _prepare(q, k_cache, v_cache, cache_len):
    """(q, k_cache, v_cache) checked, each on a 16-byte boundary: an input
    off one is copied (:func:`_build.aligned`), on any device."""
    _check(q, k_cache, v_cache, cache_len)
    return tuple(_build.aligned(x) for x in (q, k_cache, v_cache))


_COMBINE_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int]
                 + [ctypes.c_void_p])
#: Each C entry point's argument types, and its library (``csrc/<name>.cu``):
#: the whole kernel, the split body's partials and the block combine in
#: decode_attention, the cluster body and the warp combine in decode_partials.
_ARGTYPES = {
    "decode_attention_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "decode_attention_partials_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p],
    "decode_combine_launch": _COMBINE_ARGS,
    "decode_partials_cluster_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                      + [ctypes.c_void_p],
    "decode_cluster_fits": [ctypes.c_int] * 3,
    "decode_combine_warp_launch": _COMBINE_ARGS,
}
_LIBRARY = {"decode_partials_cluster_launch": "decode_partials",
            "decode_cluster_fits": "decode_partials",
            "decode_combine_warp_launch": "decode_partials"}


def _entry(name: str = "decode_attention_launch"):
    """A C entry point, built and typed at first use."""
    fn = getattr(_build.load(_LIBRARY.get(name, "decode_attention")), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


_cluster_fits: Dict[Tuple[int, int, int], Dict[int, int]] = {}


def cluster_fits(device: torch.device, g: int, d: int) -> Dict[int, int]:
    """Cluster size (1, 2, 4, 8, 16) → how many clusters of the cluster
    body of that size ``device`` holds at once at ``g`` query rows per KV
    head and head dim ``d`` (cudaOccupancyMaxActiveClusters, read once)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, g, d)
    if key not in _cluster_fits:
        with torch.cuda.device(index):
            fn = _entry("decode_cluster_fits")
            _cluster_fits[key] = {1 << i: fn(g, d, 1 << i)
                                  for i in range(CLUSTER_MAX.bit_length())}
    return _cluster_fits[key]


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    body: Optional[str] = None,
) -> torch.Tensor:
    """q: (B, H, D); k_cache/v_cache: (B, T, KH, D); cache_len: (B,) int32
    → (B, H, D) in q's dtype.  CUDA tensors launch the kernel on the
    current stream, through ``body`` (one of ``BODIES``) or, when it is
    None, the body :func:`body_for` picks; CPU tensors take
    :func:`decode_attention_plain`.  Every body loads 16 bytes a thread: an
    input off a 16-byte boundary is copied before the launch (a copy, not
    another body)."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU, not {q.device}")
    refuse_grad("decode_attention", q, k_cache, v_cache)
    q, k_cache, v_cache = _prepare(q, k_cache, v_cache, cache_len)
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    splits = splits_for(b, kh, t, sm_count(q.device))
    found = bodies_for(q.dtype, d, h // kh, splits)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {q.dtype} at head dim {d} with "
                         f"{h // kh} query rows per KV head; bodies that do: {found}")
    out = torch.empty_like(q)
    if out.numel() == 0:  # nothing to compute: no launch
        return out
    if body != "split":
        splits = 1
    parts = [None] * 3  # the split body's m, l and acc, with more than one split
    if splits > 1:
        parts = [torch.empty((b, h, splits) + extra, dtype=torch.float32, device=q.device)
                 for extra in ((), (), (d,))]
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
                out.data_ptr(), *(p.data_ptr() if p is not None else None for p in parts),
                b, h, kh, t, d, _DTYPES[q.dtype], BODIES[body], splits,
                slots_per_split(t, splits), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel ({body}) launch failed: cudaError {rc}")
    launches += 1
    launches_by_body[body] = launches_by_body.get(body, 0) + 1
    return out


def decode_attention_partials(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    body: Optional[str] = None,
) -> torch.Tensor:
    """One slice of a cache split along T (q (B, H, D), the slice's caches
    (B, T_loc, KH, D), ``cache_len`` (B,) int32 its valid slots) → its fp32
    record (B, H, D + 4), as :func:`decode_attention_partials_plain`
    defines it.  CUDA tensors launch ``body`` or, when it is None, the
    first of :func:`partials_bodies_for`: ``cluster`` (one launch of
    :func:`cluster_splits` CTAs a cluster) or ``split`` (the split body over
    ``splits_for(B, KH, T_loc, sms)`` ranges, then the combine in its
    partials mode); CPU tensors take the plain version.  A shape the body
    does not take raises."""
    global partials_launches
    if q.device.type == "cpu":
        return decode_attention_partials_plain(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_partials runs on CUDA or CPU, not {q.device}")
    refuse_grad("decode_attention_partials", q, k_cache, v_cache)
    q, k_cache, v_cache = _prepare(q, k_cache, v_cache, cache_len)
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    found = partials_bodies_for(q.dtype, d, g)
    if body is None and found:
        body = found[0]
    if body not in found:
        raise ValueError(f"the {body or 'split'} body does not take {q.dtype} at head dim {d} "
                         f"with {g} query rows per KV head; bodies that do: {found}")
    f32 = dict(dtype=torch.float32, device=q.device)
    rec = torch.empty((b, h, d + RECORD_EXTRA), **f32)
    if rec.numel() == 0:
        return rec
    sms = sm_count(q.device)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if body == "cluster":
            fits = cluster_fits(q.device, g, d)
            splits = cluster_splits(b, kh, t, sms, fits)
            if fits.get(splits, 0) == 0:
                raise RuntimeError(f"the card holds no cluster of the cluster body at {g} query "
                                   f"rows per KV head and head dim {d}")
            rc = _entry("decode_partials_cluster_launch")(
                *ptrs, rec.data_ptr(), b, h, kh, t, d, splits, slots_per_split(t, splits),
                stream)
        else:
            splits = splits_for(b, kh, t, sms)
            parts = [torch.empty((b, h, splits) + extra, **f32) for extra in ((), (), (d,))]
            rc = _entry("decode_attention_partials_launch")(
                *ptrs, *(p.data_ptr() for p in parts), rec.data_ptr(), b, h, kh, t, d,
                _DTYPES[q.dtype], splits, slots_per_split(t, splits), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_partials ({body}) launch failed: cudaError {rc}")
    partials_launches += 1
    partials_by_body[body] = partials_by_body.get(body, 0) + 1
    return rec


def combine_partials(rec: torch.Tensor, dtype: torch.dtype, *,
                     body: Optional[str] = None) -> torch.Tensor:
    """n slices' fp32 records (n, B, H, D + 4), in the order of the slices,
    as an all-gather lays them out → the output (B, H, D) in ``dtype``
    (:func:`combine_partials_plain`).  CUDA tensors launch the combine
    kernel over n through ``body`` or the first of
    :func:`combine_bodies_for`, reading the slices where they lie (any
    stride between slices that keeps 16-byte vectors; a slice that is not
    contiguous is copied); CPU tensors take the plain version."""
    global combine_launches
    if rec.dim() != 4 or rec.shape[0] < 1 or rec.shape[-1] <= RECORD_EXTRA:
        raise ValueError(f"want records (n, B, H, D + {RECORD_EXTRA}); got {tuple(rec.shape)}")
    if rec.device.type == "cpu":
        return combine_partials_plain(rec, dtype)
    if rec.device.type != "cuda":
        raise ValueError(f"combine_partials runs on CUDA or CPU, not {rec.device}")
    if rec.dtype != torch.float32 or dtype not in _DTYPES:
        raise TypeError(f"combine_partials takes fp32 records and gives fp32 or bf16; got "
                        f"{rec.dtype} -> {dtype}")
    refuse_grad("combine_partials", rec)
    n, b, h, width = rec.shape
    d = width - RECORD_EXTRA
    found = combine_bodies_for(d)
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} combine does not take head dim {d}; bodies that do: "
                         f"{found}")
    if not rec[0].is_contiguous() or rec.data_ptr() % 16 or (rec.stride(0) * 4) % 16:
        rec = rec.clone(memory_format=torch.contiguous_format)  # a fresh, aligned copy
    out = torch.empty((b, h, d), dtype=dtype, device=rec.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(rec.device):
        stream = torch.cuda.current_stream(rec.device).cuda_stream
        name = "decode_combine_warp_launch" if body == "warp" else "decode_combine_launch"
        rc = _entry(name)(rec.data_ptr(), out.data_ptr(), n, b * h, d, rec.stride(0),
                          _DTYPES[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"combine_partials ({body}) launch failed: cudaError {rc}")
    combine_launches += 1
    combine_by_body[body] = combine_by_body.get(body, 0) + 1
    return out
