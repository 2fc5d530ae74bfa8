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
``decode_attention_partials`` gives one slice's fp32 (m, l, acc): the
split body over the slice, then the combine in a mode that writes them in
place of the output; ``combine_partials`` takes n slices' partials stacked
on a leading dim and gives the output of the whole cache (the same
combine kernel, over n).  They count their calls in ``partials_launches``
and ``combine_launches``, and run their plain versions for CPU tensors.  There is no fallback: a CUDA input that the
kernel does not take, or a named body that cannot take it, raises, and so
does a CUDA call under grad mode with an input that requires grad (decode
is not differentiated).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import refuse_grad
from repro_torch.kernels import ref as _ref

#: Kernel calls since import (or since the caller last reset it).
launches = 0
#: The same calls by body (reset it with ``launches``).
launches_by_body: Dict[str, int] = {}
#: ``decode_attention_partials`` and ``combine_partials`` calls that
#: launched their kernels.
partials_launches = 0
combine_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The C entry's number of each body.
BODIES = {"single": 0, "split": 1}
#: Cache slots per tile of the split body; each split holds whole tiles.
SPLIT_TILE = 64
#: CTAs the split body aims for: about two per SM of an H100 (132 SMs).
TARGET_CTAS = 2 * 132
#: The most query rows per KV head one CTA of the split body takes.
SPLIT_MAX_ROWS = {torch.bfloat16: 128, torch.float32: 64}


def splits_for(b: int, kh: int, t: int) -> int:
    """How many ranges of cache slots the split body cuts a capacity of
    ``t`` slots into, for ``b`` batch rows of ``kh`` KV heads: enough for
    about ``TARGET_CTAS`` CTAs, each range at least one tile, every range
    non-empty.  Reads no ``cache_len``: a range past a row's length does
    no work on the card."""
    tiles = -(-t // SPLIT_TILE)
    if tiles == 0:
        return 1
    want = max(1, min(tiles, -(-TARGET_CTAS // max(1, b * kh))))
    per = -(-tiles // want)  # tiles per range
    return -(-tiles // per)


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


def decode_attention_partials_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slice of a cache, in PyTorch: q (B, H, D), caches (B, T, KH, D),
    ``cache_len`` (B,) its valid slots (clamped to [0, T]) → fp32 m (B, H),
    the largest score q·k/√D over the valid slots; l (B, H), the sum of
    exp(score − m); acc (B, H, D), the sum of exp(score − m)·v, not divided
    by l.  A row with no valid slot gives m = -inf, l = 0, acc = 0."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    if t == 0:
        m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=q.device)
        return m, torch.zeros_like(m), torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    qg = q.reshape(b, kh, g, d).float() * d ** -0.5
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    valid = torch.arange(t, device=q.device) < cache_len[:, None, None, None]
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
    acc = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return m.reshape(b, h), p.sum(dim=-1).reshape(b, h), acc.reshape(b, h, d)


def combine_partials_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """n slices' partials, m and l (n, B, H) and acc (n, B, H, D), in
    PyTorch: every slice rescaled to the largest m and summed, divided by
    the summed l, 0 for a row with no valid slot in any slice (a slice
    with m = -inf weighs 0).  Output (B, H, D) in ``dtype``."""
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
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    return combine_partials_plain(m, l, acc, q.dtype)


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


#: Each C entry point's argument types.
_ARGTYPES = {
    "decode_attention_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "decode_attention_partials_launch": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p],
    "decode_combine_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _entry(name: str = "decode_attention_launch"):
    """A C entry point, built and typed at first use."""
    fn = getattr(_build.load("decode_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


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
    found = bodies_for(q.dtype, d, h // kh, splits_for(b, kh, t))
    if body is None:
        body = found[0]
    elif body not in found:
        raise ValueError(f"the {body!r} body does not take {q.dtype} at head dim {d} with "
                         f"{h // kh} query rows per KV head; bodies that do: {found}")
    out = torch.empty_like(q)
    if out.numel() == 0:  # nothing to compute: no launch
        return out
    splits = splits_for(b, kh, t) if body == "split" else 1
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slice of a cache split along T (q (B, H, D), the slice's caches
    (B, T_loc, KH, D), ``cache_len`` (B,) int32 its valid slots) → fp32
    m, l (B, H) and acc (B, H, D), as
    :func:`decode_attention_partials_plain` defines them.  CUDA tensors
    launch the split body over ``splits_for(B, KH, T_loc)`` ranges and then
    the combine in its partials mode; CPU tensors take the plain version.
    A shape the split body does not take raises."""
    global partials_launches
    if q.device.type == "cpu":
        return decode_attention_partials_plain(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_partials runs on CUDA or CPU, not {q.device}")
    refuse_grad("decode_attention_partials", q, k_cache, v_cache)
    q, k_cache, v_cache = _prepare(q, k_cache, v_cache, cache_len)
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    splits = splits_for(b, kh, t)
    if "split" not in bodies_for(q.dtype, d, h // kh, splits):
        raise ValueError(f"the split body does not take {q.dtype} at head dim {d} with "
                         f"{h // kh} query rows per KV head")
    f32 = dict(dtype=torch.float32, device=q.device)
    m, l, acc = torch.empty((b, h), **f32), torch.empty((b, h), **f32), torch.empty((b, h, d), **f32)
    if m.numel() == 0:
        return m, l, acc
    parts = [torch.empty((b, h, splits) + extra, **f32) for extra in ((), (), (d,))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry("decode_attention_partials_launch")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
            *(p.data_ptr() for p in parts), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            b, h, kh, t, d, _DTYPES[q.dtype], splits, slots_per_split(t, splits), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_partials launch failed: cudaError {rc}")
    partials_launches += 1
    return m, l, acc


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """n slices' partials, m and l (n, B, H) and acc (n, B, H, D) fp32, in
    the order of the slices → the output (B, H, D) in ``dtype``
    (:func:`combine_partials_plain`).  CUDA tensors launch the combine
    kernel over n; CPU tensors take the plain version."""
    global combine_launches
    if m.dim() != 3 or l.shape != m.shape or acc.shape[:3] != m.shape or acc.dim() != 4:
        raise ValueError(f"want m, l (n, B, H) and acc (n, B, H, D); got {tuple(m.shape)}, "
                         f"{tuple(l.shape)}, {tuple(acc.shape)}")
    if m.device.type == "cpu":
        return combine_partials_plain(m, l, acc, dtype)
    if m.device.type != "cuda":
        raise ValueError(f"combine_partials runs on CUDA or CPU, not {m.device}")
    if any(x.dtype != torch.float32 or x.device != m.device for x in (l, acc)) \
            or m.dtype != torch.float32 or dtype not in _DTYPES:
        raise TypeError(f"combine_partials takes fp32 partials on one device and gives fp32 or "
                        f"bf16; got {m.dtype}, {l.dtype}, {acc.dtype} -> {dtype}")
    refuse_grad("combine_partials", m, l, acc)
    n, b, h = m.shape
    d = acc.shape[3]
    m, l, acc = m.contiguous(), l.contiguous(), acc.contiguous()
    out = torch.empty((b, h, d), dtype=dtype, device=m.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = _entry("decode_combine_launch")(m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                                             out.data_ptr(), n, b * h, d, _DTYPES[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"combine_partials launch failed: cudaError {rc}")
    combine_launches += 1
    return out
