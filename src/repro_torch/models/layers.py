"""Shared layer primitives, mirroring ``repro.models.layers``.

Conventions:
* activations (B, S, D) in the full-sequence forward and (B, D) in decode;
  attention heads laid out (B, S, H, hd).
* params are nested ParamTrees (or dicts) of tensors; layer stacks carry a
  leading ``n_layers`` axis.
* norms and softmax statistics in float32, matmuls in the config dtype;
  casts sit where the JAX code has them, so bf16 rounds at the same places.
* with a ``mesh`` (a ``DeviceMesh`` with a ``model`` axis) the layers are
  tensor parallel over ``model`` as their weights are stored
  (:mod:`repro_torch.models.sharding`): attention over this rank's query
  heads and the K/V heads they read, SwiGLU over its block of d_ff, each
  closed by one ``model_sum``; weights stored otherwise go through
  :func:`sharding.linear`.  Norms, RoPE and the residual stay replicated.
  A decode cache split along T over ``model`` (``slot_offset``: this
  rank's first slot) is attended by its slice's partials, combined across
  the ranks (:func:`t_split_decode_attention`).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding


def cache_write(
    cache: torch.Tensor,
    new: torch.Tensor,
    write_index: torch.Tensor,
    mode: str = "scatter",
    slot_offset: Optional[int] = None,
) -> torch.Tensor:
    """Write one token into a (B, T, ...) cache at per-batch slots, in
    place; returns ``cache``.

    ``scatter``: an indexed write at ``[b, write_index[b]]``.
    ``onehot``: a select against an iota mask over the whole cache (the
    reference's partition-friendly form); the same values, more traffic.
    ``slot_offset``: ``cache`` is one rank's slice of a cache split along
    T, from that slot; a row is written only where its slot lies in it.
    """
    if slot_offset is not None:
        write_index = write_index - slot_offset
    if mode == "scatter":
        bidx = torch.arange(cache.shape[0], device=cache.device)
        if slot_offset is None:
            cache[bidx, write_index.long()] = new.to(cache.dtype)
            return cache
        t = cache.shape[1]
        own = ((write_index >= 0) & (write_index < t)).reshape((-1,) + (1,) * (new.dim() - 1))
        slot = write_index.clamp(0, t - 1).long()
        cache[bidx, slot] = torch.where(own, new.to(cache.dtype), cache[bidx, slot])
        return cache
    if mode != "onehot":
        raise ValueError(f"unknown cache_update mode {mode!r}")
    t = cache.shape[1]
    mask = torch.arange(t, device=cache.device)[None, :] == write_index[:, None]
    mask = mask.reshape(mask.shape + (1,) * (cache.ndim - 2))
    cache.copy_(torch.where(mask, new[:, None].to(cache.dtype), cache))
    return cache


# -- norms ---------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


# -- rotary embeddings -------------------------------------------------------------
def rope_inv_freq(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    )


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # x in its own dtype times fp32 cos/sin promotes to fp32, as in JAX,
    # and is cast back once.
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute positions."""
    inv = rope_inv_freq(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., None] * inv  # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin)


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    sections: Sequence[int],
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): three position streams (temporal,
    height, width) drive disjoint frequency sections.

    x: (B, S, H, D); positions: (3, B, S); sum(sections) == D // 2.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim/2 = {d // 2}")
    inv = rope_inv_freq(d, theta, device=x.device)  # (D/2,)
    ang_all = positions.float()[..., None] * inv  # (3,B,S,D/2)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, :, :, start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)  # (B,S,D/2)
    return _rotate(x, torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :])


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """For pure-text spans all three M-RoPE streams share the position."""
    return positions[None].expand((3,) + tuple(positions.shape))


def _rope(x, positions, theta, mrope_sections, mrope_positions):
    """RoPE of x, or M-RoPE where ``mrope_sections`` is given (with
    ``mrope_positions`` (3, B, S), or the text positions of ``positions``)."""
    if mrope_sections is None:
        return apply_rope(x, positions, theta)
    pos3 = mrope_positions if mrope_positions is not None else text_mrope_positions(positions)
    return apply_mrope(x, pos3, theta, mrope_sections)


def _rope_qk(q, k, positions, theta, mrope_sections, mrope_positions):
    """:func:`_rope` of q and of k."""
    return (_rope(q, positions, theta, mrope_sections, mrope_positions),
            _rope(k, positions, theta, mrope_sections, mrope_positions))


# -- feed-forward --------------------------------------------------------------------
def swiglu(x: torch.Tensor, p: Mapping[str, torch.Tensor], mesh=None) -> torch.Tensor:
    """SwiGLU; with a mesh over this rank's block of d_ff (``wg``/``wu``
    column-parallel, ``wd`` row-parallel, one ``model_sum``) where the
    weights are stored so, else through :func:`sharding.linear`."""
    if mesh is None:
        gate = F.silu(x @ p["wg"])
        return (gate * (x @ p["wu"])) @ p["wd"]
    dims = [sharding.model_dim(p, k, mesh) for k in ("wg", "wu", "wd")]
    if dims == [1, 1, 0]:
        xin = sharding.model_enter(x, mesh)
        gate = F.silu(xin @ sharding.model_block(p, "wg", 1, mesh))
        return sharding.model_sum((gate * (xin @ sharding.model_block(p, "wu", 1, mesh)))
                                  @ sharding.model_block(p, "wd", 0, mesh), mesh)
    gate = F.silu(sharding.linear(x, p, "wg", mesh))
    return sharding.linear(gate * sharding.linear(x, p, "wu", mesh), p, "wd", mesh)


# -- attention ------------------------------------------------------------------------
def gqa_attention(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    theta: float,
    causal: bool = True,
    window: Optional[int] = None,
    mrope_sections: Optional[Sequence[int]] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    impl: str = "auto",
    mesh=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence GQA attention (prefill).  x: (B, S, D); positions:
    (B, S) absolute positions; with ``mrope_sections``, M-RoPE over
    ``mrope_positions`` (3, B, S) (default: the text positions).  Returns
    (output (B, S, D), (k, v)), k/v (B, S, KH, hd) after RoPE, so a caller
    can seed a KV cache from them.  With a mesh whose ``model`` splits the
    heads (:func:`sharding.heads_split`) attention runs over this rank's
    query heads and the K/V heads they read (:func:`sharding.kv_heads`),
    and k/v are those heads."""
    b, s, _ = x.shape
    if mesh is not None and sharding.heads_split(p, mesh, n_heads):
        hl = n_heads // sharding.model_rank(mesh)[1]
        lo, hi, per_q = sharding.kv_heads(n_heads, n_kv_heads, mesh)
        xin = sharding.model_enter(x, mesh)
        q = (xin @ sharding.model_block(p, "wq", 1, mesh)).reshape(b, s, hl, head_dim)
        k, v = (xin @ sharding.kv_weight(p, key, mesh, n_heads, n_kv_heads, head_dim)
                for key in ("wk", "wv"))
        k, v = k.reshape(b, s, hi - lo, head_dim), v.reshape(b, s, hi - lo, head_dim)
        q, k = _rope_qk(q, k, positions, theta, mrope_sections, mrope_positions)
        ka, va = (k, v) if per_q is None else (k[:, :, per_q], v[:, :, per_q])
        out = kops.flash_attention(q, ka, va, causal=causal, window=window, impl=impl)
        wo = sharding.model_block(p, "wo", 0, mesh)
        return sharding.model_sum(out.reshape(b, s, hl * head_dim) @ wo, mesh), (k, v)
    q = sharding.linear(x, p, "wq", mesh).reshape(b, s, n_heads, head_dim)
    k = sharding.linear(x, p, "wk", mesh).reshape(b, s, n_kv_heads, head_dim)
    v = sharding.linear(x, p, "wv", mesh).reshape(b, s, n_kv_heads, head_dim)
    q, k = _rope_qk(q, k, positions, theta, mrope_sections, mrope_positions)
    out = kops.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    out = sharding.linear(out.reshape(b, s, n_heads * head_dim), p, "wo", mesh)
    return out, (k, v)


def t_split_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    slot_offset: int,
    mesh,
    impl: str = "auto",
) -> torch.Tensor:
    """Decode attention of q (B, H, D) over a cache split along T over
    ``model``: ``k_cache``/``v_cache`` (B, T_loc, KH, D) are this rank's
    slots from ``slot_offset``, of which clamp(cache_len − offset, 0,
    T_loc) are valid.  This rank's record of (acc, m, l)
    (``decode_attention_partials``, (B, H, D + 4) fp32) is gathered over
    ``model`` in rank order as it is, and every rank combines the records
    alike (``combine_partials``): (B, H, D) in q's dtype, the same bits on
    every rank.  On the card a layer launches one partials kernel, the
    gather and one combine kernel."""
    t_loc = k_cache.shape[1]
    local_len = (cache_len - slot_offset).clamp(0, t_loc).to(torch.int32)
    rec = kops.decode_attention_partials(q, k_cache, v_cache, local_len, impl=impl)
    return kops.combine_partials(sharding.model_gather(rec[None], mesh, 0), q.dtype, impl=impl)


def _attend_cache(x, p, k_cache, v_cache, cache_len, rope_q, *, n_heads, n_kv_heads, head_dim,
                  impl, mesh, slot_offset):
    """One token's queries from x (B, D) (``rope_q`` on (B, 1, heads, hd))
    attended over a cache, and the output projection: (B, D).  With a mesh
    and a cache split along T (``slot_offset``), every head over this
    rank's slots (:func:`t_split_decode_attention`); with a whole cache,
    this rank's query heads where ``model`` splits them."""
    b = x.shape[0]
    if mesh is not None and slot_offset is None and sharding.heads_split(p, mesh, n_heads):
        hl = n_heads // sharding.model_rank(mesh)[1]
        lo, hi, per_q = sharding.kv_heads(n_heads, n_kv_heads, mesh)
        wq, wo = sharding.model_block(p, "wq", 1, mesh), sharding.model_block(p, "wo", 0, mesh)
        q = (sharding.model_enter(x, mesh) @ wq).reshape(b, 1, hl, head_dim)
        kc, vc = k_cache[:, :, lo:hi], v_cache[:, :, lo:hi]
        if per_q is not None:
            kc, vc = kc[:, :, per_q], vc[:, :, per_q]
        out = kops.decode_attention(rope_q(q)[:, 0].contiguous(), kc.contiguous(),
                                    vc.contiguous(), cache_len, impl=impl)
        return sharding.model_sum(out.reshape(b, hl * head_dim) @ wo, mesh)
    q = sharding.linear(x, p, "wq", mesh).reshape(b, 1, n_heads, head_dim)
    q = rope_q(q)[:, 0].contiguous()
    if slot_offset is None:
        out = kops.decode_attention(q, k_cache, v_cache, cache_len, impl=impl)
    else:
        out = t_split_decode_attention(q, k_cache, v_cache, cache_len, slot_offset, mesh, impl)
    return sharding.linear(out.reshape(b, n_heads * head_dim), p, "wo", mesh)


def gqa_decode_attention(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    position: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    write_index: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    theta: float,
    mrope_sections: Optional[Sequence[int]] = None,
    impl: str = "auto",
    cache_update: str = "scatter",
    mesh=None,
    slot_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode.  x: (B, D); position: (B,) absolute positions
    (with ``mrope_sections``, M-RoPE over the text positions); caches
    (B, T, KH, hd), written in place at ``write_index`` (ring-buffer slots
    for sliding windows; == position for full caches).
    Returns (output (B, D), (k_cache, v_cache)).  With a mesh the new
    token's K/V are whole on every rank; ``slot_offset``: the caches are
    this rank's slice of caches split along T over ``model``, from that
    slot (each rank writes the token only where it owns the slot)."""
    b = x.shape[0]
    pos = position[:, None]
    k = sharding.linear(x, p, "wk", mesh).reshape(b, 1, n_kv_heads, head_dim)
    v = sharding.linear(x, p, "wv", mesh).reshape(b, 1, n_kv_heads, head_dim)
    k = _rope(k, pos, theta, mrope_sections, None)
    cache_write(k_cache, k[:, 0], write_index, cache_update, slot_offset)
    cache_write(v_cache, v[:, 0], write_index, cache_update, slot_offset)
    out = _attend_cache(x, p, k_cache, v_cache, cache_len,
                        lambda q: _rope(q, pos, theta, mrope_sections, None), n_heads=n_heads,
                        n_kv_heads=n_kv_heads, head_dim=head_dim, impl=impl, mesh=mesh,
                        slot_offset=slot_offset)
    return out, (k_cache, v_cache)


def cross_decode_attention(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    impl: str = "auto",
    mesh=None,
    slot_offset: Optional[int] = None,
) -> torch.Tensor:
    """One token's cross-attention over the encoder's K/V cache (B, T_enc,
    KH, hd), no RoPE: (B, D).  ``mesh`` and ``slot_offset`` as
    :func:`gqa_decode_attention` takes them."""
    return _attend_cache(x, p, k_cache, v_cache, cache_len, lambda q: q, n_heads=n_heads,
                         n_kv_heads=n_kv_heads, head_dim=head_dim, impl=impl, mesh=mesh,
                         slot_offset=slot_offset)


def cross_attention(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    enc_k: torch.Tensor,
    enc_v: torch.Tensor,
    *,
    n_heads: int,
    head_dim: int,
    impl: str = "auto",
    mesh=None,
) -> torch.Tensor:
    """Encoder-decoder cross attention (Whisper), bidirectional.  x:
    (B, S, D); enc_k/enc_v: the projected encoder states (B, T_enc, KH, hd)
    (with a mesh, :func:`project_cross_kv`'s: this rank's heads where
    ``model`` splits them)."""
    b, s, _ = x.shape
    if mesh is not None and sharding.heads_split(p, mesh, n_heads):
        hl = n_heads // sharding.model_rank(mesh)[1]
        wq, wo = sharding.model_block(p, "wq", 1, mesh), sharding.model_block(p, "wo", 0, mesh)
        q = (sharding.model_enter(x, mesh) @ wq).reshape(b, s, hl, head_dim)
        out = kops.flash_attention(q, enc_k, enc_v, causal=False, impl=impl)
        return sharding.model_sum(out.reshape(b, s, hl * head_dim) @ wo, mesh)
    q = sharding.linear(x, p, "wq", mesh).reshape(b, s, n_heads, head_dim)
    out = kops.flash_attention(q, enc_k, enc_v, causal=False, impl=impl)
    return sharding.linear(out.reshape(b, s, n_heads * head_dim), p, "wo", mesh)


def project_cross_kv(
    enc_out: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    *,
    n_kv_heads: int,
    head_dim: int,
    n_heads: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, T, D) → cross-attention k, v (B, T, KH, hd).
    With a mesh whose ``model`` splits the ``n_heads`` query heads, the
    K/V heads this rank's query heads read (:func:`sharding.kv_heads`,
    expanded to one a query head where they do not group evenly)."""
    b, t, _ = enc_out.shape
    if mesh is not None and sharding.heads_split(p, mesh, n_heads):
        lo, hi, per_q = sharding.kv_heads(n_heads, n_kv_heads, mesh)
        ein = sharding.model_enter(enc_out, mesh)
        k, v = ((ein @ sharding.kv_weight(p, key, mesh, n_heads, n_kv_heads, head_dim))
                .reshape(b, t, hi - lo, head_dim) for key in ("wk", "wv"))
        return (k, v) if per_q is None else (k[:, :, per_q], v[:, :, per_q])
    k = sharding.linear(enc_out, p, "wk", mesh).reshape(b, t, n_kv_heads, head_dim)
    v = sharding.linear(enc_out, p, "wv", mesh).reshape(b, t, n_kv_heads, head_dim)
    return k, v
