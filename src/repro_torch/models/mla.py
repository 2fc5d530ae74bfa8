"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), mirroring
``repro.models.mla``.

MLA compresses K/V into a low-rank latent c_kv (kv_lora_rank) plus a small
decoupled RoPE key shared across heads.  The decode cache stores only
(c_kv, k_rope), kv_lora_rank + rope_head_dim values per token, and the
latent is up-projected to per-head K/V at every step.

Shapes (per layer):
  wq_a : (D, q_lora)              wq_b : (q_lora, H*(hd + rd))
  wkv_a: (D, kv_lora + rd)        wkv_b: (kv_lora, H*(hd + hd))
  wo   : (H*hd, D)
where hd = nope head dim, rd = rope_head_dim.  The attention core sees
K of width hd + rd and V padded from hd to hd + rd, so the flash and
decode kernels run at one head dim (192 for DeepSeek-V2).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding
from repro_torch.models.layers import (apply_rope, cache_write, rms_norm,
                                       t_split_decode_attention)


def _split_heads(x: torch.Tensor, n_heads: int, dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, dim)


def _project_q(x, p, *, n_heads, hd, rd, positions, theta, eps, mesh=None,
               local=False) -> torch.Tensor:
    """Queries (B, S, heads, hd + rd).  ``local``: this rank's n_heads /
    |model| heads, ``wq_b`` column-parallel over whole heads (each head's
    nope and rope parts together)."""
    cq = rms_norm(sharding.linear(x, p, "wq_a", mesh), p["q_norm"], eps)
    if local:
        q = sharding.model_enter(cq, mesh) @ sharding.model_block(p, "wq_b", 1, mesh)
        n_heads //= sharding.model_rank(mesh)[1]
    else:
        q = sharding.linear(cq, p, "wq_b", mesh)
    q = _split_heads(q, n_heads, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _latent_kv(x, p, *, rd, positions, theta, eps, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cacheable latent: c_kv (B, S, kv_lora), k_rope (B, S, rd)."""
    kv = sharding.linear(x, p, "wkv_a", mesh)
    kv_lora = kv.shape[-1] - rd
    c_kv, k_rope = kv[..., :kv_lora], kv[..., kv_lora:]
    c_kv = rms_norm(c_kv, p["kv_norm"], eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0]
    return c_kv, k_rope


def _expand_kv(c_kv, k_rope, up, *, n_heads, hd) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up-project the latent into per-head K (nope ‖ rope) and V; ``up``
    is the product with ``wkv_b`` (or the block of it for ``n_heads``)."""
    b, s, _ = c_kv.shape
    kv = _split_heads(up(c_kv), n_heads, 2 * hd)
    k_nope, v = kv[..., :hd], kv[..., hd:]
    k_rope_h = k_rope[:, :, None, :].expand(b, s, n_heads, k_rope.shape[-1])
    return torch.cat([k_nope, k_rope_h], dim=-1), v


def mla_attention(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    positions: torch.Tensor,
    *,
    n_heads: int,
    head_dim: int,
    rope_head_dim: int,
    theta: float,
    norm_eps: float,
    window: Optional[int] = None,
    impl: str = "auto",
    mesh=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence MLA (prefill).  Returns (out (B, S, D), (c_kv, k_rope)),
    so that a caller can seed the latent cache.  With a mesh whose
    ``model`` splits the heads, ``wq_b`` and ``wkv_b`` are
    column-parallel over this rank's whole heads and ``wo`` row-parallel;
    the latent is replicated."""
    b, s, _ = x.shape
    hd, rd = head_dim, rope_head_dim
    local = (mesh is not None and sharding.heads_split(p, mesh, n_heads, q="wq_b")
             and sharding.model_dim(p, "wkv_b", mesh) == 1)
    q = _project_q(x, p, n_heads=n_heads, hd=hd, rd=rd, positions=positions,
                   theta=theta, eps=norm_eps, mesh=mesh, local=local)
    c_kv, k_rope = _latent_kv(x, p, rd=rd, positions=positions, theta=theta, eps=norm_eps,
                              mesh=mesh)
    if local:
        heads = q.shape[2]
        w = sharding.model_block(p, "wkv_b", 1, mesh)
        k, v = _expand_kv(sharding.model_enter(c_kv, mesh), sharding.model_enter(k_rope, mesh),
                          lambda c: c @ w, n_heads=heads, hd=hd)
    else:
        heads = n_heads
        k, v = _expand_kv(c_kv, k_rope, lambda c: sharding.linear(c, p, "wkv_b", mesh),
                          n_heads=heads, hd=hd)
    v_pad = F.pad(v, (0, rd))  # value dim hd < qk dim hd + rd
    out = kops.flash_attention(q, k, v_pad, causal=True, window=window, impl=impl)
    out = out[..., :hd].reshape(b, s, heads * hd)
    if local:
        out = sharding.model_sum(out @ sharding.model_block(p, "wo", 0, mesh), mesh)
    else:
        out = sharding.linear(out, p, "wo", mesh)
    return out, (c_kv, k_rope)


def mla_decode_attention(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    position: torch.Tensor,
    ckv_cache: torch.Tensor,
    krope_cache: torch.Tensor,
    cache_len: torch.Tensor,
    write_index: torch.Tensor,
    *,
    n_heads: int,
    head_dim: int,
    rope_head_dim: int,
    theta: float,
    norm_eps: float,
    impl: str = "auto",
    cache_update: str = "scatter",
    mesh=None,
    slot_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token MLA decode against the latent cache.  x: (B, D); caches
    (B, T, kv_lora) and (B, T, rd), written in place at ``write_index``.
    Returns (out (B, D), (ckv_cache, krope_cache)).  With a mesh the
    queries and the new latent are whole on every rank; ``slot_offset``:
    the caches are this rank's slice of latent caches split along T over
    ``model``, from that slot, and each rank up-projects its own slots for
    every head (``wkv_b`` gathered) and attends by partials
    (:func:`t_split_decode_attention`); ``wo`` then takes its heads' slice
    of the combined output.  As the reference does, the whole latent cache
    is up-projected at every step."""
    b = x.shape[0]
    hd, rd = head_dim, rope_head_dim
    pos = position[:, None]
    q = _project_q(x[:, None, :], p, n_heads=n_heads, hd=hd, rd=rd, positions=pos,
                   theta=theta, eps=norm_eps, mesh=mesh)  # (B, 1, H, hd + rd)
    c_kv, k_rope = _latent_kv(x[:, None, :], p, rd=rd, positions=pos, theta=theta, eps=norm_eps,
                              mesh=mesh)
    cache_write(ckv_cache, c_kv[:, 0], write_index, cache_update, slot_offset)
    cache_write(krope_cache, k_rope[:, 0], write_index, cache_update, slot_offset)
    w = p["wkv_b"]
    k, v = _expand_kv(ckv_cache, krope_cache, lambda c: c @ w, n_heads=n_heads, hd=hd)
    v_pad = F.pad(v, (0, rd))
    if slot_offset is None:
        out = kops.decode_attention(q[:, 0].contiguous(), k, v_pad, cache_len, impl=impl)
    else:
        out = t_split_decode_attention(q[:, 0].contiguous(), k, v_pad, cache_len, slot_offset,
                                       mesh, impl)
    out = sharding.linear(out[..., :hd].reshape(b, n_heads * hd), p, "wo", mesh)
    return out, (ckv_cache, krope_cache)
