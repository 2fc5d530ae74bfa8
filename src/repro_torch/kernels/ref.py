"""Plain PyTorch oracles, mirroring ``repro.kernels.ref`` function for
function.  They keep the reference's dtype behaviour (scores cast to fp32,
probabilities cast back to the value dtype), so the CPU tests can hold
the two packages to the reference tolerances.

Shapes follow the serving convention:
  q        : (batch, n_heads, head_dim)
  k, v     : (batch, kv_len, n_kv_heads, head_dim)    (n_heads % n_kv_heads == 0)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast KV heads to query heads: (B,T,KH,D) → (B,T,H,D)."""
    group = n_heads // k.shape[2]
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=2)


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token GQA decode against a KV cache; a row with no valid slot
    gives 0.

    q        : (B, H, D)       — the single new token's queries
    k_cache  : (B, T, KH, D)   — T = cache capacity
    cache_len: (B,) int32      — valid prefix length per sequence
    """
    b, h, d = q.shape
    t = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k_cache, h)
    v = _gqa_expand(v_cache, h)
    logits = torch.einsum("bhd,bkhd->bhk", q, k).float() * scale
    valid = torch.arange(t, device=q.device)[None, :] < cache_len[:, None]
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def decode_attention_grouped_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA decode with the queries grouped per KV head, contracting
    against the unexpanded cache in fp32.  Functionally identical to
    :func:`decode_attention_ref`."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kh, g, d).float() * scale
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    valid = torch.arange(t, device=q.device) < cache_len[:, None, None, None]
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgt,btkd->bkgd", p / l, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def ssd_decode_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step SSD recurrence for decode.

    x: (B,H,P), dt: (B,H), b/c: (B,H,N), state: (B,H,P,N) fp32.
    Returns (y (B,H,P) in x's dtype, new state)."""
    dtf = dt.float()
    decay = torch.exp(a[None, :] * dtf)
    upd = (dtf[..., None, None] * x.float()[..., :, None]) * b.float()[..., None, :]
    new_state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, c.float())
    return y.to(x.dtype), new_state
