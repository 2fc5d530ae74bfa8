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
from repro_torch.models.layers import apply_rope, cache_write, rms_norm


def _split_heads(x: torch.Tensor, n_heads: int, dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, dim)


def _project_q(x, p, *, n_heads, hd, rd, positions, theta, eps) -> torch.Tensor:
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], eps)
    q = _split_heads(cq @ p["wq_b"], n_heads, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _latent_kv(x, p, *, positions, theta, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cacheable latent: c_kv (B, S, kv_lora), k_rope (B, S, rd)."""
    kv = x @ p["wkv_a"]
    kv_lora = p["wkv_b"].shape[0]
    c_kv, k_rope = kv[..., :kv_lora], kv[..., kv_lora:]
    c_kv = rms_norm(c_kv, p["kv_norm"], eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0]
    return c_kv, k_rope


def _expand_kv(c_kv, k_rope, p, *, n_heads, hd) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up-project the latent into per-head K (nope ‖ rope) and V."""
    b, s, _ = c_kv.shape
    kv = _split_heads(c_kv @ p["wkv_b"], n_heads, 2 * hd)
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
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence MLA (prefill).  Returns (out (B, S, D), (c_kv, k_rope)),
    so that a caller can seed the latent cache."""
    b, s, _ = x.shape
    hd, rd = head_dim, rope_head_dim
    q = _project_q(x, p, n_heads=n_heads, hd=hd, rd=rd, positions=positions,
                   theta=theta, eps=norm_eps)
    c_kv, k_rope = _latent_kv(x, p, positions=positions, theta=theta, eps=norm_eps)
    k, v = _expand_kv(c_kv, k_rope, p, n_heads=n_heads, hd=hd)
    v_pad = F.pad(v, (0, rd))  # value dim hd < qk dim hd + rd
    out = kops.flash_attention(q, k, v_pad, causal=True, window=window, impl=impl)
    out = out[..., :hd].reshape(b, s, n_heads * hd) @ p["wo"]
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
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token MLA decode against the latent cache.  x: (B, D); caches
    (B, T, kv_lora) and (B, T, rd), written in place at ``write_index``.
    Returns (out (B, D), (ckv_cache, krope_cache))."""
    b = x.shape[0]
    hd, rd = head_dim, rope_head_dim
    pos = position[:, None]
    q = _project_q(x[:, None, :], p, n_heads=n_heads, hd=hd, rd=rd, positions=pos,
                   theta=theta, eps=norm_eps)  # (B, 1, H, hd + rd)
    c_kv, k_rope = _latent_kv(x[:, None, :], p, positions=pos, theta=theta, eps=norm_eps)
    cache_write(ckv_cache, c_kv[:, 0], write_index, cache_update)
    cache_write(krope_cache, k_rope[:, 0], write_index, cache_update)
    k, v = _expand_kv(ckv_cache, krope_cache, p, n_heads=n_heads, hd=hd)
    v_pad = F.pad(v, (0, rd))
    out = kops.decode_attention(q[:, 0].contiguous(), k, v_pad, cache_len, impl=impl)
    out = out[..., :hd].reshape(b, n_heads * hd) @ p["wo"]
    return out, (ckv_cache, krope_cache)
