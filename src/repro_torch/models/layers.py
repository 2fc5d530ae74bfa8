"""Shared layer primitives, mirroring ``repro.models.layers``.

Conventions:
* activations (B, S, D) in the full-sequence forward and (B, D) in decode;
  attention heads laid out (B, S, H, hd).
* params are nested ParamTrees (or dicts) of tensors; layer stacks carry a
  leading ``n_layers`` axis.
* norms and softmax statistics in float32, matmuls in the config dtype;
  casts sit where the JAX code has them, so bf16 rounds at the same places.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def cache_write(
    cache: torch.Tensor,
    new: torch.Tensor,
    write_index: torch.Tensor,
    mode: str = "scatter",
) -> torch.Tensor:
    """Write one token into a (B, T, ...) cache at per-batch slots, in
    place; returns ``cache``.

    ``scatter``: an indexed write at ``[b, write_index[b]]``.
    ``onehot``: a select against an iota mask over the whole cache (the
    reference's partition-friendly form); the same values, more traffic.
    """
    if mode == "scatter":
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, write_index.long()] = new.to(cache.dtype)
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


def _rope_qk(q, k, positions, theta, mrope_sections, mrope_positions):
    """RoPE of q and k, or M-RoPE where ``mrope_sections`` is given (with
    ``mrope_positions`` (3, B, S), or the text positions of ``positions``)."""
    if mrope_sections is None:
        return apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    pos3 = mrope_positions if mrope_positions is not None else text_mrope_positions(positions)
    return (apply_mrope(q, pos3, theta, mrope_sections),
            apply_mrope(k, pos3, theta, mrope_sections))


# -- feed-forward --------------------------------------------------------------------
def swiglu(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    gate = F.silu(x @ p["wg"])
    return (gate * (x @ p["wu"])) @ p["wd"]


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
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence GQA attention (prefill).  x: (B, S, D); positions:
    (B, S) absolute positions; with ``mrope_sections``, M-RoPE over
    ``mrope_positions`` (3, B, S) (default: the text positions).  Returns
    (output (B, S, D), (k, v)), k/v (B, S, KH, hd) after RoPE, so a caller
    can seed a KV cache from them."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    q, k = _rope_qk(q, k, positions, theta, mrope_sections, mrope_positions)
    out = kops.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    out = out.reshape(b, s, n_heads * head_dim) @ p["wo"]
    return out, (k, v)


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
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode.  x: (B, D); position: (B,) absolute positions
    (with ``mrope_sections``, M-RoPE over the text positions); caches
    (B, T, KH, hd), written in place at ``write_index`` (ring-buffer slots
    for sliding windows; == position for full caches).
    Returns (output (B, D), (k_cache, v_cache))."""
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, 1, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, 1, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, 1, n_kv_heads, head_dim)
    q, k = _rope_qk(q, k, position[:, None], theta, mrope_sections, None)
    cache_write(k_cache, k[:, 0], write_index, cache_update)
    cache_write(v_cache, v[:, 0], write_index, cache_update)
    out = kops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, cache_len, impl=impl
    )
    out = out.reshape(b, n_heads * head_dim) @ p["wo"]
    return out, (k_cache, v_cache)


def cross_attention(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    enc_k: torch.Tensor,
    enc_v: torch.Tensor,
    *,
    n_heads: int,
    head_dim: int,
    impl: str = "auto",
) -> torch.Tensor:
    """Encoder-decoder cross attention (Whisper), bidirectional.  x:
    (B, S, D); enc_k/enc_v: the projected encoder states (B, T_enc, KH, hd)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    out = kops.flash_attention(q, enc_k, enc_v, causal=False, impl=impl)
    return out.reshape(b, s, n_heads * head_dim) @ p["wo"]


def project_cross_kv(
    enc_out: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    *,
    n_kv_heads: int,
    head_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, T, D) → cross-attention k, v (B, T, KH, hd)."""
    b, t, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(b, t, n_kv_heads, head_dim)
    v = (enc_out @ p["wv"]).reshape(b, t, n_kv_heads, head_dim)
    return k, v
