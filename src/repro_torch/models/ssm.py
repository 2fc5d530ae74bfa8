"""Mamba-2 block and decode (SSD — state-space duality, arXiv:2405.21060),
mirroring ``repro.models.ssm``.

A single input projection produces [z | x | B | C | dt]; a depthwise
causal conv runs over [x | B | C]; the SSD recurrence advances one step per
head; gating with silu(z) and an output projection close the block.

Decode keeps two pieces of per-layer state:
  conv_state : (B, conv_kernel-1, conv_channels)   — causal conv tail
  ssm_state  : (B, H, P, N) fp32                   — SSD recurrent state
The full-sequence block runs the SSD scan through ``kops.ssd_scan``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def _split_proj(zxbcdt: torch.Tensor, cfg):
    di = cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    return torch.split(zxbcdt, [di, di, g * n, g * n, h], dim=-1)


def _conv_input(xs, b, c):
    return torch.cat([xs, b, c], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0), with no large-x threshold.
    return torch.logaddexp(x, torch.zeros_like(x))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion: mixed dtypes meet at the wider one."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv.  x: (B, S, C); w: (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + bias


def _heads(bc: torch.Tensor, h: int) -> torch.Tensor:
    """Group-shared B or C (B, S, G, N) repeated to the H SSD heads."""
    return torch.repeat_interleave(bc, h // bc.shape[2], dim=2)


def mamba2_block(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    cfg,
    *,
    initial_state: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba-2 block.  x: (B, S, D).
    Returns (y (B, S, D), final SSM state (B, H, P, N) fp32)."""
    bsz, s, _ = x.shape
    h, pdim, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_groups
    z, xs, b, c, dt = _split_proj(x @ p["w_in"], cfg)
    conv_out = F.silu(_causal_conv(_conv_input(xs, b, c), p["conv_w"], p["conv_b"]))
    di = cfg.d_inner
    xh = conv_out[..., :di].reshape(bsz, s, h, pdim).contiguous()
    b = _heads(conv_out[..., di: di + g * n].reshape(bsz, s, g, n), h).contiguous()
    c = _heads(conv_out[..., di + g * n:].reshape(bsz, s, g, n), h).contiguous()
    dt = _softplus(dt.float() + p["dt_bias"]).contiguous()
    a = -torch.exp(p["a_log"].float())  # (H,)
    y, state = kops.ssd_scan(xh, dt, a, b, c, initial_state=initial_state,
                             chunk=cfg.ssm_chunk, impl=impl)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di) * F.silu(z)
    return _matmul(y, p["w_out"]).to(x.dtype), state


def mamba2_decode(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    cfg,
    conv_state: torch.Tensor,
    ssm_state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (B, D).
    conv_state: (B, K-1, conv_channels); ssm_state: (B, H, P, N).
    Both states are updated in place.
    Returns (y (B, D), conv_state, ssm_state)."""
    bsz = x.shape[0]
    h, pdim, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_groups
    z, xs, b, c, dt = _split_proj(x @ p["w_in"], cfg)
    conv_in = _conv_input(xs, b, c)  # (B, C)
    # Causal conv over [state ‖ new]: the last K positions.
    window = torch.cat([conv_state, conv_in[:, None, :]], dim=1)  # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    conv_state.copy_(window[:, 1:])
    di = cfg.d_inner
    xs1 = conv_out[:, :di].reshape(bsz, h, pdim)
    b1 = conv_out[:, di: di + g * n].reshape(bsz, g, n)
    c1 = conv_out[:, di + g * n:].reshape(bsz, g, n)
    b1 = torch.repeat_interleave(b1, h // g, dim=1)
    c1 = torch.repeat_interleave(c1, h // g, dim=1)
    dt1 = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    y, new_ssm = kops.ssd_decode(xs1, dt1, a, b1, c1, ssm_state)
    ssm_state.copy_(new_ssm)
    y = y + xs1 * p["d_skip"][None, :, None]
    y = y.reshape(bsz, di) * F.silu(z)
    return _matmul(y, p["w_out"]).to(x.dtype), conv_state, ssm_state


def conv_channels(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
