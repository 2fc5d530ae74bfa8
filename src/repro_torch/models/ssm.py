"""Mamba-2 block and decode (SSD — state-space duality, arXiv:2405.21060),
mirroring ``repro.models.ssm``.

A single input projection produces [z | x | B | C | dt]; a depthwise
causal conv runs over [x | B | C]; the SSD recurrence advances one step per
head; gating with silu(z) and an output projection close the block.

Decode keeps two pieces of per-layer state:
  conv_state : (B, conv_kernel-1, conv_channels)   — causal conv tail
  ssm_state  : (B, H, P, N) fp32                   — SSD recurrent state
The full-sequence block runs the SSD scan through ``kops.ssd_scan``.

With a ``mesh`` whose ``model`` axis divides the H heads
(:func:`sharding.ssm_heads`) the layer is tensor parallel over ``model``,
as the reference's rules store it and GSPMD partitions it: each rank
computes its heads [lo, hi): their z, x and dt columns of ``w_in``, B and
C whole (shared by every head of a group), the conv over their x channels
and every B/C channel, the SSD scan on their heads (``ssm_state`` is the
rank's shard of the ``ssm`` cache: exactly these heads), and ``w_out``
row-parallel over their rows of d_inner, its fp32 partial products summed
by one ``model_sum`` and rounded once.  The per-head vectors and the conv
weights are stored replicated and read in part: they are read whole
(:func:`sharding.whole`), so each rank's gradient of them is a partial.
Where ``model`` does not divide H the layer runs whole on every rank.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding

Heads = Optional[Tuple[int, int]]


def _split_proj(zxbcdt: torch.Tensor, cfg, h: Optional[int] = None):
    """z, x, B, C, dt of ``h`` heads (default: all H) side by side."""
    h = cfg.n_ssm_heads if h is None else h
    gn = cfg.ssm_groups * cfg.ssm_state
    hp = h * cfg.ssm_head_dim
    return torch.split(zxbcdt, [hp, hp, gn, gn, h], dim=-1)


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


def _heads(bc: torch.Tensor, h: int, heads: Heads = None) -> torch.Tensor:
    """Group-shared B or C (..., G, N) repeated to the H SSD heads, or to
    heads [lo, hi) of them."""
    g = bc.shape[-2]
    if heads is None:
        return torch.repeat_interleave(bc, h // g, dim=-2)
    return bc.index_select(-2, torch.arange(*heads, device=bc.device) // (h // g))


def _take(t: torch.Tensor, cuts: Sequence[slice]) -> torch.Tensor:
    """The slices ``cuts`` of ``t``'s last dim, side by side."""
    return torch.cat([t[..., cut] for cut in cuts], dim=-1)


def _cuts(cfg, heads: Tuple[int, int]):
    """What heads [lo, hi) read, as slices of a last dim: (of w_in's
    output z | x | B | C | dt, their z, their x, B and C whole, their dt;
    of the conv's channels x | B | C, their x, B and C; of a per-head
    vector, theirs)."""
    lo, hi = heads
    di, pdim, gn = cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_groups * cfg.ssm_state
    mine = slice(lo * pdim, hi * pdim)
    proj = (mine, slice(di + lo * pdim, di + hi * pdim), slice(2 * di, 2 * di + 2 * gn),
            slice(2 * di + 2 * gn + lo, 2 * di + 2 * gn + hi))
    return proj, (mine, slice(di, di + 2 * gn)), (slice(lo, hi),)


def _read(p, key: str, mesh, cuts) -> torch.Tensor:
    """``p[key]`` (the whole layer), or the slices ``cuts`` of its last dim
    read from the leaf gathered whole (each rank's gradient a partial)."""
    return p[key] if cuts is None else _take(sharding.whole(p, key, mesh), cuts)


def _whole_proj(x: torch.Tensor, p, mesh) -> torch.Tensor:
    """``x @ w_in``, whole on every rank, from ``w_in`` as it is stored
    (:func:`sharding.linear`: no weight moves over ``model``); it enters
    the head split through ``model_enter``, since each rank's gradient of
    it is a partial (its heads' columns and its share of B and C)."""
    return sharding.model_enter(sharding.linear(x, p, "w_in", mesh), mesh)


def _project_out(y: torch.Tensor, p, mesh, heads: Heads) -> torch.Tensor:
    """``y @ w_out`` in the wider dtype: whole, or over ``model`` from the
    rank's heads' rows (its stored block), the fp32 partials summed."""
    if heads is None:
        return _matmul(y, p["w_out"])
    return sharding.model_sum(_matmul(y, sharding.model_block(p, "w_out", 0, mesh)), mesh)


def mamba2_block(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    cfg,
    *,
    initial_state: Optional[torch.Tensor] = None,
    impl: str = "auto",
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba-2 block.  x: (B, S, D).
    Returns (y (B, S, D), final SSM state (B, H, P, N) fp32).

    With a ``mesh`` that splits the heads (see the module's docstring)
    ``initial_state`` and the state returned are the rank's heads'.
    ``w_in``'s stored block over ``model`` (an even cut of the whole
    concatenation, not the rank's heads) reaches the rank's columns by the
    smaller move: with fewer rows R = B·S than D (the whole ``x @ w_in``
    from the stored blocks, then sliced) the activations move (training
    layout: each rank's R × proj / n block gathered; serve layout: the
    R × proj partials all-reduced), else the weight (D × proj gathered
    whole, the rank multiplying by its own columns only)."""
    bsz, s, d = x.shape
    h, pdim, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_groups
    heads = None if mesh is None else sharding.ssm_heads(cfg, mesh)
    proj, chans, own = (None, None, None) if heads is None else _cuts(cfg, heads)
    if heads is None:
        zxbcdt = x @ p["w_in"]
    elif bsz * s >= d:
        zxbcdt = sharding.model_enter(x, mesh) @ _read(p, "w_in", mesh, proj)
    else:
        zxbcdt = _take(_whole_proj(x, p, mesh), proj)
    hl = h if heads is None else heads[1] - heads[0]
    z, xs, b, c, dt = _split_proj(zxbcdt, cfg, hl)
    conv_out = F.silu(_causal_conv(_conv_input(xs, b, c), _read(p, "conv_w", mesh, chans),
                                   _read(p, "conv_b", mesh, chans)))
    di = hl * pdim
    xh = conv_out[..., :di].reshape(bsz, s, hl, pdim).contiguous()
    b = _heads(conv_out[..., di: di + g * n].reshape(bsz, s, g, n), h, heads).contiguous()
    c = _heads(conv_out[..., di + g * n:].reshape(bsz, s, g, n), h, heads).contiguous()
    dt = _softplus(dt.float() + _read(p, "dt_bias", mesh, own)).contiguous()
    a = -torch.exp(_read(p, "a_log", mesh, own).float())  # (H,) or the rank's heads
    y, state = kops.ssd_scan(xh, dt, a, b, c, initial_state=initial_state,
                             chunk=cfg.ssm_chunk, impl=impl)
    y = y + xh * _read(p, "d_skip", mesh, own)[None, None, :, None]
    y = y.reshape(bsz, s, di) * F.silu(z)
    return _project_out(y, p, mesh, heads).to(x.dtype), state


def mamba2_decode(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    cfg,
    conv_state: torch.Tensor,
    ssm_state: torch.Tensor,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (B, D).
    conv_state: (B, K-1, conv_channels); ssm_state: (B, H, P, N).
    Both states are updated in place.
    Returns (y (B, D), conv_state, ssm_state).

    With a ``mesh`` that splits the heads, ``ssm_state`` is the rank's
    heads' (its shard of the cache) and ``conv_state`` whole: each rank
    writes the whole new window, every channel, from the whole ``x @
    w_in`` (so the conv cache's replicas stay equal) and convolves its own
    channels.  ``w_in`` is read as it is stored (its B × proj output
    moves, never the weight: decode's B is far below D)."""
    bsz = x.shape[0]
    h, pdim, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_groups
    heads = None if mesh is None else sharding.ssm_heads(cfg, mesh)
    if heads is None:
        z, xs, b, c, dt = _split_proj(x @ p["w_in"], cfg)
        conv_in = _conv_input(xs, b, c)  # (B, C)
        chans = own = None
        hl = h
    else:
        proj, chans, own = _cuts(cfg, heads)
        zxbcdt = _whole_proj(x, p, mesh)
        z, dt = zxbcdt[:, proj[0]], zxbcdt[:, proj[3]]
        conv_in = zxbcdt[:, cfg.d_inner: cfg.d_inner + conv_channels(cfg)]
        hl = heads[1] - heads[0]
    # Causal conv over [state ‖ new]: the last K positions.
    window = torch.cat([conv_state, conv_in[:, None, :]], dim=1)  # (B,K,C)
    mine = window if chans is None else _take(window, chans)
    conv_out = torch.einsum("bkc,kc->bc", mine, _read(p, "conv_w", mesh, chans)) \
        + _read(p, "conv_b", mesh, chans)
    conv_out = F.silu(conv_out)
    conv_state.copy_(window[:, 1:])
    di = hl * pdim
    xs1 = conv_out[:, :di].reshape(bsz, hl, pdim)
    b1 = _heads(conv_out[:, di: di + g * n].reshape(bsz, g, n), h, heads)
    c1 = _heads(conv_out[:, di + g * n:].reshape(bsz, g, n), h, heads)
    dt1 = _softplus(dt.float() + _read(p, "dt_bias", mesh, own))
    a = -torch.exp(_read(p, "a_log", mesh, own).float())
    y, new_ssm = kops.ssd_decode(xs1, dt1, a, b1, c1, ssm_state)
    ssm_state.copy_(new_ssm)
    y = y + xs1 * _read(p, "d_skip", mesh, own)[None, :, None]
    y = y.reshape(bsz, di) * F.silu(z)
    return _project_out(y, p, mesh, heads).to(x.dtype), conv_state, ssm_state


def conv_channels(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
