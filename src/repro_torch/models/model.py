"""Model assembly: parameters, the full-sequence forward and loss, the
cache and the one-token decode step, mirroring ``repro.models.model`` for
the ``dense`` and ``ssm`` families.

* ``init_params(cfg, generator, device)`` returns a :class:`ParamTree`, an
  ``nn.Module`` whose parameter names are the JAX param tree's paths
  (``layers.mlp.wg``) with the same shapes and dtypes; homogeneous layer
  stacks keep their leading ``n_layers`` axis.
* ``forward`` runs the whole sequence (prefill) through a Python loop over
  the layers, in place of the reference's ``lax.scan``; attention and the
  SSD scan go through ``kops.flash_attention`` and ``kops.ssd_scan``.
* ``decode_step`` carries an explicit cache dict (see ``init_cache``) and
  supports sliding-window ring buffers; it updates the cache in place.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import Device, resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gqa_attention, gqa_decode_attention, rms_norm, swiglu

Cache = Dict[str, torch.Tensor]

#: Families whose decode and forward are ported, and the ROADMAP items that
#: bring each of the others.
PORTED = ("dense", "ssm")
LATER = {
    "moe": "ROADMAP Queue 1 items 5-6 (the MoE slice: MoE and MLA decode and "
           "forward, with the moe_gmm kernel)",
    "hybrid": "ROADMAP Queue 1 items 5-6 (zamba2's shared block)",
    "vlm": "ROADMAP Queue 1 items 5-6 (M-RoPE)",
    "audio": "ROADMAP Queue 1 items 5-6 (cross-attention and the audio encoder)",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type!r} family is not ported yet; "
            f"it comes with {LATER[cfg.arch_type]}"
        )


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class ParamTree(nn.Module):
    """A nested parameter dict as an ``nn.Module``: ``tree["layers"]["wq"]``
    reads like the JAX pytree, and ``state_dict()`` keys are its paths.
    Parameters are frozen (``requires_grad=False``): this is the decode
    path."""

    def __init__(self, tree: Mapping[str, Any]) -> None:
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def layer(self, i: int) -> Dict[str, Any]:
        """Slice ``i`` of every stacked leaf, as a nested dict of views."""
        out: Dict[str, Any] = {k: p[i] for k, p in self._parameters.items()}
        out.update({k: m.layer(i) for k, m in self._modules.items()})
        return out


# ===========================================================================
# Parameter initialisation
# ===========================================================================
# Each spec leaf is (shape, dtype, init): init is "normal" (N(0, 1) * 0.02,
# drawn in the leaf's dtype), "ones" or "zeros".
def _dense_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    h, kh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = _dtype(cfg)
    return {
        "ln1": ((d,), dt, "ones"),
        "ln2": ((d,), dt, "ones"),
        "wq": ((d, h * hd), dt, "normal"),
        "wk": ((d, kh * hd), dt, "normal"),
        "wv": ((d, kh * hd), dt, "normal"),
        "wo": ((h * hd, d), dt, "normal"),
        "mlp": {
            "wg": ((d, f), dt, "normal"),
            "wu": ((d, f), dt, "normal"),
            "wd": ((f, d), dt, "normal"),
        },
    }


def _ssm_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d, di = cfg.d_model, cfg.d_inner
    h, n = cfg.n_ssm_heads, cfg.ssm_state
    proj = 2 * di + 2 * cfg.ssm_groups * n + h
    c = ssm_mod.conv_channels(cfg)
    dt = _dtype(cfg)
    f32 = torch.float32
    return {
        "ln": ((d,), dt, "ones"),
        "w_in": ((d, proj), dt, "normal"),
        "conv_w": ((cfg.conv_kernel, c), dt, "normal"),
        "conv_b": ((c,), dt, "zeros"),
        "dt_bias": ((h,), f32, "zeros"),
        "a_log": ((h,), f32, "zeros"),
        "d_skip": ((h,), f32, "ones"),
        "w_out": ((di, d), dt, "normal"),
    }


def _stack(spec: Dict[str, Any], n: int) -> Dict[str, Any]:
    return {
        k: _stack(v, n) if isinstance(v, dict) else ((n,) + v[0], v[1], v[2])
        for k, v in spec.items()
    }


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The param tree's layout: nested dict of (shape, dtype, init)."""
    _require_ported(cfg)
    dt = _dtype(cfg)
    spec: Dict[str, Any] = {
        "embed": ((cfg.vocab, cfg.d_model), dt, "normal"),
        "final_norm": ((cfg.d_model,), dt, "ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((cfg.d_model, cfg.vocab), dt, "normal")
    layer = _dense_layer_spec(cfg) if cfg.arch_type == "dense" else _ssm_layer_spec(cfg)
    spec["layers"] = _stack(layer, cfg.n_layers)
    return spec


def _materialize(spec, generator, device) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in spec.items():
        if isinstance(val, dict):
            out[key] = _materialize(val, generator, device)
            continue
        shape, dt, init = val
        if init == "normal":
            out[key] = torch.randn(
                shape, generator=generator, dtype=dt, device=device
            ).mul_(0.02)
        elif init == "ones":
            out[key] = torch.ones(shape, dtype=dt, device=device)
        else:
            out[key] = torch.zeros(shape, dtype=dt, device=device)
    return out


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    device: Device = "cuda",
) -> ParamTree:
    """Random weights with the JAX tree's names, shapes and dtypes.  The
    values come from ``generator`` (on ``device``) and differ from
    ``jax.random``'s; to share weights with the reference, convert its
    tree with :func:`repro_torch.models.convert.params_from_numpy`."""
    dev = resolve_device(device)
    spec = param_spec(cfg)
    with torch.no_grad():
        return ParamTree(_materialize(spec, generator, dev))


# ===========================================================================
# Forward (prefill) and loss
# ===========================================================================
def _attn_kwargs(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd,
        theta=cfg.rope_theta,
    )


def _dense_block(h, layer, positions, cfg, *, window, impl):
    attn_out, kv = gqa_attention(
        rms_norm(h, layer["ln1"], cfg.norm_eps), layer, positions,
        causal=True, window=window, impl=impl, **_attn_kwargs(cfg),
    )
    h = h + attn_out
    h = h + swiglu(rms_norm(h, layer["ln2"], cfg.norm_eps), layer["mlp"])
    return h, kv


def _ssm_block(h, layer, cfg, *, impl, initial_state=None):
    y, state = ssm_mod.mamba2_block(
        rms_norm(h, layer["ln"], cfg.norm_eps), layer, cfg,
        initial_state=initial_state, impl=impl,
    )
    return h + y, state


@torch.no_grad()
def forward(
    params: ParamTree,
    batch: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  ``batch["tokens"]``: (B, S) token ids.
    Returns (logits (B, S, V), aux loss scalar: 0 for these families).
    ``impl`` picks the attention and SSD-scan implementation ("auto": the
    hand-written kernels for CUDA tensors, their plain twins for CPU
    tensors)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    bsz, s = tokens.shape
    h = params["embed"][_token_rows(tokens, cfg.vocab)]  # (B, S, D)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.arch_type == "dense":
        positions = torch.arange(s, device=h.device)[None, :].expand(bsz, s)
        for i in range(cfg.n_layers):
            h, _ = _dense_block(h, params["layers"].layer(i), positions, cfg,
                                window=window, impl=impl)
    else:
        for i in range(cfg.n_layers):
            h, _ = _ssm_block(h, params["layers"].layer(i), cfg, impl=impl)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head, aux


@torch.no_grad()
def next_token_loss(
    params: ParamTree,
    batch: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    aux_weight: float = 0.01,
) -> torch.Tensor:
    """Mean next-token negative log-likelihood over ``batch["tokens"]``
    (forward only: no gradient yet), plus ``aux_weight`` times the aux loss."""
    logits, aux = forward(params, batch, cfg, impl=impl)
    targets = batch["tokens"][:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean() + aux_weight * aux


# ===========================================================================
# Decode cache + one-token decode step
# ===========================================================================
def init_cache(
    cfg: ModelConfig,
    batch: int,
    capacity: int,
    *,
    device: Device = "cuda",
) -> Cache:
    """Family-specific decode cache.  ``capacity`` is the KV capacity —
    the sliding window size for windowed archs, the max sequence length
    otherwise.  SSM caches are O(1) in capacity."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    l, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    cache: Cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.arch_type == "dense":
        cache["k"] = torch.zeros((l, batch, capacity, kh, hd), dtype=dt, device=dev)
        cache["v"] = torch.zeros((l, batch, capacity, kh, hd), dtype=dt, device=dev)
    else:
        cache["conv"] = torch.zeros(
            (l, batch, cfg.conv_kernel - 1, ssm_mod.conv_channels(cfg)),
            dtype=dt, device=dev,
        )
        cache["ssm"] = torch.zeros(
            (l, batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=dev,
        )
    return cache


def _ring(
    pos: torch.Tensor, capacity: int, windowed: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(write_index, cache_len) for ring-buffer vs linear caches."""
    if windowed:
        return torch.remainder(pos, capacity), torch.clamp(pos + 1, max=capacity)
    return pos, pos + 1


def _token_rows(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """Embedding rows for ``tokens`` as JAX's gather picks them: a negative
    id counts from the end, and an id outside the table is clamped to its
    edge.  A pipeline hands one model's tokens to the next, and the zoo's
    vocabularies differ (NeMo's 131072 ids feed granite's 49152 rows)."""
    t = tokens.long()
    return torch.where(t < 0, t + vocab, t).clamp_(0, vocab - 1)


@torch.no_grad()
def decode_step(
    params: ParamTree,
    cache: Cache,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    cache_update: str = "scatter",
) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B,) → (logits (B, V), cache).

    The cache is updated in place (K/V slots, SSM states and ``pos``), and
    the same dict is returned.  Attention goes through
    ``kops.decode_attention`` with ``impl`` ("auto": the hand-written kernel
    for CUDA tensors, its plain twin for CPU tensors)."""
    _require_ported(cfg)
    h = params["embed"][_token_rows(tokens, cfg.vocab)]  # (B, D)
    pos = cache["pos"]
    if cfg.arch_type == "dense":
        capacity = cache["k"].shape[2]
        write_idx, cache_len = _ring(pos, capacity, cfg.sliding_window is not None)
        for i in range(cfg.n_layers):
            layer = params["layers"].layer(i)
            x = rms_norm(h, layer["ln1"], cfg.norm_eps)
            attn_out, _ = gqa_decode_attention(
                x, layer, pos, cache["k"][i], cache["v"][i], cache_len, write_idx,
                impl=impl, cache_update=cache_update, **_attn_kwargs(cfg),
            )
            h = h + attn_out
            h = h + swiglu(rms_norm(h, layer["ln2"], cfg.norm_eps), layer["mlp"])
    else:
        for i in range(cfg.n_layers):
            layer = params["layers"].layer(i)
            y, _, _ = ssm_mod.mamba2_decode(
                rms_norm(h, layer["ln"], cfg.norm_eps), layer, cfg,
                cache["conv"][i], cache["ssm"][i],
            )
            h = h + y
    pos.add_(1)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head, cache
