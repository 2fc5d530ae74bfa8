"""Model assembly: parameters, the full-sequence forward and loss, the
cache and the one-token decode step, mirroring ``repro.models.model`` for
every family: ``dense``, ``moe`` (GQA or MLA), ``ssm``, ``hybrid`` (zamba2:
SSM layers and one shared attention block), ``vlm`` (qwen2-vl: M-RoPE over
a vision prefix) and ``audio`` (whisper: an encoder over stub frames and a
decoder with cross-attention).

* ``init_params(cfg, generator, device)`` returns a :class:`ParamTree`, an
  ``nn.Module`` whose parameter names are the JAX param tree's paths
  (``layers.mlp.wg``) with the same shapes and dtypes; homogeneous layer
  stacks keep their leading ``n_layers`` axis.
* ``forward`` runs the whole sequence (prefill) through a Python loop over
  the layers, in place of the reference's ``lax.scan``; attention, the
  SSD scan and the sorted MoE dispatch's grouped matmul go through
  ``kops.flash_attention``, ``kops.ssd_scan`` and ``kops.moe_gmm``.
  ``forward`` and ``next_token_loss`` are differentiable (the params train
  once ``requires_grad_(True)``); with ``remat=True`` each layer is
  recomputed in the backward pass, the matmuls' outputs excepted.
* ``decode_step`` carries an explicit cache dict (see ``init_cache``) and
  supports sliding-window ring buffers; it updates the cache in place.
  Attention, cross-attention over the encoder cache included, goes through
  ``kops.decode_attention``.
* With a ``mesh`` the attention and SwiGLU layers are tensor parallel over
  ``model`` (:mod:`repro_torch.models.layers`), the embedding looks up
  only the rows a rank owns and the head is column-parallel over the
  vocabulary (:func:`sharding.embed_rows`, :func:`sharding.head_logits`),
  and the loss is vocabulary-parallel (:func:`sharding.vocab_nll`); the
  logits that ``forward`` and ``decode_step`` return are gathered over
  ``model`` once, at the end.  The Mamba-2 layers compute a rank's SSD
  heads where ``model`` divides them (:mod:`repro_torch.models.ssm`; the
  ``ssm`` cache's shard is those heads' states), whole on every rank
  where it does not.  The MoE FFN's ``sorted`` and ``scan`` dispatches
  compute on gathered weights, and ``ep`` splits the experts.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.device import Device, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    cross_attention,
    cross_decode_attention,
    gqa_attention,
    gqa_decode_attention,
    project_cross_kv,
    rms_norm,
    swiglu,
)

Cache = Dict[str, torch.Tensor]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class ParamTree(nn.Module):
    """A nested parameter dict as an ``nn.Module``: ``tree["layers"]["wq"]``
    reads like the JAX pytree, and ``state_dict()`` keys are its paths.
    Parameters are frozen (``requires_grad=False``), as serving wants them;
    training turns them on with ``requires_grad_(True)``."""

    def __init__(self, tree: Mapping[str, Any]) -> None:
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def items(self) -> List[Tuple[str, Any]]:
        """(key, child) pairs, as a mapping's: the parameters, then the
        subtrees."""
        return list(self._parameters.items()) + list(self._modules.items())

    def layer(self, i: int) -> Dict[str, Any]:
        """Slice ``i`` of every stacked leaf, as a nested dict of views."""
        out: Dict[str, Any] = {k: p[i] for k, p in self._parameters.items()}
        out.update({k: m.layer(i) for k, m in self._modules.items()})
        return out

    def unstack(self) -> List[Dict[str, Any]]:
        """``layer(i)`` for every i, from one ``unbind`` per stacked leaf.
        Under autograd each leaf then gets one stack of its per-layer
        gradients, where each ``layer(i)`` view would add a zero-padded
        copy of the whole stack to it."""
        parts = {k: torch.unbind(p) for k, p in self._parameters.items()}
        parts.update({k: m.unstack() for k, m in self._modules.items()})
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]


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


def _moe_ffn_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = _dtype(cfg)
    spec = {
        # the router stays fp32 in a bf16 model, as the reference draws it
        "router": ((d, e), torch.float32, "normal"),
        "wg": ((e, d, fe), dt, "normal"),
        "wu": ((e, d, fe), dt, "normal"),
        "wd": ((e, fe, d), dt, "normal"),
    }
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        spec["shared_wg"] = ((d, fs), dt, "normal")
        spec["shared_wu"] = ((d, fs), dt, "normal")
        spec["shared_wd"] = ((fs, d), dt, "normal")
    return spec


def _moe_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec = _dense_layer_spec(cfg)
    del spec["mlp"]
    spec["moe"] = _moe_ffn_spec(cfg)
    return spec


def _mla_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd, rd, h = cfg.d_model, cfg.hd, cfg.rope_head_dim, cfg.n_heads
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    dt = _dtype(cfg)
    return {
        "ln1": ((d,), dt, "ones"),
        "ln2": ((d,), dt, "ones"),
        "mla": {
            "wq_a": ((d, ql), dt, "normal"),
            "q_norm": ((ql,), dt, "ones"),
            "wq_b": ((ql, h * (hd + rd)), dt, "normal"),
            "wkv_a": ((d, kvl + rd), dt, "normal"),
            "kv_norm": ((kvl,), dt, "ones"),
            "wkv_b": ((kvl, h * 2 * hd), dt, "normal"),
            "wo": ((h * hd, d), dt, "normal"),
        },
        "moe": _moe_ffn_spec(cfg),
    }


def _audio_decoder_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """A dense layer plus cross-attention over the encoder's output."""
    d, hd, h, kh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = _dtype(cfg)
    spec = _dense_layer_spec(cfg)
    spec["ln_cross"] = ((d,), dt, "ones")
    spec["cross"] = {
        "wq": ((d, h * hd), dt, "normal"),
        "wk": ((d, kh * hd), dt, "normal"),
        "wv": ((d, kh * hd), dt, "normal"),
        "wo": ((h * hd, d), dt, "normal"),
    }
    return spec


def _stack(spec: Dict[str, Any], n: int) -> Dict[str, Any]:
    return {
        k: _stack(v, n) if isinstance(v, dict) else ((n,) + v[0], v[1], v[2])
        for k, v in spec.items()
    }


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The param tree's layout: nested dict of (shape, dtype, init)."""
    dt = _dtype(cfg)
    at = cfg.arch_type
    spec: Dict[str, Any] = {
        "embed": ((cfg.vocab, cfg.d_model), dt, "normal"),
        "final_norm": ((cfg.d_model,), dt, "ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((cfg.d_model, cfg.vocab), dt, "normal")
    if at in ("dense", "vlm"):
        layer = _dense_layer_spec(cfg)
    elif at in ("ssm", "hybrid"):
        layer = _ssm_layer_spec(cfg)
    elif at == "moe":
        layer = _mla_layer_spec(cfg) if cfg.use_mla else _moe_layer_spec(cfg)
    else:
        layer = _audio_decoder_layer_spec(cfg)
    spec["layers"] = _stack(layer, cfg.n_layers)
    if at == "hybrid":
        spec["shared_block"] = _dense_layer_spec(cfg)
    elif at == "audio":
        spec["encoder"] = _stack(_dense_layer_spec(cfg), cfg.n_encoder_layers)
        spec["enc_final_norm"] = ((cfg.d_model,), dt, "ones")
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


def abstract_params(cfg: ModelConfig, device: Device = "cpu") -> ParamTree:
    """The param tree of :func:`param_spec` as fake tensors on ``device``
    (``FakeTensorMode``: shapes, dtypes and devices, no memory; no card
    is needed for ``"cuda"``), the counterpart of the reference's
    ``jax.eval_shape`` of ``init_params``.  The tensors belong to the
    active fake mode, or to a new one where none is active (their
    ``fake_mode``): a step over them runs inside that mode."""
    def fake(spec):
        return {k: fake(v) if isinstance(v, dict) else torch.empty(v[0], dtype=v[1], device=device)
                for k, v in spec.items()}

    with fake_mode():
        return ParamTree(fake(param_spec(cfg)))


@contextlib.contextmanager
def fake_mode() -> Iterator[FakeTensorMode]:
    """The active ``FakeTensorMode``, or a new one entered for the block."""
    active = active_fake_mode()
    if active is not None:
        yield active
        return
    with FakeTensorMode() as mode:
        yield mode


# ===========================================================================
# Forward (prefill) and loss
# ===========================================================================
#: The ops whose outputs a rematerialised layer keeps: the matmuls, as the
#: reference's ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``
#: keeps its dots; the rest of the layer, attention included, runs again in
#: the backward pass.
SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default)


def _block(fn, remat: bool, *args, **kwargs):
    """``fn(*args, **kwargs)``, under a per-layer checkpoint that saves
    :data:`SAVED_OPS` when ``remat`` and autograd is recording."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(list(SAVED_OPS)),
                      **kwargs)


def _attn_kwargs(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd,
        theta=cfg.rope_theta,
    )


def _dense_block(h, layer, positions, cfg, *, window, impl, mrope_positions=None,
                 causal=True, mesh=None):
    """Attention (M-RoPE where ``mrope_positions`` is given) and SwiGLU."""
    attn_out, kv = gqa_attention(
        rms_norm(h, layer["ln1"], cfg.norm_eps), layer, positions,
        causal=causal, window=window,
        mrope_sections=cfg.mrope_sections if mrope_positions is not None else None,
        mrope_positions=mrope_positions, impl=impl, mesh=mesh, **_attn_kwargs(cfg),
    )
    h = h + attn_out
    h = h + swiglu(rms_norm(h, layer["ln2"], cfg.norm_eps), layer["mlp"], mesh)
    return h, kv


def _moe_block(h, layer, positions, cfg, *, window, impl, dispatch, mesh=None):
    x = rms_norm(h, layer["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        attn_out, _ = mla_mod.mla_attention(
            x, layer["mla"], positions, n_heads=cfg.n_heads, head_dim=cfg.hd,
            rope_head_dim=cfg.rope_head_dim, theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, window=window, impl=impl, mesh=mesh,
        )
    else:
        attn_out, _ = gqa_attention(x, layer, positions, causal=True, window=window,
                                    impl=impl, mesh=mesh, **_attn_kwargs(cfg))
    h = h + attn_out
    ffn_out, aux = moe_mod.moe_ffn(rms_norm(h, layer["ln2"], cfg.norm_eps), layer["moe"],
                                   top_k=cfg.top_k, dispatch=dispatch, impl=impl, mesh=mesh)
    return h + ffn_out, aux


def _ssm_block(h, layer, cfg, *, impl, initial_state=None, mesh=None):
    y, state = ssm_mod.mamba2_block(
        rms_norm(h, layer["ln"], cfg.norm_eps), layer, cfg,
        initial_state=initial_state, impl=impl, mesh=mesh,
    )
    return h + y, state


def _vision_positions(nv: int, s: int, bsz: int, device) -> torch.Tensor:
    """M-RoPE positions (3, B, nv + s) of a vision prefix and its text: the
    prefix on a square-ish grid (t = 0, h = row, w = column), the text
    sequential past it on all three streams."""
    side = max(1, int(nv ** 0.5))
    idx = torch.arange(nv, device=device)
    vis = torch.stack([torch.zeros_like(idx), idx // side, idx % side])  # (3, nv)
    text = (torch.arange(s, device=device) + nv)[None].expand(3, s)
    return torch.cat([vis, text], dim=1)[:, None, :].expand(3, bsz, nv + s)


def _sinusoidal(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encode_audio(params, frames, cfg, *, impl, remat=False, mesh=None):
    """Whisper-style encoder over stub frame embeddings (B, T, D): sinusoidal
    positions added, then bidirectional attention layers (with RoPE, as the
    reference's) and the encoder's final norm."""
    bsz, t, _ = frames.shape
    h = frames + _sinusoidal(t, cfg.d_model, frames.device).to(frames.dtype)[None]
    positions = torch.arange(t, device=h.device)[None, :].expand(bsz, t)
    for layer in params["encoder"].unstack():
        h, _ = _block(_dense_block, remat, h, layer, positions, cfg, window=None,
                      impl=impl, causal=False, mesh=mesh)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _audio_decoder_block(h, enc, layer, positions, cfg, *, window, impl, mesh=None):
    """A dense block, then cross-attention over the encoder's output."""
    h, _ = _dense_block(h, layer, positions, cfg, window=window, impl=impl, mesh=mesh)
    enc_k, enc_v = project_cross_kv(enc, layer["cross"], n_kv_heads=cfg.n_kv_heads,
                                    head_dim=cfg.hd, n_heads=cfg.n_heads, mesh=mesh)
    return h + cross_attention(rms_norm(h, layer["ln_cross"], cfg.norm_eps), layer["cross"],
                               enc_k, enc_v, n_heads=cfg.n_heads, head_dim=cfg.hd, impl=impl,
                               mesh=mesh)


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """The embedding rows of ``tokens`` (:func:`_token_rows`); with a mesh,
    vocabulary-parallel where ``model`` splits the table."""
    ids = _token_rows(tokens, cfg.vocab)
    return params["embed"][ids] if mesh is None else sharding.embed_rows(params, ids, mesh)


def _head(params, h: torch.Tensor, cfg: ModelConfig, mesh) -> Tuple[torch.Tensor, Optional[int]]:
    """(logits, lo): the final norm's output times the head; with a mesh
    that splits the vocabulary, this rank's columns from id ``lo``."""
    if mesh is None:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return h @ head, None
    return sharding.head_logits(params, h, cfg.tie_embeddings, mesh)


def _whole_logits(logits: torch.Tensor, lo: Optional[int], mesh) -> torch.Tensor:
    """Logits over the whole vocabulary: gathered over ``model`` where
    :func:`_head` gave a rank's columns."""
    return logits if lo is None else sharding.model_gather(logits, mesh, -1)


def forward(
    params: ParamTree,
    batch: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    window: Optional[int] = None,
    remat: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  ``batch``:
      tokens        : (B, S) token ids                   (all families)
      vision_embeds : (B, n_vis, D)                      (vlm)
      audio_frames  : (B, n_frames, D)                   (audio)
    Returns (logits (B, S, V), aux loss scalar: the MoE load-balance loss
    summed over the layers, 0 for the other families).  ``impl`` picks the
    kernels' implementation ("auto": the hand-written kernels for CUDA
    tensors, their plain twins for CPU tensors); ``moe_dispatch`` the MoE
    dispatch ("sorted", "scan", or "ep" with a ``mesh``).  ``window`` is the
    dense layers' attention window; zamba2's shared block always takes the
    config's.  ``remat``: under autograd, checkpoint each layer (see
    :func:`_block`).  With a ``mesh`` (a ``DeviceMesh``) ``batch`` is this
    rank's rows, and ``params`` may be a
    :class:`~repro_torch.models.sharding.Gathered` view of DTensors; the
    layers are then tensor parallel over ``model`` (see the module's
    docstring) and the logits come back whole on every rank.
    Differentiable: run it under ``torch.no_grad()`` to build no graph."""
    logits, lo, aux = _forward(params, batch, cfg, impl=impl, moe_dispatch=moe_dispatch,
                               window=window, remat=remat, mesh=mesh)
    return _whole_logits(logits, lo, mesh), aux


def _forward(params, batch, cfg, *, impl, moe_dispatch, window=None, remat=False, mesh=None):
    """:func:`forward`'s (logits, lo, aux), the logits as :func:`_head`
    gives them."""
    at = cfg.arch_type
    tokens = batch["tokens"]
    bsz, s = tokens.shape
    h = _embed(params, tokens, cfg, mesh)  # (B, S, D)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    positions = torch.arange(s, device=h.device)[None, :].expand(bsz, s)
    layers = params["layers"].unstack()
    if at in ("dense", "vlm"):
        pos3 = None
        if at == "vlm":
            vis = batch["vision_embeds"].to(h.dtype)
            nv = vis.shape[1]
            h = torch.cat([vis, h], dim=1)
            positions = torch.arange(nv + s, device=h.device)[None, :].expand(bsz, nv + s)
            if cfg.use_mrope:
                pos3 = _vision_positions(nv, s, bsz, h.device)
        for layer in layers:
            h, _ = _block(_dense_block, remat, h, layer, positions, cfg, window=window,
                          impl=impl, mrope_positions=pos3, mesh=mesh)
        if at == "vlm":
            h = h[:, nv:]  # the vision prefix goes before the head
    elif at == "moe":
        for layer in layers:
            h, a = _block(_moe_block, remat, h, layer, positions, cfg,
                          window=window, impl=impl, dispatch=moe_dispatch, mesh=mesh)
            aux = aux + a
    elif at in ("ssm", "hybrid"):
        for i, layer in enumerate(layers):
            h, _ = _block(_ssm_block, remat, h, layer, cfg, impl=impl, mesh=mesh)
            if at == "hybrid" and (i + 1) % cfg.attn_period == 0:
                h, _ = _block(_dense_block, remat, h, params["shared_block"], positions, cfg,
                              window=cfg.sliding_window, impl=impl, mesh=mesh)
    else:  # audio
        enc = _encode_audio(params, batch["audio_frames"], cfg, impl=impl, remat=remat,
                            mesh=mesh)
        for layer in layers:
            h = _block(_audio_decoder_block, remat, h, enc, layer, positions, cfg,
                       window=window, impl=impl, mesh=mesh)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits, lo = _head(params, h, cfg, mesh)
    return logits, lo, aux


def next_token_loss(
    params: ParamTree,
    batch: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    impl: str = "auto",
    moe_dispatch: str = "sorted",
    aux_weight: float = 0.01,
    remat: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Mean next-token negative log-likelihood over ``batch["tokens"]``,
    plus ``aux_weight`` times the aux loss; differentiable, as
    :func:`forward` is.  The whole ``batch`` goes to :func:`forward` (a
    VLM's ``vision_embeds``, an audio model's ``audio_frames``).  With a
    ``mesh``, ``batch`` is this rank's rows and the mean is over every
    token of the data axes: each rank's mean weighted by its share of the
    tokens and summed (not a plain mean of the ranks' means); each rank's
    gradient is its own share.  Where the mesh's ``model`` splits the
    vocabulary the negative log-likelihood is vocabulary-parallel
    (:func:`sharding.vocab_nll`) over each rank's logits."""
    logits, lo, aux = _forward(params, batch, cfg, impl=impl, moe_dispatch=moe_dispatch,
                               remat=remat, mesh=mesh)
    targets = batch["tokens"][:, 1:].long()
    if lo is None:
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    else:
        nll = sharding.vocab_nll(logits[:, :-1], targets, lo, mesh)
    if mesh is None:
        return nll.mean() + aux_weight * aux
    # each rank's mean weighted by its share of the tokens: the global mean,
    # and at one rank the mesh-less arithmetic (a weight of exactly 1)
    count = nll.new_full((), float(nll.numel()))  # fp32, as nll
    share = count / sharding.data_sum(count, mesh)
    return sharding.data_sum(nll.mean() * share, mesh) + aux_weight * aux


# ===========================================================================
# Decode cache + one-token decode step
# ===========================================================================
def init_cache(
    cfg: ModelConfig,
    batch: int,
    capacity: int,
    *,
    dtype: Optional[torch.dtype] = None,
    device: Device = "cuda",
) -> Cache:
    """Family-specific decode cache, in ``dtype`` (default: the config's;
    SSM states stay fp32).  ``capacity`` is the KV capacity — the sliding
    window size for windowed archs, the max sequence length otherwise.
    SSM caches are O(1) in capacity; zamba2's shared block keeps one ring
    of ``min(capacity, sliding_window)`` slots per application, and an
    audio model's cross-attention cache holds ``n_audio_frames`` slots."""
    dev = resolve_device(device)
    dt = dtype or _dtype(cfg)
    l, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    at = cfg.arch_type

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Cache = {"pos": zeros(batch, dtype=torch.int32)}
    if at == "moe" and cfg.use_mla:
        cache["ckv"] = zeros(l, batch, capacity, cfg.kv_lora_rank)
        cache["krope"] = zeros(l, batch, capacity, cfg.rope_head_dim)
    elif at in ("dense", "vlm", "moe", "audio"):
        cache["k"] = zeros(l, batch, capacity, kh, hd)
        cache["v"] = zeros(l, batch, capacity, kh, hd)
    else:  # ssm, hybrid
        cache["conv"] = zeros(l, batch, cfg.conv_kernel - 1, ssm_mod.conv_channels(cfg))
        cache["ssm"] = zeros(l, batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                             dtype=torch.float32)
    if at == "hybrid":
        napp = cfg.n_layers // cfg.attn_period
        wcap = min(capacity, cfg.sliding_window or capacity)
        cache["shared_k"] = zeros(napp, batch, wcap, kh, hd)
        cache["shared_v"] = zeros(napp, batch, wcap, kh, hd)
    elif at == "audio":
        cache["cross_k"] = zeros(l, batch, cfg.n_audio_frames, kh, hd)
        cache["cross_v"] = zeros(l, batch, cfg.n_audio_frames, kh, hd)
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
    moe_dispatch: str = "sorted",
    cache_update: str = "scatter",
    mesh=None,
    slot_offsets: Optional[Mapping[str, int]] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B,) → (logits (B, V), cache).

    The cache is updated in place (K/V or latent slots, SSM states, the
    shared block's rings and ``pos``), and the same dict is returned.
    Attention, an audio model's cross-attention over ``cross_k/v`` included,
    goes through ``kops.decode_attention`` and the sorted MoE dispatch
    through ``kops.moe_gmm`` with ``impl`` ("auto": the hand-written kernels
    for CUDA tensors, their plain twins for CPU tensors); ``moe_dispatch``
    is "sorted" (the reference's default), "scan" (what serving uses) or
    "ep".  With a ``mesh`` (a ``DeviceMesh``), ``tokens`` and ``cache`` are
    this rank's rows, ``params`` may be a ``Gathered`` view, and the layers
    are tensor parallel over ``model``; ``slot_offsets`` maps each
    attention cache leaf that is split along T over ``model`` (``k``,
    ``v``, ``shared_k/v``, ``cross_k/v``, ``ckv``, ``krope``) to this
    rank's first slot, its leaf in ``cache`` being this rank's slice: it is
    attended by partials combined across the ranks, and each rank writes
    the new token only where it owns the slot.  Where ``model`` splits the
    SSD heads (:func:`sharding.ssm_heads`) the ``ssm`` leaf is this rank's
    heads' shard and ``conv`` is whole.
    A VLM decodes text positions with M-RoPE, with no offset for a vision
    prefix, as the reference does."""
    at = cfg.arch_type
    offsets = slot_offsets or {}
    h = _embed(params, tokens, cfg, mesh)  # (B, D)
    pos = cache["pos"]
    kw = dict(impl=impl, cache_update=cache_update, mesh=mesh, **_attn_kwargs(cfg))
    if at in ("dense", "vlm", "moe", "audio"):
        mla = at == "moe" and cfg.use_mla
        leaf = "ckv" if mla else "k"
        capacity = cache[leaf].shape[2]
        if offsets.get(leaf) is not None:
            capacity *= sharding.model_rank(mesh)[1]
        write_idx, cache_len = _ring(pos, capacity, cfg.sliding_window is not None)
        mrope = cfg.mrope_sections if at == "vlm" and cfg.use_mrope else None
        if at == "audio":
            b = h.shape[0]
            frames = cache["cross_k"].shape[2]
            if offsets.get("cross_k") is not None:
                frames *= sharding.model_rank(mesh)[1]
            enc_len = torch.full((b,), frames, dtype=torch.int32, device=h.device)
        for i in range(cfg.n_layers):
            layer = params["layers"].layer(i)
            x = rms_norm(h, layer["ln1"], cfg.norm_eps)
            if mla:
                attn_out, _ = mla_mod.mla_decode_attention(
                    x, layer["mla"], pos, cache["ckv"][i], cache["krope"][i], cache_len,
                    write_idx, n_heads=cfg.n_heads, head_dim=cfg.hd,
                    rope_head_dim=cfg.rope_head_dim, theta=cfg.rope_theta,
                    norm_eps=cfg.norm_eps, impl=impl, cache_update=cache_update, mesh=mesh,
                    slot_offset=offsets.get("ckv"),
                )
            else:
                attn_out, _ = gqa_decode_attention(
                    x, layer, pos, cache["k"][i], cache["v"][i], cache_len, write_idx,
                    mrope_sections=mrope, slot_offset=offsets.get("k"), **kw,
                )
            h = h + attn_out
            if at == "audio":  # cross-attention over the (static) encoder K/V
                h = h + cross_decode_attention(
                    rms_norm(h, layer["ln_cross"], cfg.norm_eps), layer["cross"],
                    cache["cross_k"][i], cache["cross_v"][i], enc_len, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, impl=impl, mesh=mesh,
                    slot_offset=offsets.get("cross_k"))
            x2 = rms_norm(h, layer["ln2"], cfg.norm_eps)
            if at == "moe":
                ffn, _ = moe_mod.moe_ffn(x2[:, None, :], layer["moe"], top_k=cfg.top_k,
                                         dispatch=moe_dispatch, impl=impl, mesh=mesh)
                h = h + ffn[:, 0]
            else:
                h = h + swiglu(x2, layer["mlp"], mesh)
    else:  # ssm, hybrid
        if at == "hybrid":
            shared = params["shared_block"]
            # the shared block's cache always rings over its window
            ring = cache["shared_k"].shape[2]
            if offsets.get("shared_k") is not None:
                ring *= sharding.model_rank(mesh)[1]
            write_idx, cache_len = _ring(pos, ring, True)
        for i in range(cfg.n_layers):
            layer = params["layers"].layer(i)
            y, _, _ = ssm_mod.mamba2_decode(
                rms_norm(h, layer["ln"], cfg.norm_eps), layer, cfg,
                cache["conv"][i], cache["ssm"][i], mesh,
            )
            h = h + y
            if at == "hybrid" and (i + 1) % cfg.attn_period == 0:
                app = (i + 1) // cfg.attn_period - 1
                attn_out, _ = gqa_decode_attention(
                    rms_norm(h, shared["ln1"], cfg.norm_eps), shared, pos,
                    cache["shared_k"][app], cache["shared_v"][app], cache_len, write_idx,
                    slot_offset=offsets.get("shared_k"), **kw,
                )
                h = h + attn_out
                h = h + swiglu(rms_norm(h, shared["ln2"], cfg.norm_eps), shared["mlp"], mesh)
    pos.add_(1)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits, lo = _head(params, h, cfg, mesh)
    return _whole_logits(logits, lo, mesh), cache
