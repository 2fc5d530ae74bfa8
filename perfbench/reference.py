"""The plain reference of the served models: a whole-sequence forward in
float32 PyTorch, layer by layer, for the three families the
configurations use.  It imports nothing of the program and takes from
the benchmark only the model's sizes (its configuration file), the
weights the benchmark drew and the token ids.

* ``dense``: RMSNorm, GQA/MQA attention with half-split RoPE, causal
  softmax at 1/sqrt(head_dim), SwiGLU.
* ``moe``: the same attention, then softmax routing to the top k experts
  with the k gates renormalised, each chosen expert a SwiGLU, the outputs
  summed by gate (no shared expert, no QK norm: the sizes as served).
* ``ssm``: Mamba-2 with one input projection [z | x | B | C | dt], a
  causal depthwise conv over [x | B | C] and SiLU, dt = softplus(dt +
  dt_bias), A = -exp(a_log), the SSD recurrence from a zero state in its
  quadratic form, the D skip, the SiLU(z) gate and the output projection.

Token ids outside the vocabulary are clamped to its edge, a negative id
counts from the end: a pipeline hands one model's tokens to the next.

Each layer's weights are cast to float32 when the layer runs, so the
whole model never lies on the device in float32.  TF32 is off.  With
``fp8=True`` every product with a weight stored in bfloat16 is computed
from operands rounded to float8 e4m3 (a scale a row of activations, a
scale an output column of the weight): the control of the comparison.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench import families

FP8_MAX = 448.0


def exact_matmuls() -> None:
    """float32 products in full float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return _fp8(x, -1) @ _fp8(w, -2)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (N, L, H, D) at positions 0..L-1, rotated by halves."""
    n, l, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(l, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(w: Mapping[str, torch.Tensor], i: int, prefix: str,
           skip: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves under ``layers.<prefix>`` but those under
    ``skip``, in float32."""
    key = f"layers.{prefix}"
    return {p[len(key):]: t[i].float() for p, t in w.items()
            if p.startswith(key) and not p[len(key):].startswith(skip)}


def _attention(x, p, m, fp8):
    n, l, _ = x.shape
    h, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = _rope(_mm(x, p["wq"], fp8).view(n, l, h, hd), m["rope_theta"])
    k = _rope(_mm(x, p["wk"], fp8).view(n, l, kh, hd), m["rope_theta"])
    v = _mm(x, p["wv"], fp8).view(n, l, kh, hd)
    k = torch.repeat_interleave(k, h // kh, dim=2)
    v = torch.repeat_interleave(v, h // kh, dim=2)
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) * hd ** -0.5
    later = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
    s = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
    out = torch.einsum("nhqk,nkhd->nqhd", s, v).reshape(n, l, h * hd)
    return _mm(out, p["wo"], fp8)


def _swiglu(x, wg, wu, wd, fp8):
    return _mm(F.silu(_mm(x, wg, fp8)) * _mm(x, wu, fp8), wd, fp8)


def _moe(x, w, i, m, fp8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed FFN of layer ``i``: (output, expert ids (N, L, k))."""
    n, l, d = x.shape
    xt = x.reshape(n * l, d)
    router = w["layers.moe.router"][i].float()
    probs = torch.softmax(xt @ router, dim=-1)
    gates, idx = torch.topk(probs, m["top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    wg, wu, wd = (w[f"layers.moe.{k}"][i] for k in ("wg", "wu", "wd"))
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        out = _swiglu(xt[rows], wg[e].float(), wu[e].float(), wd[e].float(), fp8)
        y.index_add_(0, rows, out * gates[rows, slot, None])
    return y.view(n, l, d), idx.view(n, l, -1)


def _mamba2(x, p, m, fp8):
    n, l, d = x.shape
    di = m["ssm_expand"] * d
    pd, ns, g = m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    h = di // pd
    gn = g * ns
    zx = _mm(x, p["w_in"], fp8)
    z, xs, b, c, dt = torch.split(zx, [di, di, gn, gn, h], dim=-1)
    k = m["conv_kernel"]
    pad = F.pad(torch.cat([xs, b, c], dim=-1), (0, 0, k - 1, 0))
    conv = sum(pad[:, j: j + l] * p["conv_w"][j] for j in range(k)) + p["conv_b"]
    conv = F.silu(conv)
    xh = conv[..., :di].reshape(n, l, h, pd)
    bh = torch.repeat_interleave(conv[..., di: di + gn].reshape(n, l, g, ns), h // g, dim=2)
    ch = torch.repeat_interleave(conv[..., di + gn:].reshape(n, l, g, ns), h // g, dim=2)
    dt = torch.logaddexp(dt + p["dt_bias"], torch.zeros_like(dt))
    acum = torch.cumsum(-torch.exp(p["a_log"]) * dt, dim=1)          # (N, L, H)
    seg = acum[:, :, None, :] - acum[:, None, :, :]                   # (N, t, s, H)
    later = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
    decay = torch.exp(seg.masked_fill(later[None, :, :, None], float("-inf")))
    cb = torch.einsum("nthk,nshk->ntsh", ch, bh)
    y = torch.einsum("ntsh,nshp->nthp", decay * cb * dt[:, None], xh)
    y = y + xh * p["d_skip"][None, None, :, None]
    return _mm(y.reshape(n, l, di) * F.silu(z), p["w_out"], fp8)


def _clamped(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    t = tokens.long()
    return torch.where(t < 0, t + vocab, t).clamp(0, vocab - 1)


@torch.no_grad()
def forward(
    m: Mapping,
    w: Mapping[str, torch.Tensor],
    tokens: torch.Tensor,
    want: torch.Tensor,
    *,
    fp8: bool = False,
    routing: bool = False,
) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
    """Logits (K, V) float32 at the K positions where ``want`` (N, L) is
    true, in row-major order, of the model with sizes ``m`` and leaves
    ``w`` (dotted paths) over ``tokens`` (N, L) from position 0; with
    ``routing``, an MoE model's expert ids (N, L, k) a layer too."""
    family = families.of(m)
    if family is not None:
        return family.forward(m, w, tokens, want, fp8=fp8, routing=routing)
    fam, eps = m["arch_type"], m.get("norm_eps", 1e-5)
    h = w["embed"][_clamped(tokens, m["vocab"])].float()
    routes: Optional[List[torch.Tensor]] = [] if routing else None
    for i in range(m["n_layers"]):
        if fam == "ssm":
            p = _layer(w, i, "")
            h = h + _mamba2(_rms(h, p["ln"], eps), p, m, fp8)
            continue
        p = _layer(w, i, "", skip=("mlp.", "moe."))
        h = h + _attention(_rms(h, p["ln1"], eps), p, m, fp8)
        x = _rms(h, p["ln2"], eps)
        if fam == "dense":
            f = _layer(w, i, "mlp.")
            h = h + _swiglu(x, f["wg"], f["wu"], f["wd"], fp8)
        else:
            y, idx = _moe(x, w, i, m, fp8)
            h = h + y
            if routes is not None:
                routes.append(idx)
    hs = _rms(h[want], w["final_norm"].float(), eps)
    return _mm(hs, w["lm_head"].float(), fp8), routes


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the best, under the
    reference's logits ``ref`` (K, V): (K,), 0 where it is the best."""
    return ref.max(-1).values - ref.gather(-1, chosen.long()[:, None])[:, 0]
