"""A family file for the tests: the built-in ``moe`` family with one thing
it cannot express, always-on shared experts (DeepSeek's: a SwiGLU of
``n_shared_experts`` · ``d_ff_expert`` columns that every token runs
beside its routed experts, the program's ``moe.shared_wg/wu/wd``).

The tests copy it into a copy of the benchmark as
``families/moe_shared.py`` and name it from a model's sizes
(``"family": "moe_shared"``)."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench import counting, reference


def layout(m: Mapping) -> Dict[str, Tuple[Tuple[int, ...], str, str]]:
    d, v, n, dt = m["d_model"], m["vocab"], m["n_layers"], m["dtype"]
    h, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, fe = m["n_experts"], m["d_ff_expert"]
    fs = m["n_shared_experts"] * fe
    out = {"embed": ((v, d), dt, "normal"), "final_norm": ((d,), dt, "ones"),
           "lm_head": ((d, v), dt, "normal")}
    for name, shape, dtype, init in [
            ("ln1", (d,), dt, "ones"), ("ln2", (d,), dt, "ones"),
            ("wq", (d, h * hd), dt, "normal"), ("wk", (d, kh * hd), dt, "normal"),
            ("wv", (d, kh * hd), dt, "normal"), ("wo", (h * hd, d), dt, "normal"),
            ("moe.router", (d, e), "float32", "normal"), ("moe.wg", (e, d, fe), dt, "normal"),
            ("moe.wu", (e, d, fe), dt, "normal"), ("moe.wd", (e, fe, d), dt, "normal"),
            ("moe.shared_wg", (d, fs), dt, "normal"), ("moe.shared_wu", (d, fs), dt, "normal"),
            ("moe.shared_wd", (fs, d), dt, "normal")]:
        out[f"layers.{name}"] = ((n,) + shape, dtype, init)
    return out


@torch.no_grad()
def forward(m: Mapping, w: Mapping[str, torch.Tensor], tokens: torch.Tensor,
            want: torch.Tensor, *, fp8: bool = False, routing: bool = False
            ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
    eps = m.get("norm_eps", 1e-5)
    h = w["embed"][reference._clamped(tokens, m["vocab"])].float()
    routes: Optional[List[torch.Tensor]] = [] if routing else None
    for i in range(m["n_layers"]):
        p = reference._layer(w, i, "", skip=("moe.",))
        h = h + reference._attention(reference._rms(h, p["ln1"], eps), p, m, fp8)
        x = reference._rms(h, p["ln2"], eps)
        y, idx = reference._moe(x, w, i, m, fp8)
        s = reference._layer(w, i, "moe.shared_")
        h = h + y + reference._swiglu(x, s["wg"], s["wu"], s["wd"], fp8)
        if routes is not None:
            routes.append(idx)
    hs = reference._rms(h[want], w["final_norm"].float(), eps)
    return reference._mm(hs, w["lm_head"].float(), fp8), routes


def experts_read(m: Mapping, routes: Sequence[torch.Tensor], rows: slice, steps: int) -> np.ndarray:
    counts = []
    for idx in routes:  # (N, L, k)
        part = idx[rows, :steps]
        hit = torch.zeros(steps, m["n_experts"], device=idx.device)
        hit.scatter_(1, part.permute(1, 0, 2).reshape(steps, -1), 1.0)
        counts.append(hit.sum(-1))
    return torch.stack(counts).cpu().numpy().astype(np.int64)


def _shared_weights(m: Mapping) -> int:
    return 3 * m["d_model"] * m["n_shared_experts"] * m["d_ff_expert"]


def step_flops(m: Mapping, b: int, pos: int) -> float:
    d, v, n = m["d_model"], m["vocab"], m["n_layers"]
    attn = 2 * counting._attn_weights(m) + 4 * m["n_heads"] * m["head_dim"] * (pos + 1)
    ffn = (2 * d * m["n_experts"] + 2 * m["top_k"] * counting.expert_weights(m)
           + 2 * _shared_weights(m))
    return float(b * (n * (attn + ffn) + 2 * d * v))


def step_bytes(m: Mapping, b: int, pos: int, experts: Optional[Sequence[int]] = None) -> float:
    d, v, n = m["d_model"], m["vocab"], m["n_layers"]
    it = counting.ITEMSIZE[m["dtype"]]
    if experts is None or len(experts) != n:
        raise ValueError("an MoE step's bytes need the distinct experts of each layer")
    total = b * d * it + d * it + d * v * it + b * v * it
    kv = b * 2 * m["n_kv_heads"] * m["head_dim"] * it * (pos + 2)
    fixed = (2 * d * it + counting._attn_weights(m) * it + d * m["n_experts"] * 4
             + _shared_weights(m) * it + kv)
    return float(total + sum(fixed + e * counting.expert_weights(m) * it for e in experts))


def reduced(m: Mapping, dtype: str = "float32") -> Dict:
    s = dict(m)
    d, heads = min(m["d_model"], 256), min(m["n_heads"], 4)
    kv = min(m["n_kv_heads"], heads)
    if heads % kv:
        kv = 1
    s.update(name=m["name"] + "-small", dtype=dtype, n_layers=2, d_model=d, n_heads=heads,
             n_kv_heads=kv, head_dim=d // heads, vocab=min(m["vocab"], 512),
             n_experts=min(m["n_experts"], 4), top_k=min(m["top_k"], 2),
             d_ff_expert=min(m["d_ff_expert"], 128))
    return s
