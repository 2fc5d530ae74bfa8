"""Seeded weights of a hosted model, made on the device in a few large
calls and handed alike to the program and to the plain reference.

The layout (leaf names, shapes, dtypes and how each leaf starts) is the
benchmark's own copy of the one the serving path reads, for the three
families the configurations use: ``dense`` (GQA or MQA attention and a
SwiGLU MLP), ``moe`` (GQA attention and a routed expert FFN) and ``ssm``
(Mamba-2).  A test holds it to the program's ``param_spec``.

Every leaf is a view into one flat buffer a dtype, each leaf starting on a
512-byte boundary.  The buffer is drawn N(0, 1) · 0.02 from one generator
on the device in chunks, then the ``ones`` and ``zeros`` leaves are set.
Refilling the same buffers from another seed keeps every address, so CUDA
graphs captured over them stay valid.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from perfbench import families

#: Leaf starts are rounded up to this many bytes.
ALIGN_BYTES = 512
#: Elements drawn in one call of ``normal_``.
CHUNK = 1 << 28
STD = 0.02

Leaf = Tuple[Tuple[int, ...], str, str]  # shape, dtype name, init


def layout(m: Mapping) -> Dict[str, Leaf]:
    """{dotted path: (shape, dtype, init)} of a model's sizes ``m``; init
    is "normal", "ones" or "zeros"."""
    family = families.of(m)
    if family is not None:
        return family.layout(m)
    d, v, n = m["d_model"], m["vocab"], m["n_layers"]
    dt = m["dtype"]
    out: Dict[str, Leaf] = {
        "embed": ((v, d), dt, "normal"),
        "final_norm": ((d,), dt, "ones"),
        "lm_head": ((d, v), dt, "normal"),
    }
    fam = m["arch_type"]

    def stack(name, shape, dtype, init):
        out[f"layers.{name}"] = ((n,) + shape, dtype, init)

    if fam in ("dense", "moe"):
        h, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        stack("ln1", (d,), dt, "ones")
        stack("ln2", (d,), dt, "ones")
        stack("wq", (d, h * hd), dt, "normal")
        stack("wk", (d, kh * hd), dt, "normal")
        stack("wv", (d, kh * hd), dt, "normal")
        stack("wo", (h * hd, d), dt, "normal")
        if fam == "dense":
            f = m["d_ff"]
            stack("mlp.wg", (d, f), dt, "normal")
            stack("mlp.wu", (d, f), dt, "normal")
            stack("mlp.wd", (f, d), dt, "normal")
        else:
            e, fe = m["n_experts"], m["d_ff_expert"]
            stack("moe.router", (d, e), "float32", "normal")
            stack("moe.wg", (e, d, fe), dt, "normal")
            stack("moe.wu", (e, d, fe), dt, "normal")
            stack("moe.wd", (e, fe, d), dt, "normal")
    elif fam == "ssm":
        di = m["ssm_expand"] * d
        hs = di // m["ssm_head_dim"]
        gn = m["ssm_groups"] * m["ssm_state"]
        c = di + 2 * gn
        stack("ln", (d,), dt, "ones")
        stack("w_in", (d, 2 * di + 2 * gn + hs), dt, "normal")
        stack("conv_w", (m["conv_kernel"], c), dt, "normal")
        stack("conv_b", (c,), dt, "zeros")
        stack("dt_bias", (hs,), "float32", "zeros")
        stack("a_log", (hs,), "float32", "zeros")
        stack("d_skip", (hs,), "float32", "ones")
        stack("w_out", (di, d), dt, "normal")
    else:
        raise ValueError(f"no layout for the {fam!r} family")
    return out


def model_seed(seed: int, model_id: int) -> int:
    """The generator seed of one model under a run's ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), model_id + 1])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


class Weights:
    """One model's leaves, as views into one buffer a dtype."""

    def __init__(self, m: Mapping, device) -> None:
        self.leaves = layout(m)
        self.device = torch.device(device)
        offsets: Dict[str, int] = {}
        plan: Dict[str, List[Tuple[str, int, int]]] = {}
        for path, (shape, dt, _) in self.leaves.items():
            itemsize = torch.empty((), dtype=getattr(torch, dt)).element_size()
            align = ALIGN_BYTES // itemsize
            at = -(-offsets.get(dt, 0) // align) * align
            numel = int(np.prod(shape))
            plan.setdefault(dt, []).append((path, at, numel))
            offsets[dt] = at + numel
        self.buffers = {dt: torch.empty(total, dtype=getattr(torch, dt), device=self.device)
                        for dt, total in offsets.items()}
        self.views: Dict[str, torch.Tensor] = {}
        for dt, rows in plan.items():
            for path, at, numel in rows:
                self.views[path] = self.buffers[dt][at: at + numel].view(self.leaves[path][0])

    def fill(self, seed: int) -> "Weights":
        """Draw every leaf from ``seed``: the same seed, the same bits."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            for dt in sorted(self.buffers):
                buf = self.buffers[dt]
                for a in range(0, buf.numel(), CHUNK):
                    buf[a: a + CHUNK].normal_(0.0, STD, generator=gen)
            for path, (_, _, init) in self.leaves.items():
                if init != "normal":
                    self.views[path].fill_(1.0 if init == "ones" else 0.0)
        return self

    def tree(self) -> Dict:
        """The leaves as a nested dict of tensors, keyed by path parts."""
        out: Dict = {}
        for path, t in self.views.items():
            *parents, leaf = path.split(".")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t
        return out

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.views.values())
