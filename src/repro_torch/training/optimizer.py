"""AdamW with global-norm clipping and LR schedules, mirroring
``repro.training.optimizer``.

The state is ``AdamWState(step, m, v)``: ``step`` a 0-d int32 tensor and
``m``/``v`` nested dicts of tensors shaped like the params (fp32 by
default; ``moment_dtype=torch.bfloat16`` halves them).  The arithmetic is
the reference's, in its order: the global norm of the raw gradients,
clipping by ``clip_norm / (gnorm + 1e-9)``, fp32 moments with bias
correction from ``step``, decoupled weight decay on leaves with
``ndim >= 2`` only, and the update cast back to each parameter's dtype.

Where the reference returns new trees, :func:`apply` updates the params
and moments in place under ``torch.no_grad()`` (it saves a copy of every
leaf: at full width the moments alone are 8 bytes a parameter) and
returns the same objects.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import torch

Tree = Any  # a nested mapping of tensors (a ParamTree or plain dicts)


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Tree
    v: Tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (0-based), as a 0-d fp32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        decay = torch.ones_like(step)
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
        )
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        else:  # linear
            decay = 1.0 - frac
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def _items(tree: Tree):
    """A node's children: a mapping's items, or a ParamTree's parameters
    and then its submodules."""
    if isinstance(tree, Mapping):
        return tree.items()
    return list(tree._parameters.items()) + list(tree._modules.items())


def leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every leaf, with the path's keys joined by ``/``."""
    for key, val in _items(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, torch.Tensor):
            yield path, val
        else:
            yield from leaves(val, path)


def map_tree(fn, tree: Tree) -> Dict[str, Any]:
    """``fn`` over every leaf, as nested dicts of the tree's layout."""
    return {k: fn(v) if isinstance(v, torch.Tensor) else map_tree(fn, v)
            for k, v in _items(tree)}


def init(params: Tree, moment_dtype: torch.dtype = torch.float32) -> AdamWState:
    """Zero moments in ``moment_dtype`` beside each param, on its device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)  # noqa: E731
    device = next(iter(leaves(params)))[1].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=map_tree(zeros, params),
        v=map_tree(zeros, params),
    )


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    total = sum(torch.sum(torch.square(x.float())) for _, x in leaves(tree))
    return torch.sqrt(total)


@torch.no_grad()
def apply(
    cfg: AdamWConfig,
    grads: Tree,
    state: AdamWState,
    params: Tree,
) -> Tuple[Tree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and the moments are updated in place;
    returns ``(params, state, {"grad_norm", "lr"})`` with the new step.
    ``grads`` has the params' layout (any float dtype)."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    stepf = step.float()
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    flat_g = dict(leaves(grads))
    flat_m = dict(leaves(state.m))
    flat_v = dict(leaves(state.v))
    for path, p in leaves(params):
        g, m, v = flat_g[path], flat_m[path], flat_v[path]
        g32 = g.float() if scale is None else g.float() * scale
        m_new = (cfg.b1 * m.float() + (1 - cfg.b1) * g32).to(m.dtype)
        v_new = (cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32).to(v.dtype)
        delta = (m_new.float() / b1c) / (torch.sqrt(v_new.float() / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
