"""Carry weights and optimizer state from the JAX reference into the port.

The reference's param tree, with each leaf turned into a numpy array
(``jax.tree.map(np.asarray, params)``), becomes a :class:`ParamTree` with
the same names, shapes and dtypes; its AdamW state ``(step, m, v)`` as
numpy becomes an :class:`~repro_torch.training.optimizer.AdamWState`.
bf16 leaves arrive as numpy arrays of the ``bfloat16`` extension dtype and
are reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ParamTree, param_spec
from repro_torch.training.optimizer import AdamWState


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: torch refuses to share read-only buffers
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _convert(tree: Mapping[str, Any], spec: Mapping[str, Any], path: str, device,
             dtype: Any = None):
    if set(tree) != set(spec):
        raise ValueError(
            f"{path or 'params'}: keys {sorted(tree)} differ from the "
            f"config's {sorted(spec)}"
        )
    out = {}
    for key, want in spec.items():
        where = f"{path}.{key}" if path else key
        if isinstance(want, dict):
            out[key] = _convert(tree[key], want, where, device, dtype)
            continue
        t = _tensor(np.asarray(tree[key]))
        shape, leaf_dtype, _ = want
        leaf_dtype = dtype or leaf_dtype
        if tuple(t.shape) != tuple(shape) or t.dtype != leaf_dtype:
            raise ValueError(
                f"{where}: got {tuple(t.shape)} {t.dtype}, want {tuple(shape)} {leaf_dtype}"
            )
        out[key] = t.to(device)
    return out


def params_from_numpy(
    tree: Mapping[str, Any], cfg: ModelConfig, device: Device = "cuda"
) -> ParamTree:
    """The JAX param tree (leaves as numpy arrays) → the port's params on
    ``device``, checked leaf by leaf against ``cfg``'s layout."""
    dev = resolve_device(device)
    with torch.no_grad():
        return ParamTree(_convert(tree, param_spec(cfg), "", dev))


def adamw_state_from_numpy(
    step: Any,
    m: Mapping[str, Any],
    v: Mapping[str, Any],
    cfg: ModelConfig,
    device: Device = "cuda",
) -> AdamWState:
    """The reference's ``AdamWState(step, m, v)`` with numpy leaves → the
    port's, on ``device``.  Each moment is checked against the params'
    layout: the same names and shapes, every leaf in the moments' one
    dtype (fp32, or bf16 from ``opt.init(params, moment_dtype=bfloat16)``)."""
    dev = resolve_device(device)
    first = next(_leaves(m))
    dtype = _tensor(np.asarray(first)).dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moments must be fp32 or bf16; got {dtype}")
    spec = param_spec(cfg)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        m=_convert(m, spec, "m", dev, dtype),
        v=_convert(v, spec, "v", dev, dtype),
    )


def _leaves(tree: Mapping[str, Any]):
    for val in tree.values():
        if isinstance(val, Mapping):
            yield from _leaves(val)
        else:
            yield val
