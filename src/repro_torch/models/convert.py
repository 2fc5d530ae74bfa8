"""Carry weights from the JAX reference into the port.

The reference's param tree, with each leaf turned into a numpy array
(``jax.tree.map(np.asarray, params)``), becomes a :class:`ParamTree` with
the same names, shapes and dtypes.  bf16 leaves arrive as numpy arrays of
the ``bfloat16`` extension dtype and are reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ParamTree, param_spec


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: torch refuses to share read-only buffers
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _convert(tree: Mapping[str, Any], spec: Mapping[str, Any], path: str, device):
    if set(tree) != set(spec):
        raise ValueError(
            f"{path or 'params'}: keys {sorted(tree)} differ from the "
            f"config's {sorted(spec)}"
        )
    out = {}
    for key, want in spec.items():
        where = f"{path}.{key}" if path else key
        if isinstance(want, dict):
            out[key] = _convert(tree[key], want, where, device)
            continue
        t = _tensor(np.asarray(tree[key]))
        shape, dtype, _ = want
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(
                f"{where}: got {tuple(t.shape)} {t.dtype}, want {tuple(shape)} {dtype}"
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
