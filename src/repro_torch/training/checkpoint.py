"""Checkpoints in the reference's on-disk layout (``repro.training.checkpoint``):
``path.npz`` with one array per leaf, keyed by its tree path joined with
``/`` (``params/layers/mlp/wg``, ``opt/m/layers/wq``, ``opt/step``), and
``path.json``, a manifest of each leaf's ``shape`` and ``dtype`` and the
caller's ``metadata``.  A checkpoint that either package writes in fp32
restores in the other.

bf16 leaves are written as the reference writes them: numpy has no
bfloat16, so the ``.npz`` holds their 2-byte records raw (the reference's
``ml_dtypes`` arrays land as ``'<V2'``, these as ``'|V2'``: both read back
as ``V2``) and the manifest says ``bfloat16``.  :func:`restore` reads such a leaf from its
raw bytes, by the manifest's dtype.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState, leaves

Tree = Any


def _plain(tree: Tree) -> Tree:
    """An ``AdamWState`` as the reference's ``state._asdict()``."""
    if isinstance(tree, AdamWState):
        return tree._asdict()
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array as written to the .npz, dtype name for the manifest)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf holds {arr.dtype.itemsize}-byte records")
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


def save(path: str, tree: Tree, metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (nested dicts, ParamTrees and AdamWStates of tensors)
    to ``path.npz`` and ``path.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, manifest = {}, {}
    for key, t in leaves(_plain(tree)):
        arrays[key], dtype = _to_numpy(t)
        manifest[key] = {"shape": list(t.shape), "dtype": dtype}
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"leaves": manifest, "metadata": metadata or {}}, f, indent=1)


def restore(path: str, template: Tree) -> Tuple[Dict[str, Any], Dict]:
    """Read ``path`` into the layout of ``template`` (shapes validated;
    each leaf cast to the template's dtype and put on its device).
    Returns (nested dicts of tensors, the manifest's metadata)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    data = np.load(path + ".npz")
    expected = list(leaves(_plain(template)))
    arrays = {}
    for key, leaf in expected:
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arrays[key] = data[key]
        if tuple(arrays[key].shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key!r}: checkpoint "
                f"{arrays[key].shape} vs template {tuple(leaf.shape)}"
            )
    out: Dict[str, Any] = {}
    for key, leaf in expected:
        dtype = manifest["leaves"].get(key, {}).get("dtype", str(arrays[key].dtype))
        t = _from_numpy(arrays.pop(key), dtype).to(device=leaf.device, dtype=leaf.dtype)
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t
    return out, manifest["metadata"]
