"""Mixture-of-Experts FFN (Qwen3-MoE / DeepSeek-V2 style), mirroring
``repro.models.moe``.

Two dispatch strategies of the reference's three:

* ``scan`` — every expert on every token, masked by the combined gate.
  Memory-light and dropless; its FLOPs scale with ``n_experts``.  The
  serving engine decodes with it, as the reference's does.
* ``sorted`` — sort the token replicas by expert id, run the grouped
  matmul (``kops.moe_gmm``: the hand-written kernel on a card), and
  combine.  FLOPs scale with ``top_k``.  Dropless.

The reference's ``ep`` dispatch (expert-parallel over a mesh) comes with
the multi-GPU work (ROADMAP Queue 1 item 9).

Routing: softmax top-k with renormalisation over the selected experts,
plus optional always-on shared experts (DeepSeek-V2: 2 shared + 160
routed) and a Switch-style load-balance auxiliary loss.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def route(
    x: torch.Tensor, router_w: torch.Tensor, top_k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D) → (gates (T, K) fp32, expert_idx (T, K) int64, aux_loss ())."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # Switch-style load-balance auxiliary loss: the share of tokens whose
    # first choice is each expert, against the mean router probability.
    n_e = router_w.shape[-1]
    density = _counts(idx[:, 0], n_e, torch.float32) / max(x.shape[0], 1)
    aux = n_e * torch.sum(density * probs.mean(dim=0))
    return gates, idx, aux


def _counts(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """How many times each of 0..n-1 occurs in ``idx``, without reading it
    on the host (``torch.bincount`` does, on a card)."""
    ones = torch.ones(idx.numel(), dtype=dtype, device=idx.device)
    return torch.zeros(n, dtype=dtype, device=idx.device).scatter_add_(0, idx.reshape(-1), ones)


def _expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def moe_ffn(
    x: torch.Tensor,
    p: Mapping[str, torch.Tensor],
    *,
    top_k: int,
    dispatch: str = "sorted",
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Params:
      router : (D, E) fp32
      wg, wu : (E, D, F)    wd : (E, F, D)
      shared_wg/wu/wd (optional): (D, F*n_shared) / (F*n_shared, D)
    Returns (y (B, S, D) in x's dtype, aux_loss)."""
    b, s, d = x.shape
    if dispatch == "ep":
        raise NotImplementedError(
            "dispatch='ep' (expert-parallel over a mesh) comes with the multi-GPU "
            "work, ROADMAP Queue 1 item 9"
        )
    xt = x.reshape(b * s, d)
    gates, idx, aux = route(xt, p["router"], top_k)
    if dispatch == "scan":
        y = _moe_scan(xt, p, gates, idx)
    elif dispatch == "sorted":
        y = _moe_sorted(xt, p, gates, idx, impl=impl)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if "shared_wg" in p:
        y = y + _expert_ffn(xt, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_scan(xt, p, gates, idx) -> torch.Tensor:
    """Every expert on every token, as one batched product over the expert
    axis; each expert's output is weighted by its combined gate (0 where it
    was not chosen) in x's dtype.  The reference accumulates expert by
    expert in x's dtype (a ``lax.scan``); here the sum over experts is taken
    in fp32 and rounded once, which is the same in fp32 up to the order."""
    n_e = p["router"].shape[-1]
    combine = torch.zeros((xt.shape[0], n_e), dtype=torch.float32, device=xt.device)
    combine.scatter_add_(1, idx, gates)                       # (T, E)
    out = _expert_ffn(xt, p["wg"], p["wu"], p["wd"])          # (E, T, D)
    out = out * combine.T[:, :, None].to(out.dtype)
    return out.sum(dim=0, dtype=torch.float32).to(xt.dtype)


def _moe_sorted(xt, p, gates, idx, *, impl: str) -> torch.Tensor:
    """Sort the T·K token replicas by expert (stably, as ``jnp.argsort``),
    run the three grouped matmuls, and combine each token's K weighted
    outputs as a (T, K, D) sum over K: a fixed order, where ``index_add_``'s
    atomics on a card would add in a different order from run to run."""
    t, d = xt.shape
    k = idx.shape[-1]
    n_e = p["router"].shape[-1]
    flat_idx = idx.reshape(-1)                                # (T*K,)
    order = torch.argsort(flat_idx, stable=True)
    x_sorted = xt[order // k]                                 # (T*K, D)
    group_sizes = _counts(flat_idx, n_e, torch.int32)
    h = kops.moe_gmm(x_sorted, p["wg"], group_sizes, impl=impl)
    u = kops.moe_gmm(x_sorted, p["wu"], group_sizes, impl=impl)
    out_sorted = kops.moe_gmm(F.silu(h) * u, p["wd"], group_sizes, impl=impl)
    out = torch.empty_like(out_sorted)
    out[order] = out_sorted                                   # back to token order
    out = out * gates.reshape(-1)[:, None].to(out.dtype)
    return out.reshape(t, k, d).sum(dim=1)
