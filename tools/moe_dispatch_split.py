#!/usr/bin/env python3
"""Whether XLA splits the JAX reference's ``sorted`` and ``scan`` MoE
dispatches over a ``model`` axis that shards the expert banks.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_dispatch_split.py

It lowers the reference's jitted prefill of Qwen3-MoE cut to its reduced
size (``ModelConfig.reduced``: d_model 256, 4 experts, top-2) over B = 2,
S = 256 tokens, with its ``param_pspecs`` shardings, on (1, 1) and on
(1, 4) meshes of forced host devices, under each dispatch, and reads
``cost_analysis()``'s FLOPs a device.  The MoE FFN's share is the
prefill's count less that of the same prefill with ``moe_ffn`` stubbed to
0 (XLA counts the layers' ``lax.scan`` body once, so it is one layer's);
one MoE layer jitted alone (input and output replicated) is counted
beside it.  It prints one JSON object: each count, and each (1, 4) count
over its (1, 1) count.  Runs on the CPU in about 15 s."""

from __future__ import annotations

import json
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import repro.models.moe as moe_mod  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models.sharding import param_pspecs, to_named  # noqa: E402
from repro.training.train import make_prefill_step  # noqa: E402

MESHES = ((1, 1), (1, 4))
DISPATCHES = ("sorted", "scan")


def flops(compiled) -> float:
    cost = compiled.cost_analysis()
    return float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])


def prefill_flops(cfg, mesh, params, tokens, dispatch: str) -> float:
    _, jit_step = make_prefill_step(cfg, mesh, moe_dispatch=dispatch)
    batch = {"tokens": tokens}
    return flops(jit_step(params, batch).lower(params, batch).compile())


def main() -> None:
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced(dtype="float32")
    params = jm.init_params(cfg, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 256)).astype(np.int32)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 256, cfg.d_model)),
                    dtype=jnp.float32)
    layer = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    meshes = {shape: jax.make_mesh(shape, ("data", "model"),
                                   devices=jax.devices()[:shape[0] * shape[1]])
              for shape in MESHES}
    out = {"config": dict(d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
                          d_ff_expert=cfg.d_ff_expert, n_layers=cfg.n_layers, vocab=cfg.vocab,
                          batch=2, seq=256)}
    real = moe_mod.moe_ffn
    moe_mod.moe_ffn = lambda xx, p, **kw: (xx * 0, jnp.zeros((), jnp.float32))
    try:
        rest = {shape: prefill_flops(cfg, mesh, params, tokens, "sorted")
                for shape, mesh in meshes.items()}
    finally:
        moe_mod.moe_ffn = real
    for shape, mesh in meshes.items():
        spec = param_pspecs(mesh, {"moe": layer}, cfg)["moe"]
        for dispatch in DISPATCHES:
            fn = jax.jit(lambda w, xx, d=dispatch: real(xx, w, top_k=cfg.top_k, dispatch=d)[0],
                         in_shardings=(to_named(mesh, spec), NamedSharding(mesh, P())),
                         out_shardings=NamedSharding(mesh, P()))
            total = prefill_flops(cfg, mesh, params, tokens, dispatch)
            out[f"{shape[0]}x{shape[1]} {dispatch}"] = dict(
                expert_bank_spec=str(spec["wg"]), prefill=total, rest_of_prefill=rest[shape],
                moe_in_prefill=total - rest[shape], moe_layer_alone=flops(fn.lower(layer, x).compile()))
    for dispatch in DISPATCHES:
        one, four = out[f"1x1 {dispatch}"], out[f"1x4 {dispatch}"]
        out[f"1x4 over 1x1, {dispatch}"] = {k: four[k] / one[k] for k in (
            "prefill", "rest_of_prefill", "moe_in_prefill", "moe_layer_alone")}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
