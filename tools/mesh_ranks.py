#!/usr/bin/env python3
"""The port's sharded steps on every mesh of this process group, each
rank's results held to the mesh-less step that the rank runs itself.

    torchrun --nproc-per-node N tools/mesh_ranks.py [--device cuda|cpu] [--out DIR]

For a world of W ranks, every ``("data", "model")`` mesh (a, W / a), the
steps tensor parallel over ``model``:

* three ``make_train_step`` steps of a small dense model in fp32 (params
  and moments as DTensors, the batch split over ``data``): loss, grad
  norm and every param within ``REL`` of the mesh-less step's;
* four greedy ``make_serve_step`` tokens (the serve layout, the cache
  under ``cache_pspecs``, split along T over ``model``): equal to the
  mesh-less step's; then one more step whose calls of the partials path
  are counted: one partials and one combine a layer where ``model``
  splits the cache, none elsewhere;
* ``make_prefill_step``'s logits within ``REL``;

then, on (1, W), one MoE layer of the ``ep`` dispatch at a capacity that
keeps every replica (capacity factor W): its output and the gradients of
its input, router and experts against the ``sorted`` dispatch's; the
vocabulary-parallel embedding lookup (ids past the table included) and
negative log-likelihood with its gradient against the whole ones; and on
(W, 1) the SST all-gather of every rank's row, bit for bit.  With
``--inputs FILE`` (the reference's MoE params and an input, and the
reference's weights and batches of the ``TP_CASES``, as
``tests/test_torch_distributed.py`` writes them) it also runs that MoE
model's ``ep`` prefill and one layer at capacity factor 0.5 on (1, W),
and each ``TP_CASES`` model's prefill, two train steps and six serve
tokens in each layout on (1, W) against the mesh-less steps (dense MQA,
MLA, audio, and Mamba-2: its heads split over ``model``, beside a shared
attention block, and H = 3 run whole); with ``--out DIR`` each rank
writes what it saw to ``DIR/out{RANK}.npz``.

Rank 0 prints one JSON line of the checks; the exit code is 1 when any
failed.  On cards each rank takes the card ``LOCAL_RANK`` and the group
runs over NCCL; on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

DENSE = dict(name="tiny", arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
             d_ff=64, vocab=64, dtype="float32")
MOE = dict(name="moe-t", arch_type="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_ff=0, vocab=97, n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
           dtype="float32")
#: The reference's weights run tensor parallel on (1, W): dense MQA (the
#: K/V head gathered and sliced: one K/V head for every query head), MoE
#: with MLA (a vocabulary that ``model`` does not divide: a whole head),
#: and audio (tied embeddings, a cross cache split along T).
TP_CASES = {
    "dense": dict(name="tp-dense", arch_type="dense", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=1, d_ff=64, vocab=96, dtype="float32"),
    "mla": dict(name="tp-mla", arch_type="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                d_ff=0, vocab=97, n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=1,
                use_mla=True, kv_lora_rank=16, q_lora_rank=16, rope_head_dim=8,
                dtype="float32"),
    "audio": dict(name="tp-audio", arch_type="audio", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=2, d_ff=64, vocab=64, n_encoder_layers=2, n_audio_frames=12,
                  tie_embeddings=True, dtype="float32"),
    # H = 4 SSD heads; w_in's 148 columns split evenly over 2 and 4 ranks,
    # so a rank's stored block cuts through its heads' z | x | B | C | dt
    "ssm": dict(name="tp-ssm", arch_type="ssm", n_layers=2, d_model=32, n_heads=0,
                n_kv_heads=0, d_ff=0, vocab=96, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
                dtype="float32"),
    # zamba2-like: a shared attention block (4 heads, a window of 4 slots)
    # after every second of 4 Mamba-2 layers
    "hybrid": dict(name="tp-hybrid", arch_type="hybrid", n_layers=4, d_model=32, n_heads=4,
                   n_kv_heads=4, d_ff=64, vocab=96, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
                   attn_period=2, sliding_window=4, dtype="float32"),
    # H = 3 and w_in's 115 columns: 2 divides neither, so the layer runs
    # whole on every rank
    "ssm-whole": dict(name="tp-ssm-whole", arch_type="ssm", n_layers=2, d_model=24, n_heads=0,
                      n_kv_heads=0, d_ff=0, vocab=96, ssm_state=8, ssm_head_dim=16,
                      ssm_chunk=8, dtype="float32"),
}
#: Each case's tokens a row (default 12).  The ssm case's B·S = 48 rows
#: pass its D = 32, so its prefill and training gather ``w_in`` whole and
#: multiply by a rank's columns; the hybrid case's 24 move the activations.
TP_SEQ = {"ssm": 24}
TP_SERVE_TOKENS, TP_CAPACITY = 6, 8
#: The dense case writes its caches by the one-hot select, the others by
#: the indexed write.
TP_CACHE_UPDATE = {"dense": "onehot"}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
#: The TP cases' AdamW: an eps that keeps an update proportional to its
#: gradient where the gradient is small.  With the default 1e-8 an element
#: whose gradient is ~1e-4 of its leaf's largest takes a near-whole lr
#: step, and the fp32 rounding that tensor-parallel sums change in it
#: (5e-7 of the leaf's largest) moves the param by more than REL.
TP_OPT = dict(OPT, eps=1e-3)
TRAIN_STEPS, SERVE_TOKENS = 3, 4
REL = 1e-5  # fp32: the ranks' shares sum in another order than one device's


def train_batches():
    import torch

    g = torch.Generator().manual_seed(11)
    return [{"tokens": torch.randint(0, 64, (4, 16), generator=g, dtype=torch.int32)}
            for _ in range(TRAIN_STEPS)]


def sst_row(rank: int) -> np.ndarray:
    from repro_torch.core import SSTRow
    from repro_torch.core.sst_exchange import pack_row

    return pack_row(SSTRow(ft_estimate_s=1.5 + rank, cache_bitmap=(5 << 40) | rank,
                           free_cache_bytes=2048.0 * (rank + 1), version=7 + rank,
                           heartbeat_s=0.25 * rank, epoch=3, draining=bool(rank)), queue_len=rank)


def close(got, want) -> bool:
    import torch

    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    return bool(((got - want).abs() <= 1e-6 + REL * want.abs()).all())


def shards_match(tree, mesh, specs) -> bool:
    """Every DTensor's local shard is ``sharding.local_shard`` of its full
    tensor at this rank's coordinates."""
    import torch
    from repro_torch.models import sharding
    from repro_torch.training import optimizer as opt

    sizes, where = sharding.mesh_sizes(mesh), sharding.coords(mesh)
    full = dict(opt.leaves(sharding.gather_tree(tree)))
    ok = True
    for path, d in opt.leaves(tree):
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        ok &= torch.equal(d.to_local(), sharding.local_shard(full[path], sizes, where, spec))
    return ok


def one_device(dev):
    """The mesh-less runs every mesh is held to: (losses, norms, params),
    the serve tokens and the prefill logits."""
    import torch
    from repro_torch.models import ModelConfig, init_cache, init_params
    from repro_torch.training import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.training import optimizer as opt

    cfg = ModelConfig(**DENSE)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu").to(dev)
    logits = make_prefill_step(cfg, device=dev)(params, train_batches()[0])
    state = opt.init(params)
    step = make_train_step(cfg, opt.AdamWConfig(**OPT), device=dev)
    metrics = []
    for batch in train_batches():
        params, state, m = step(params, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    served = init_params(cfg, torch.Generator().manual_seed(5), "cpu").to(dev)
    cache, serve = init_cache(cfg, 2, 8, device=dev), make_serve_step(cfg, device=dev)
    tok, toks = torch.ones(2, dtype=torch.int32, device=dev), []
    for _ in range(SERVE_TOKENS):
        out, cache = serve(served, cache, tok)
        tok = out.argmax(-1).to(torch.int32)
        toks.append(tok.cpu().numpy())
    return metrics, dict(opt.leaves(params)), np.stack(toks), logits


def on_mesh(mesh, dev, want, checks: Dict[str, bool], out: Dict[str, np.ndarray]) -> None:
    import torch
    from repro_torch.models import ModelConfig, init_cache, init_params, sharding
    from repro_torch.training import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.training import optimizer as opt

    tag = "x".join(str(n) for n in sharding.mesh_sizes(mesh).values())
    cfg = ModelConfig(**DENSE)
    metrics, params_want, toks_want, logits_want = want
    base = init_params(cfg, torch.Generator().manual_seed(5), "cpu").to(dev)
    specs = sharding.param_pspecs(mesh, base, cfg)
    params = sharding.shard_tree(base, mesh, specs)
    checks[f"shards {tag}"] = shards_match(params, mesh, specs)
    logits = make_prefill_step(cfg, mesh=mesh)(params, train_batches()[0]).full_tensor()
    checks[f"prefill {tag}"] = close(logits, logits_want)
    state = opt.init(params)
    step = make_train_step(cfg, opt.AdamWConfig(**OPT), mesh=mesh)
    got = []
    for batch in train_batches():
        params, state, m = step(params, state, batch)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    checks[f"moment shards {tag}"] = shards_match(state.m, mesh, specs)
    full = dict(opt.leaves(sharding.gather_tree(params)))
    checks[f"train metrics {tag}"] = close(got, metrics)
    checks[f"train params {tag}"] = all(close(full[p], t) for p, t in params_want.items())
    out[f"train_metrics_{tag}"] = np.array(got)
    for p, t in full.items():
        out[f"train_param_{tag}/{p}"] = t.detach().cpu().numpy()

    served = sharding.shard_tree(base.to(dev), mesh,
                                 sharding.param_pspecs(mesh, base, cfg, serve=True))
    cache = init_cache(cfg, 2, 8, device=dev)
    cache = sharding.shard_tree(cache, mesh, sharding.cache_pspecs(mesh, cache))
    serve = make_serve_step(cfg, mesh=mesh, serve_layout=True)
    tok, toks = torch.ones(2, dtype=torch.int32, device=dev), []
    for _ in range(SERVE_TOKENS):
        logits, cache = serve(served, cache, tok)
        tok = logits.full_tensor().argmax(-1).to(torch.int32)
        toks.append(tok.cpu().numpy())
    out[f"serve_tokens_{tag}"] = np.stack(toks)
    checks[f"serve tokens {tag}"] = bool((out[f"serve_tokens_{tag}"] == toks_want).all())
    # one more step, counting the partials path's kernel calls: a layer over
    # a cache split along T (|model| > 1) calls one partials and one combine
    calls = partials_calls(lambda: serve(served, cache, tok))
    out[f"partials_calls_{tag}"] = np.array(calls)
    split_t = sharding.mesh_sizes(mesh)["model"] > 1
    checks[f"partials a layer {tag}"] = calls == ((cfg.n_layers,) * 2 if split_t else (0, 0))


def partials_calls(step) -> tuple:
    """(partials, combine) calls of the kernel ops that ``step()`` makes."""
    from repro_torch.kernels import ops

    count = [0, 0]
    names = ("decode_attention_partials", "combine_partials")
    saved = [getattr(ops, name) for name in names]

    def counted(i):
        def call(*args, **kwargs):
            count[i] += 1
            return saved[i](*args, **kwargs)
        return call

    try:
        for i, name in enumerate(names):
            setattr(ops, name, counted(i))
        step()
    finally:
        for name, fn in zip(names, saved):
            setattr(ops, name, fn)
    return tuple(count)


def ep_against_sorted(mesh, dev, checks: Dict[str, bool]) -> None:
    """One MoE layer at a capacity that keeps every replica: ``ep`` over
    ``mesh``'s model axis, its weights DTensors under ``param_pspecs`` read
    through ``Gathered`` (each rank's expert bank its own block), against
    ``sorted`` on this rank alone: the output and the gradients of the
    input and of every weight (gathered whole)."""
    import torch
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models import sharding

    cfg = ModelConfig(**MOE)
    params = init_params(cfg, torch.Generator().manual_seed(7), "cpu").to(dev)
    layer = {k: v.detach().clone() for k, v in params["layers"].layer(0)["moe"].items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(8)).to(dev)
    weight = torch.linspace(-1, 1, x.numel(), device=dev).view_as(x)
    cf = float(sharding.mesh_sizes(mesh)["model"])
    runs = {}
    for dispatch in ("sorted", "ep"):
        if dispatch == "ep":
            leaves = sharding.shard_tree(layer, mesh, sharding.param_pspecs(mesh, layer))
            view = sharding.Gathered(leaves, mesh)
        else:
            leaves = {k: v.clone() for k, v in layer.items()}
            view = leaves
        for v in leaves.values():
            v.requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        y, aux = moe_ffn(xi, view, top_k=cfg.top_k, dispatch=dispatch, impl="ref",
                         mesh=mesh if dispatch == "ep" else None, capacity_factor=cf)
        (y * weight).sum().backward()
        grads = {k: v.grad.full_tensor() if dispatch == "ep" else v.grad
                 for k, v in leaves.items()}
        runs[dispatch] = (y.detach(), float(aux.detach()), xi.grad, grads)
    (ys, auxs, gxs, gs), (ye, auxe, gxe, ge) = runs["sorted"], runs["ep"]
    tag = "x".join(str(n) for n in sharding.mesh_sizes(mesh).values())
    checks[f"ep output {tag}"] = close(ye, ys) and abs(auxe - auxs) <= REL * abs(auxs)
    checks[f"ep input grad {tag}"] = close(gxe, gxs)
    checks[f"ep param grads {tag}"] = all(close(ge[k], gs[k]) for k in gs)


def ep_of_the_reference(mesh, inputs: str, out: Dict[str, np.ndarray]) -> None:
    """The reference's MoE model and layer input (``inputs``): the ``ep``
    prefill's logits at the default capacity, and one layer at capacity
    factor 0.5, where ranks drop replicas."""
    import torch
    from repro_torch.device import mesh_device
    from repro_torch.models import ModelConfig, params_from_numpy
    from repro_torch.models import sharding
    from repro_torch.models.moe import moe_ffn
    from repro_torch.training import make_prefill_step

    arrays = dict(np.load(inputs))
    tokens, x = torch.as_tensor(arrays.pop("tokens")), torch.as_tensor(arrays.pop("moe_x"))
    tree = read_tree({k: a for k, a in arrays.items() if not k.startswith("tp_")})
    cfg = ModelConfig(**MOE)
    dev = mesh_device(mesh)
    params = params_from_numpy(tree, cfg, dev)
    sharded = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
    prefill = make_prefill_step(cfg, moe_dispatch="ep", impl="ref", mesh=mesh)
    out["ep_logits"] = prefill(sharded, {"tokens": tokens}).full_tensor().cpu().numpy()
    with torch.no_grad():
        y, aux = moe_ffn(x.to(dev), params["layers"].layer(0)["moe"], top_k=cfg.top_k,
                         dispatch="ep", impl="ref", mesh=mesh, capacity_factor=0.5)
    out["ep_layer_y"], out["ep_layer_aux"] = y.cpu().numpy(), np.float64(aux)


def read_tree(arrays: Dict[str, np.ndarray], prefix: str = "") -> Dict:
    """The nested param tree of the ``prefix``ed ``a/b/c`` keys."""
    tree: Dict = {}
    for key, val in arrays.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, last = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    return tree


def tp_steps(case, cfg, params, batches, dev, mesh=None):
    """(prefill logits, train metrics, trained params, serve tokens) of the
    ``case`` model (its cache update by ``TP_CACHE_UPDATE``) from the same
    weights, mesh-less or over ``mesh`` (the training
    layout): prefill of the first batch, a train step on each batch, and
    ``TP_SERVE_TOKENS`` greedy tokens from a cache of ``TP_CAPACITY``
    slots (its cross cache, if any, seeded); over ``mesh`` the tokens in
    the training layout, then in the serve layout."""
    import torch
    from repro_torch.models import init_cache, sharding
    from repro_torch.training import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.training import optimizer as opt

    def place(tree):
        if mesh is None:
            return tree
        return sharding.shard_tree(tree, mesh, sharding.param_pspecs(mesh, tree, cfg))

    kw = dict(mesh=mesh) if mesh is not None else dict(device=dev)
    full = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
    logits = full(make_prefill_step(cfg, **kw)(place(params), batches[0]))
    trained = place(copy.deepcopy(params))
    state = opt.init(trained)
    step = make_train_step(cfg, opt.AdamWConfig(**TP_OPT), **kw)
    metrics = []
    for batch in batches:
        trained, state, m = step(trained, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    leaves = dict(opt.leaves(sharding.gather_tree(trained) if mesh is not None else trained))
    served = []
    for layout in (False,) if mesh is None else (False, True):
        cache = init_cache(cfg, 2, TP_CAPACITY, device=dev)
        if "cross_k" in cache:
            g = torch.Generator().manual_seed(4)
            for k in ("cross_k", "cross_v"):
                cache[k].copy_(torch.randn(cache[k].shape, generator=g))
        if mesh is None:
            weights, layout_kw = params, {}
        else:
            cache = sharding.shard_tree(cache, mesh, sharding.cache_pspecs(mesh, cache))
            weights = sharding.shard_tree(params, mesh, sharding.param_pspecs(
                mesh, params, cfg, serve=layout))
            layout_kw = dict(serve_layout=layout)
        serve = make_serve_step(cfg, cache_update=TP_CACHE_UPDATE.get(case, "scatter"),
                                **kw, **layout_kw)
        tok, toks = torch.ones(2, dtype=torch.int32, device=dev), []
        for _ in range(TP_SERVE_TOKENS):
            out, cache = serve(weights, cache, tok)
            tok = full(out).argmax(-1).to(torch.int32)
            toks.append(tok.cpu().numpy())
        served.append(np.stack(toks))
    return logits, metrics, leaves, served


def tp_of_the_reference(mesh, inputs: str, checks: Dict[str, bool],
                        out: Dict[str, np.ndarray]) -> None:
    """Each ``TP_CASES`` model from the reference's weights (``inputs``):
    its steps over ``mesh`` against the mesh-less ones on this rank, the
    prefill, train metrics and params within ``REL`` and the serve tokens
    equal; the mesh prefill's logits go to ``out`` (the tests hold them
    to the reference's jitted prefill on the same mesh)."""
    import torch
    from repro_torch.device import mesh_device
    from repro_torch.models import ModelConfig, params_from_numpy, sharding

    arrays = dict(np.load(inputs))
    dev = mesh_device(mesh)
    tag = "x".join(str(n) for n in sharding.mesh_sizes(mesh).values())
    for case, kw in TP_CASES.items():
        cfg = ModelConfig(**kw)
        batches = []
        for i in range(2):
            batch = {"tokens": torch.as_tensor(arrays[f"tp_{case}_tokens"][i])}
            if f"tp_{case}_frames" in arrays:
                batch["audio_frames"] = torch.as_tensor(arrays[f"tp_{case}_frames"][i])
            batches.append(batch)
        params = params_from_numpy(read_tree(arrays, f"tp_{case}/"), cfg, dev)
        want = tp_steps(case, cfg, params, batches, dev)
        got = tp_steps(case, cfg, params, batches, dev, mesh)
        checks[f"tp {case} prefill {tag}"] = close(got[0], want[0])
        checks[f"tp {case} train metrics {tag}"] = close(got[1], want[1])
        checks[f"tp {case} train params {tag}"] = all(close(got[2][p], t)
                                                      for p, t in want[2].items())
        checks[f"tp {case} serve tokens {tag}"] = bool((got[3][0] == want[3][0]).all())
        checks[f"tp {case} serve-layout tokens {tag}"] = bool((got[3][1] == want[3][0]).all())
        out[f"tp_{case}_logits"] = got[0].detach().cpu().numpy()
        out[f"tp_{case}_serve_tokens"] = got[3][0]


def vocab_pieces(mesh, dev, checks: Dict[str, bool], out: Dict[str, np.ndarray]) -> None:
    """The vocabulary-parallel embedding lookup over a table stored vocab
    over ``model`` (ids past the table and negative ones clamped, as
    JAX's gather does) against the whole table's, bit for bit; and
    ``vocab_nll`` over each rank's block of the logits, with its gradient,
    against ``log_softmax`` over the whole vocabulary within ``REL``."""
    import torch
    from repro_torch.models import ModelConfig, sharding
    from repro_torch.models.model import _embed, _token_rows

    m, n = sharding.model_rank(mesh)
    v, d = 64, 8
    cfg = ModelConfig(name="v", arch_type="dense", n_layers=1, d_model=d, n_heads=1,
                      n_kv_heads=1, d_ff=8, vocab=v, dtype="float32")
    g = torch.Generator().manual_seed(9)
    table = {"embed": torch.randn(v, d, generator=g)}
    ids = torch.tensor([[-1, 0, 5, 63, 64, 200], [-70, 31, 32, 33, 1, 130000]])
    stored = sharding.shard_tree({k: t.to(dev) for k, t in table.items()}, mesh,
                                 sharding.param_pspecs(mesh, table))
    rows = _embed(sharding.Gathered(stored, mesh), ids.to(dev), cfg, mesh).cpu()
    tag = "x".join(str(k) for k in sharding.mesh_sizes(mesh).values())
    checks[f"vocab embed {tag}"] = torch.equal(rows, table["embed"][_token_rows(ids, v)])
    logits = torch.randn(2, 6, v, generator=g)
    targets = torch.randint(0, v, (2, 6), generator=g)
    weight = torch.linspace(-1, 2, 12).view(2, 6)
    block = logits.chunk(n, -1)[m].clone().to(dev).requires_grad_(True)
    nll = sharding.vocab_nll(block, targets.to(dev), m * (v // n), mesh)
    (nll * weight.to(dev)).sum().backward()
    whole = logits.clone().requires_grad_(True)
    want = -torch.log_softmax(whole, -1).gather(-1, targets[..., None])[..., 0]
    (want * weight).sum().backward()
    checks[f"vocab nll {tag}"] = close(nll.detach(), want.detach())
    checks[f"vocab nll grad {tag}"] = close(block.grad, whole.grad.chunk(n, -1)[m])
    out["vocab_nll"] = nll.detach().cpu().numpy()
    out["vocab_nll_grad"] = block.grad.cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="directory for each rank's out{RANK}.npz")
    ap.add_argument("--inputs", default=None, help="the reference's MoE params and input (.npz)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from repro_torch.core.sst_exchange import make_sst_allgather
    from repro_torch.device import mesh_device
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    first = make_debug_mesh(device=args.device)  # (W, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = mesh_device(first)
    checks: Dict[str, bool] = {}
    out: Dict[str, np.ndarray] = {}
    want = one_device(dev)
    shapes = [(a, world // a) for a in range(world, 0, -1) if world % a == 0]
    for shape in shapes:
        on_mesh(make_mesh(shape, ("data", "model"), args.device), dev, want, checks, out)
    model_mesh = make_mesh((1, world), ("data", "model"), args.device)
    ep_against_sorted(model_mesh, dev, checks)
    vocab_pieces(model_mesh, dev, checks, out)
    if args.inputs:
        ep_of_the_reference(model_mesh, args.inputs, out)
        tp_of_the_reference(model_mesh, args.inputs, checks, out)
    table = make_sst_allgather(first, axis="data")(sst_row(rank)[None]).cpu().numpy()
    out["sst_table"] = table
    checks[f"sst all-gather {world}x1"] = bool(
        (table == np.stack([sst_row(r) for r in range(world)])).all())
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        np.savez(Path(args.out) / f"out{rank}.npz", **out)
    ok = all(checks.values())
    flags = torch.tensor([int(ok)], device=dev)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    if rank == 0:
        print(json.dumps({"world": world, "backend": dist.get_backend(), "device": dev.type,
                          "meshes": shapes, "checks": checks, "ok": bool(flags.item())}))
    dist.destroy_process_group()
    return 0 if flags.item() else 1


if __name__ == "__main__":
    sys.exit(main())
