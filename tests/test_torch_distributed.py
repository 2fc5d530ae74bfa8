"""The port's multi-rank paths on the CPU: one 2-process gloo group runs
``tools/mesh_ranks.py`` (the sharded train, serve and prefill steps on
(2, 1) and (1, 2) ``("data", "model")`` meshes, tensor parallel over
``model``, each held by the ranks to their own mesh-less step; ``ep`` and
its gradients on (1, 2); the vocabulary-parallel embedding and loss on
(1, 2); the reference's dense, MLA and audio weights tensor parallel on
(1, 2); the SST all-gather on (2, 1)).  Held here against the
single-process step (train at 1e-5 in fp32, serve token for token), the
reference's ``ep`` and its jitted GSPMD prefill on a (1, 2) mesh of two
host devices (run once in a subprocess: 2e-5, aux at rtol 1e-5, as
``tests/test_perf_variants.py`` holds ``ep``), and the concatenated rows,
bit for bit, and the reference's ``make_sst_allgather`` on one device."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import models as jm  # noqa: E402
from repro.core import SSTRow as RefSSTRow  # noqa: E402
from repro.core.sst_exchange import make_sst_allgather as ref_allgather  # noqa: E402
from repro.core.sst_exchange import pack_row as ref_pack_row  # noqa: E402
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh  # noqa: E402
from repro_torch.models import ModelConfig, init_cache, init_params  # noqa: E402
from repro_torch.training import make_serve_step, make_train_step  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import mesh_ranks as worker  # noqa: E402

TIMEOUT_S = 240

# the reference's ep on a (1, 2) mesh of two host devices, in its own process
# and the reference's jitted prefill of each TP case under its param_pspecs
REF_EP = """
import sys, numpy as np, jax
from repro import models as jm
from repro.models.moe import moe_ffn
from repro.training.train import make_prefill_step
d = dict(np.load(sys.argv[1] + "/inputs.npz"))
cfg = jm.ModelConfig(**%(moe)r)
tokens, x = d.pop("tokens"), d.pop("moe_x")
def read(prefix):
    tree = {}
    for key, val in d.items():
        if not key.startswith(prefix) or (not prefix and key.startswith("tp_")):
            continue
        node = tree
        *parents, last = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jax.numpy.asarray(val)
    return tree
tree = read("")
mesh = jax.make_mesh((1, 2), ("data", "model"))
logits, aux = jm.forward(tree, {"tokens": tokens}, cfg, moe_dispatch="ep", mesh=mesh)
layer = jax.tree.map(lambda a: a[0], tree["layers"]["moe"])
y, laux = moe_ffn(jax.numpy.asarray(x), layer, top_k=cfg.top_k, dispatch="ep", mesh=mesh,
                  capacity_factor=0.5)
tp = {}
for case, kw in %(tp)r.items():
    batch = {"tokens": d[f"tp_{case}_tokens"][0]}
    if f"tp_{case}_frames" in d:
        batch["audio_frames"] = d[f"tp_{case}_frames"][0]
    params = read(f"tp_{case}/")
    _, jit_step = make_prefill_step(jm.ModelConfig(**kw), mesh)
    tp[f"tp_{case}"] = np.asarray(jit_step(params, batch)(params, batch))
np.savez(sys.argv[1] + "/ref_ep.npz", logits=np.asarray(logits), y=np.asarray(y),
         aux=float(laux), **tp)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' outputs and the reference's ``ep``, from one group."""
    work = tmp_path_factory.mktemp("dist")
    cfg = jm.ModelConfig(**worker.MOE)
    params = jm.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    tp = {}
    for i, (case, kw) in enumerate(worker.TP_CASES.items()):
        ccfg = jm.ModelConfig(**kw)
        tp.update(flatten(jax.tree.map(np.asarray, jm.init_params(ccfg, jax.random.key(10 + i))),
                          f"tp_{case}"))
        tp[f"tp_{case}_tokens"] = rng.integers(
            0, ccfg.vocab, (2, 2, worker.TP_SEQ.get(case, 12))).astype(np.int32)
        if ccfg.arch_type == "audio":
            tp[f"tp_{case}_frames"] = rng.standard_normal(
                (2, 2, ccfg.n_audio_frames, ccfg.d_model)).astype(np.float32)
    np.savez(work / "inputs.npz", tokens=rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             moe_x=rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32),
             **flatten(jax.tree.map(np.asarray, params)), **tp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2", OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", REF_EP % {"moe": worker.MOE,
                                                             "tp": worker.TP_CASES}, str(work)],
                           env=env, cwd=ROOT, stderr=subprocess.PIPE, text=True)
    group = dict(env, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tools" / "mesh_ranks.py"), "--device",
                               "cpu", "--out", str(work), "--inputs", str(work / "inputs.npz")],
                              env=dict(group, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    printed = []
    for p in procs + [ref]:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs + [ref]:
                q.kill()
            raise
        assert p.returncode == 0, (out or "")[-2000:] + err[-4000:]
        printed.append(out)
    outs = [dict(np.load(work / f"out{r}.npz")) for r in range(2)]
    ref_ep = dict(np.load(work / "ref_ep.npz"))
    ref_ep["inputs"] = dict(np.load(work / "inputs.npz"))
    ref_ep["moe_x"] = np.load(work / "inputs.npz")["moe_x"]
    ref_ep["summary"] = json.loads(printed[0].strip().splitlines()[-1])
    return outs, ref_ep


def single_process_train():
    cfg = ModelConfig(**worker.DENSE)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    state = opt.init(params)
    step = make_train_step(cfg, opt.AdamWConfig(**worker.OPT), device="cpu")
    losses, norms = [], []
    for batch in worker.train_batches():
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, dict(opt.leaves(params))


@pytest.mark.parametrize("tag", ["2x1", "1x2"])
def test_sharded_train_step_matches_one_process(ranks, tag):
    outs, _ = ranks
    losses, norms, params = single_process_train()
    for out in outs:
        np.testing.assert_allclose(out[f"train_metrics_{tag}"][:, 0], losses, rtol=1e-5)
        np.testing.assert_allclose(out[f"train_metrics_{tag}"][:, 1], norms, rtol=1e-5)
        for path, p in params.items():
            np.testing.assert_allclose(out[f"train_param_{tag}/{path}"], p.detach().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("tag", ["2x1", "1x2"])
def test_sharded_serve_step_matches_one_process(ranks, tag):
    outs, _ = ranks
    cfg = ModelConfig(**worker.DENSE)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    cache = init_cache(cfg, 2, 8, device="cpu")
    step = make_serve_step(cfg, device="cpu")
    tok, want = torch.ones(2, dtype=torch.int32), []
    for _ in range(worker.SERVE_TOKENS):
        logits, cache = step(params, cache, tok)
        tok = logits.argmax(-1).to(torch.int32)
        want.append(tok.numpy())
    for out in outs:
        np.testing.assert_array_equal(out[f"serve_tokens_{tag}"], np.stack(want))


def test_ep_over_two_model_ranks_matches_the_reference(ranks):
    """The whole model's prefill at the default capacity, and one MoE layer
    at capacity factor 0.5, where each rank drops replicas."""
    outs, ref = ranks
    for out in outs:
        np.testing.assert_allclose(out["ep_logits"], ref["logits"], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(out["ep_layer_y"], ref["y"], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(float(out["ep_layer_aux"]), float(ref["aux"]), rtol=1e-5)


def test_ep_drops_at_a_small_capacity(ranks):
    """At capacity factor 0.5 the layer's output differs from the dropless
    dispatch's: the drops are real."""
    outs, ref = ranks
    cfg = jm.ModelConfig(**worker.MOE)
    params = jm.init_params(cfg, jax.random.key(0))
    layer = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    from repro.models.moe import moe_ffn

    dropless, _ = moe_ffn(jax.numpy.asarray(ref["moe_x"]), layer, top_k=cfg.top_k,
                          dispatch="sorted")
    assert np.abs(np.asarray(dropless) - outs[0]["ep_layer_y"]).max() > 1e-3


def test_the_ranks_own_checks_pass(ranks):
    """Each rank's shards and moments are its blocks of the whole, its
    steps match the mesh-less step it ran itself, and ``ep``'s gradients
    through DTensor storage on (1, 2) match ``sorted``'s."""
    summary = ranks[1]["summary"]
    assert summary["world"] == 2 and summary["backend"] == "gloo"
    assert summary["meshes"] == [[2, 1], [1, 2]]
    for name in ("shards", "moment shards", "train params", "serve tokens", "prefill"):
        assert summary["checks"][f"{name} 2x1"] and summary["checks"][f"{name} 1x2"], name
    for name in ("ep output 1x2", "ep input grad 1x2", "ep param grads 1x2",
                 "sst all-gather 2x1"):
        assert summary["checks"][name], name
    assert summary["ok"]


@pytest.mark.parametrize("tag,calls", [("2x1", (0, 0)), ("1x2", (2, 2))])
def test_t_split_serve_step_calls_one_partials_and_one_combine_a_layer(ranks, tag, calls):
    """A serve step of the 2-layer dense model whose cache ``model`` splits
    along T (1, 2) makes one ``decode_attention_partials`` and one
    ``combine_partials`` call a layer on every rank (the record gathered as
    it is); on (2, 1) the whole decode runs and neither is called."""
    outs, _ = ranks
    for r in range(2):
        assert tuple(outs[r][f"partials_calls_{tag}"]) == calls, r


def test_sst_allgather_over_two_ranks(ranks):
    outs, _ = ranks
    rows = np.stack([worker.sst_row(r) for r in range(2)])
    for out in outs:
        assert out["sst_table"].dtype == np.uint32
        np.testing.assert_array_equal(out["sst_table"], rows)
    ref_rows = np.stack([ref_pack_row(RefSSTRow(
        ft_estimate_s=1.5 + r, cache_bitmap=(5 << 40) | r, free_cache_bytes=2048.0 * (r + 1),
        version=7 + r, heartbeat_s=0.25 * r, epoch=3, draining=bool(r)), queue_len=r)
        for r in range(2)])
    exchange = ref_allgather(ref_debug_mesh(1), axis="data")
    np.testing.assert_array_equal(np.asarray(exchange(jax.numpy.asarray(ref_rows))),
                                  outs[0]["sst_table"])


@pytest.mark.parametrize("case", list(worker.TP_CASES))
def test_tensor_parallel_steps_on_the_references_weights(ranks, case):
    """Dense MQA, MoE with MLA, audio, Mamba-2 (its heads split; the
    hybrid's beside a shared attention block; H = 3, whole) from the
    reference's weights on (1, 2): each rank's tensor-parallel prefill
    logits, train metrics and params within 1e-5 of its mesh-less steps,
    and the serve tokens equal in both layouts (the ranks' own checks);
    both ranks hold the same logits and tokens."""
    outs, ref = ranks
    checks = ref["summary"]["checks"]
    for what in ("prefill", "train metrics", "train params", "serve tokens",
                 "serve-layout tokens"):
        assert checks[f"tp {case} {what} 1x2"], what
    np.testing.assert_array_equal(outs[0][f"tp_{case}_logits"], outs[1][f"tp_{case}_logits"])
    np.testing.assert_array_equal(outs[0][f"tp_{case}_serve_tokens"],
                                  outs[1][f"tp_{case}_serve_tokens"])


@pytest.mark.parametrize("case", list(worker.TP_CASES))
def test_tensor_parallel_prefill_matches_the_references_gspmd_prefill(ranks, case):
    """The reference's jitted prefill with its ``param_pspecs`` shardings
    on a (1, 2) mesh of two host devices (GSPMD partitions it) against the
    port's tensor-parallel prefill over two gloo ranks, at 2e-5."""
    outs, ref = ranks
    for out in outs:
        np.testing.assert_allclose(out[f"tp_{case}_logits"], ref[f"tp_{case}"], atol=2e-5,
                                   rtol=2e-5)


def test_vocab_parallel_embedding_and_loss(ranks):
    """On (1, 2) each rank looks up the embedding rows it owns (ids past
    the table and negative ids clamped first): the whole table's rows bit
    for bit; and the vocabulary-parallel NLL over each rank's half of the
    logits, and its gradient, against ``log_softmax`` over the whole
    vocabulary at 1e-5."""
    outs, ref = ranks
    checks = ref["summary"]["checks"]
    assert checks["vocab embed 1x2"] and checks["vocab nll 1x2"] and checks["vocab nll grad 1x2"]
    g = torch.Generator().manual_seed(9)
    torch.randn(64, 8, generator=g)
    logits = torch.randn(2, 6, 64, generator=g).requires_grad_(True)
    targets = torch.randint(0, 64, (2, 6), generator=g)
    want = -torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    (want * torch.linspace(-1, 2, 12).view(2, 6)).sum().backward()
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["vocab_nll"], want.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["vocab_nll_grad"], logits.grad.chunk(2, -1)[r].numpy(),
                                   rtol=1e-5, atol=1e-6)
