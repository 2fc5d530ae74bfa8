"""Training in the port against ``repro.training`` on the CPU: AdamW (the
counterparts of ``tests/test_training.py``'s optimizer tests, and
``apply`` on identical numpy gradients), checkpoints across the two
packages, the gradients of ``next_token_loss`` for every family against
``jax.value_and_grad``, ``make_train_step`` against the reference's on a
debug mesh, its options (``accum_steps``, ``remat``), the data pipeline's
copy, the optimizer-state converter and the train example.  Inputs are
drawn from seeds with numpy and fed to both packages; gradients and the
optimizer are compared apart, not params after a full step (AdamW's first
update is about sign(g), so where |g| is near 0 the packages may differ
by 2·lr without a fault)."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import make_pipeline as ref_pipeline  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import make_train_step as ref_train_step  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokens, make_pipeline  # noqa: E402
from repro_torch.models.convert import adamw_state_from_numpy  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

ALL = sorted(ARCHS)
GRAD_TOL = 2e-5  # tests/test_kernels.py's fp32 tolerance, scaled to each leaf


def tiny_cfg(pkg_cfg, **kw):
    base = dict(name="tiny", arch_type="dense", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab=64, dtype="float32")
    base.update(kw)
    return pkg_cfg(**base)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    """{path: numpy} of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v.detach().float().numpy() if isinstance(v, torch.Tensor) else \
                np.asarray(v, np.float32)
    return out


def assert_scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


# ---------------------------------------------------------------------------
# AdamW: tests/test_training.py's optimizer tests, in the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start", [[5.0, -3.0], [-2.0, 4.0]])
def test_adamw_reduces_quadratic(start):
    w = {"w": torch.tensor(start)}
    state = topt.init(w)
    cfg = topt.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=1, total_steps=200,
                           clip_norm=None, schedule="constant")
    for _ in range(150):
        w, state, _ = topt.apply(cfg, {"w": 2 * w["w"]}, state, w)
    assert float(w["w"].abs().max()) < 0.05


@pytest.mark.parametrize("big", [1e6, 3e4])
def test_grad_clip_bounds_update(big):
    w = {"w": torch.ones(4)}
    cfg = topt.AdamWConfig(lr=1e-3, clip_norm=1.0, weight_decay=0.0)
    _, _, metrics = topt.apply(cfg, {"w": torch.full((4,), big)}, topt.init(w), w)
    assert float(metrics["grad_norm"]) > big  # the raw norm is reported


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_lr_schedule_shapes(schedule):
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1,
                           schedule=schedule)
    lrs = [float(topt.lr_at(cfg, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0
    assert lrs[99] == pytest.approx(0.1, abs=0.02)
    assert max(lrs) <= 1.0 + 1e-6


@pytest.mark.parametrize("steps", [1, 2, 7, 18, 33, 50])
def test_lr_monotone_after_warmup(steps):
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=5, total_steps=60)
    a = float(topt.lr_at(cfg, torch.tensor(5 + steps // 2)))
    b = float(topt.lr_at(cfg, torch.tensor(5 + steps)))
    assert b <= a + 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moment_dtype(dtype):
    state = topt.init({"w": torch.ones(4, dtype=torch.bfloat16)}, moment_dtype=dtype)
    assert state.m["w"].dtype == dtype and state.v["w"].dtype == dtype
    assert state.step.dtype == torch.int32 and int(state.step) == 0


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_the_reference(schedule):
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=40, min_lr_ratio=0.2, schedule=schedule)
    for s in range(0, 45, 3):
        want = float(jopt.lr_at(jopt.AdamWConfig(**cfg), jnp.asarray(s)))
        assert float(topt.lr_at(topt.AdamWConfig(**cfg), torch.tensor(s))) == \
            pytest.approx(want, rel=1e-6)


def opt_tree(rs, dtype):
    """A param-like tree: matrices (decayed) and vectors (not)."""
    shapes = {"embed": (12, 8), "layers": {"wq": (2, 8, 8), "ln": (2, 8)}, "final_norm": (8,)}

    def draw(node):
        return {k: draw(v) if isinstance(v, dict) else
                (rs.standard_normal(v) * 0.5).astype(np.float32) for k, v in node.items()}
    return draw(shapes)


@pytest.mark.parametrize("case", ["fp32", "fp32-no-clip", "bf16-moments"])
def test_apply_matches_the_reference(case):
    """Three steps of ``apply`` on identical numpy gradients: params,
    moments and metrics equal to 1e-6 relative in fp32 (to one bf16 ulp
    where the moments are bf16)."""
    rs = np.random.default_rng(11)
    params = opt_tree(rs, np.float32)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               clip_norm=None if case == "fp32-no-clip" else 0.5)
    mdt = (jnp.bfloat16, torch.bfloat16) if case == "bf16-moments" else (jnp.float32, torch.float32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = jopt.init(jp, moment_dtype=mdt[0]), topt.init(tp, moment_dtype=mdt[1])
    tol = 2 ** -7 if case == "bf16-moments" else 1e-6
    for _ in range(3):
        grads = opt_tree(rs, np.float32)
        jp, js, jm_ = jopt.apply(jopt.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm_ = topt.apply(topt.AdamWConfig(**cfg),
                                 jax.tree.map(torch.from_numpy, grads), ts, tp)
        assert int(ts.step) == int(js.step)
        for key in ("grad_norm", "lr"):
            assert float(tm_[key]) == pytest.approx(float(jm_[key]), rel=1e-6)
        for what, got, want in (("params", tp, jp), ("m", ts.m, js.m), ("v", ts.v, js.v)):
            g, w = flat(got), flat(to_numpy(want))
            for path in w:
                np.testing.assert_allclose(g[path], w[path], rtol=tol, atol=1e-12,
                                           err_msg=f"{what}/{path}")


def test_apply_updates_a_param_tree_in_place():
    cfg = tm.ModelConfig(name="t", arch_type="dense", n_layers=2, d_model=16, n_heads=2,
                         n_kv_heads=1, d_ff=32, vocab=32, dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    state = topt.init(params)
    grads = topt.map_tree(torch.ones_like, params)
    out, state, _ = topt.apply(topt.AdamWConfig(lr=1e-2, warmup_steps=1), grads, state, params)
    assert out is params and int(state.step) == 1
    assert all(not torch.equal(p, before[n]) for n, p in params.named_parameters())
    assert [k for k, _ in topt.leaves(params)] == [k for k, _ in topt.leaves(state.m)]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def tiny_pair(seed=3):
    rcfg, cfg = tiny_cfg(jm.ModelConfig), tiny_cfg(tm.ModelConfig)
    jp = jm.init_params(rcfg, jax.random.key(seed))
    return rcfg, cfg, jp, tm.params_from_numpy(to_numpy(jp), cfg, "cpu")


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip(tmp_path, moments):
    _, cfg, _, params = tiny_pair()
    state = topt.init(params, moment_dtype=moments)
    state.m["embed"].add_(1.5)
    path = os.path.join(tmp_path, "ck")
    tckpt.save(path, {"p": params, "o": state}, metadata={"step": 7})
    restored, meta = tckpt.restore(path, {"p": params, "o": state})
    assert meta["step"] == 7
    for (n, got), (_, want) in zip(topt.leaves(restored["p"]), topt.leaves(params)):
        assert torch.equal(got, want), n
    assert torch.equal(restored["o"]["m"]["embed"], state.m["embed"])
    assert restored["o"]["m"]["embed"].dtype == moments
    manifest = json.load(open(path + ".json"))
    assert manifest["leaves"]["o/step"] == {"shape": [], "dtype": "int32"}
    assert "p/layers/mlp/wg" in manifest["leaves"]


@pytest.mark.parametrize("bad", ["shape", "missing"])
def test_checkpoint_refusals(tmp_path, bad):
    path = os.path.join(tmp_path, "ck2")
    tckpt.save(path, {"w": torch.ones(3)})
    if bad == "shape":
        with pytest.raises(ValueError, match="shape mismatch"):
            tckpt.restore(path, {"w": torch.ones(4)})
    else:
        with pytest.raises(KeyError, match="checkpoint missing leaf"):
            tckpt.restore(path, {"w": torch.ones(3), "u": torch.ones(3)})


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages_in_fp32(tmp_path, writer):
    """params and AdamW state written by one package restore in the other."""
    _, cfg, jp, tp = tiny_pair()
    js = jopt.init(jp)
    js = js._replace(step=jnp.asarray(4, jnp.int32),
                     m=jax.tree.map(lambda x: x * 0.5, jp), v=jax.tree.map(jnp.square, jp))
    ts = adamw_state_from_numpy(np.asarray(js.step), to_numpy(js.m), to_numpy(js.v), cfg, "cpu")
    path = os.path.join(tmp_path, "cross")
    if writer == "reference":
        jckpt.save(path, {"params": jp, "opt": js._asdict()}, metadata={"steps": 4})
        got, meta = tckpt.restore(path, {"params": tp, "opt": ts})
        want = {"params": flat(to_numpy(jp)), "opt": flat(to_numpy(js._asdict()))}
        got = {"params": flat(got["params"]), "opt": flat(got["opt"])}
    else:
        tckpt.save(path, {"params": tp, "opt": ts}, metadata={"steps": 4})
        got, meta = jckpt.restore(path, {"params": jp, "opt": js._asdict()})
        want = {"params": flat(topt.map_tree(lambda t: t, tp)), "opt": flat(ts._asdict())}
        got = {"params": flat(to_numpy(got["params"])), "opt": flat(to_numpy(got["opt"]))}
    assert meta == {"steps": 4}
    for part in ("params", "opt"):
        assert sorted(got[part]) == sorted(want[part])
        for key in want[part]:
            np.testing.assert_array_equal(got[part][key], want[part][key], err_msg=key)


def test_port_restores_a_bf16_checkpoint_of_the_reference_bit_for_bit(tmp_path):
    """The reference writes bf16 leaves as raw 2-byte records (and cannot
    read them back itself); the port restores them bit for bit."""
    rcfg = dataclasses.replace(tiny_cfg(jm.ModelConfig), dtype="bfloat16")
    cfg = dataclasses.replace(tiny_cfg(tm.ModelConfig), dtype="bfloat16")
    jp = jm.init_params(rcfg, jax.random.key(5))
    js = jopt.init(jp, moment_dtype=jnp.bfloat16)
    js = js._replace(m=jax.tree.map(lambda x: x * 3, jp))
    path = os.path.join(tmp_path, "bf16")
    jckpt.save(path, {"params": jp, "opt": js._asdict()})
    with np.load(path + ".npz") as data:
        assert data["params/embed"].dtype.kind == "V" and data["params/embed"].dtype.itemsize == 2
    tp = tm.params_from_numpy(to_numpy(jp), cfg, "cpu")
    ts = topt.init(tp, moment_dtype=torch.bfloat16)
    got, _ = tckpt.restore(path, {"params": tp, "opt": ts})
    for (n, g), (_, w) in zip(topt.leaves(got["params"]), topt.leaves(tp)):
        assert g.dtype == torch.bfloat16 and torch.equal(g.view(torch.int16),
                                                         w.detach().view(torch.int16)), n
    want_m = tm.params_from_numpy(to_numpy(js.m), cfg, "cpu")
    for (n, g), (_, w) in zip(topt.leaves(got["opt"]["m"]), topt.leaves(want_m)):
        assert torch.equal(g.view(torch.int16), w.detach().view(torch.int16)), n


def test_adamw_state_converter_checks_the_layout():
    rcfg, cfg, jp, _ = tiny_pair()
    js = jopt.init(jp)
    ts = adamw_state_from_numpy(np.asarray(js.step), to_numpy(js.m), to_numpy(js.v), cfg, "cpu")
    assert int(ts.step) == 0 and ts.m["layers"]["wq"].shape == (2, 32, 32)
    bad = to_numpy(js.m)
    bad["layers"]["wq"] = np.zeros((2, 32, 31), np.float32)
    with pytest.raises(ValueError, match="m.layers.wq"):
        adamw_state_from_numpy(0, bad, to_numpy(js.v), cfg, "cpu")


# ---------------------------------------------------------------------------
# gradients of next_token_loss, every family
# ---------------------------------------------------------------------------
def family_batch(cfg, b=2, s=16, seed=0):
    rs = np.random.default_rng(seed)
    batch = {"tokens": rs.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = (rs.standard_normal((b, 9, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["audio_frames"] = (rs.standard_normal((b, cfg.n_audio_frames, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return batch


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_loss_gradients_match_jax_value_and_grad(name, remat):
    """The counterpart of tests/test_archs.py's train step: loss and every
    leaf's gradient of ``next_token_loss`` against ``jax.value_and_grad``,
    reduced fp32 configs, the reference's weights, sorted MoE dispatch."""
    rcfg, cfg = REF_ARCHS[name].reduced(dtype="float32"), ARCHS[name].reduced(dtype="float32")
    jp = jm.init_params(rcfg, jax.random.key(1))
    tp = tm.params_from_numpy(to_numpy(jp), cfg, "cpu")
    batch = family_batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.next_token_loss(p, jax.tree.map(jnp.asarray, batch), rcfg)))(jp)
    tp.requires_grad_(True)
    loss = tm.next_token_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                              remat=remat)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    want = flat(to_numpy(jgrads))
    got = {n.replace(".", "/"): p.grad.numpy() for n, p in tp.named_parameters()}
    assert sorted(got) == sorted(want)
    for path in want:
        assert_scaled(got[path], want[path], GRAD_TOL, f"{name} {path}")


def test_layer_views_accumulate_into_one_grad_per_stacked_leaf():
    """Per-layer views (``layer(i)`` and ``unstack()``) give the stacked
    leaf one ``.grad`` whose slice i is layer i's gradient."""
    cfg = ARCHS["mistral-nemo-12b"].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    params.requires_grad_(True)
    coef = torch.arange(1.0, cfg.n_layers + 1)
    sum(coef[i] * params["layers"].layer(i)["mlp"]["wg"].sum() for i in range(cfg.n_layers)) \
        .backward()
    by_layer = params["layers"]["mlp"]["wg"].grad.clone()
    params.zero_grad(set_to_none=True)
    sum(coef[i] * layer["mlp"]["wg"].sum()
        for i, layer in enumerate(params["layers"].unstack())).backward()
    grad = params["layers"]["mlp"]["wg"].grad
    assert torch.equal(grad, by_layer)
    for i in range(cfg.n_layers):
        assert torch.equal(grad[i], torch.full_like(grad[i], float(coef[i])))


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["tiny", "mistral-nemo-12b", "whisper-medium"])
def test_train_step_matches_the_reference(name, remat):
    """Three steps of both packages' ``make_train_step`` from the same
    params and AdamW state (converted from the reference's): loss and
    grad-norm.  The first step's agree to fp32 rounding; later ones to
    1e-3, the params having moved apart by AdamW's sign-like first step."""
    if name == "tiny":
        rcfg, cfg = tiny_cfg(jm.ModelConfig), tiny_cfg(tm.ModelConfig)
    else:
        rcfg, cfg = REF_ARCHS[name].reduced(dtype="float32"), ARCHS[name].reduced(dtype="float32")
    jp = jm.init_params(rcfg, jax.random.key(6))
    js = jopt.init(jp)
    tp = tm.params_from_numpy(to_numpy(jp), cfg, "cpu")
    ts = adamw_state_from_numpy(np.asarray(js.step), to_numpy(js.m), to_numpy(js.v), cfg, "cpu")
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstep, _ = ref_train_step(rcfg, make_debug_mesh(), jopt.AdamWConfig(**ocfg), remat=remat)
    jstep = jax.jit(jstep)
    tstep = make_train_step(cfg, topt.AdamWConfig(**ocfg), remat=remat, device="cpu")
    for i in range(3):
        batch = family_batch(cfg, seed=10 + i)
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tmet = tstep(tp, ts, batch)
        rel = 1e-5 if i == 0 else 1e-3
        for key in ("loss", "grad_norm", "lr"):
            assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=rel), (i, key)
        assert int(ts.step) == int(js.step) == i + 1


@pytest.mark.parametrize("name", ALL)
def test_train_step_runs_for_every_family(name):
    """The counterpart of tests/test_archs.py::test_smoke_train_step: one
    step of every family on the CPU, through the plain twins of all four
    kernels; finite loss and grad norm, the step counted, every param
    moved."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    step = make_train_step(cfg, topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                           device="cpu")
    params, state, m = step(params, topt.init(params), family_batch(cfg))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert int(state.step) == 1
    assert max(float((p.detach() - before[n]).abs().max())
               for n, p in params.named_parameters()) > 0


def test_grad_accumulation_matches_full_batch():
    """accum_steps=4 over batch 8 equals one step over the full batch (the
    counterpart of tests/test_training.py's): same loss, ~same update."""
    cfg = tiny_cfg(tm.ModelConfig)
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab, (8, 16)).astype(np.int32)}
    ocfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.0)
    outs = {}
    for accum in (1, 4):
        params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, ocfg, accum_steps=accum, remat=False, device="cpu")
        params, _, m = step(params, topt.init(params), batch)
        outs[accum] = ({n: p.detach().clone() for n, p in params.named_parameters()},
                       float(m["loss"]), float(m["grad_norm"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-5)
    assert outs[1][2] == pytest.approx(outs[4][2], rel=1e-5)
    assert max(float((outs[1][0][n] - outs[4][0][n]).abs().max()) for n in outs[1][0]) < 1e-5


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "zamba2-7b", "qwen3-moe-30b-a3b",
                                  "whisper-medium"])
def test_remat_gives_the_same_loss_and_gradients(name):
    cfg = ARCHS[name].reduced(dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in family_batch(cfg, seed=4).items()}
    params = tm.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    params.requires_grad_(True)
    runs = {}
    for remat in (False, True):
        loss = tm.next_token_loss(params, batch, cfg, remat=remat)
        loss.backward()
        runs[remat] = (float(loss.detach()), {n: p.grad.clone() for n, p in params.named_parameters()})
        params.zero_grad(set_to_none=True)
    assert runs[True][0] == runs[False][0]
    for n, g in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][n], g, atol=1e-7, rtol=1e-6)


def test_train_step_validates_its_arguments():
    cfg = tiny_cfg(tm.ModelConfig)
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(cfg, accum_steps=0, device="cpu")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, device="meta")
    with pytest.raises(ValueError, match="params are on"):
        step(params, topt.init(params), {"tokens": np.zeros((2, 4), np.int32)})


@pytest.mark.parametrize("factory", ["train", "serve"])
def test_step_factories_refuse_a_missing_card(factory):
    """Like every entry point of the port, the factories run on the card
    unless asked for the CPU, and raise where there is none."""
    from repro_torch.training import make_serve_step

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        (make_train_step if factory == "train" else make_serve_step)(tiny_cfg(tm.ModelConfig))


def test_serve_step_is_decode_step():
    from repro_torch.training import make_serve_step

    cfg = ARCHS["mistral-nemo-12b"].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.tensor([3, 5])
    step = make_serve_step(cfg, device="cpu")
    a, ca = step(params, tm.init_cache(cfg, 2, 8, device="cpu"), toks)
    b, cb = tm.decode_step(params, tm.init_cache(cfg, 2, 8, device="cpu"), toks, cfg)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"]) and int(ca["pos"][0]) == 1


# ---------------------------------------------------------------------------
# data pipeline and example
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("host_id,n_hosts,prefetch", [(0, 1, 2), (1, 2, 0), (0, 2, 1)])
def test_data_pipeline_yields_the_references_batches(host_id, n_hosts, prefetch):
    kw = dict(vocab=97, seq_len=24, global_batch=4, seed=3)
    ours = make_pipeline(DataConfig(**kw), host_id, n_hosts, prefetch)
    theirs = ref_pipeline(RefDataConfig(**kw), host_id, n_hosts, prefetch)
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert a["tokens"].dtype == np.int32 and a["tokens"].shape == (4 // n_hosts, 24)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticTokens(DataConfig(vocab=8, seq_len=4, global_batch=3), n_hosts=2)


def test_train_small_example_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_small

    train_small.main(["--steps", "3", "--d-model", "32", "--layers", "2", "--batch", "4",
                      "--seq", "16", "--vocab", "64", "--device", "cpu",
                      "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("model: ")
    assert "step    0  loss" in out and "step    2  loss" in out
    assert "checkpoint round-trip OK (saved at step 3)" in out
    assert os.path.exists(tmp_path / "ck.npz")
