"""The port's ``ep`` MoE dispatch and its mesh steps at (1, 1), in one
process (a one-process gloo group): ``ep`` against the reference's ``ep``
on ``make_debug_mesh()`` (logits at 2e-5, aux at rtol 1e-5, as
``tests/test_perf_variants.py`` holds it, and its MLA case), ``ep``'s
gradients against the ``sorted`` dispatch's (the reference's own ``ep``
gradient test fails under its JAX), the mesh steps against the mesh-less
ones, and the meshes and constants of ``repro_torch.launch.mesh``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import models as jm  # noqa: E402
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.core.netmodel import H100_CLUSTER  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402
from repro_torch.training import make_prefill_step, make_serve_step, make_train_step  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402


def moe_cfg(pkg, **kw):
    base = dict(name="moe-t", arch_type="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=0, vocab=97, n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
                dtype="float32")
    base.update(kw)
    return pkg.ModelConfig(**base)


MLA = dict(use_mla=True, n_kv_heads=4, kv_lora_rank=16, q_lora_rank=16, rope_head_dim=8)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_debug_mesh(device="cpu")


def pair(case, seed=0):
    kw = MLA if case == "mla" else {}
    rcfg, cfg = moe_cfg(jm, **kw), moe_cfg(tm, **kw)
    jp = jm.init_params(rcfg, jax.random.key(seed))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return rcfg, cfg, jp, tp


@pytest.mark.parametrize("case,shape,key", [("gqa", (2, 24), 1), ("mla", (1, 12), 3)])
def test_ep_matches_the_reference_ep(mesh, case, shape, key):
    rcfg, cfg, jp, tp = pair(case)
    toks = jax.random.randint(jax.random.key(key), shape, 0, rcfg.vocab)
    want, want_aux = jm.forward(jp, {"tokens": toks}, rcfg, moe_dispatch="ep",
                                mesh=ref_debug_mesh())
    with torch.no_grad():
        got, aux = tm.forward(tp, {"tokens": torch.as_tensor(np.array(toks))}, cfg,
                              moe_dispatch="ep", mesh=mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("case", ["gqa", "mla"])
def test_ep_gradients_match_the_sorted_dispatch(mesh, case):
    _, cfg, _, tp = pair(case)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)))
    tp.requires_grad_(True)
    grads = {}
    for dispatch in ("sorted", "ep"):
        tm.next_token_loss(tp, {"tokens": toks}, cfg, moe_dispatch=dispatch,
                           mesh=mesh if dispatch == "ep" else None).backward()
        grads[dispatch] = {n: p.grad.clone() for n, p in tp.named_parameters()}
        tp.zero_grad(set_to_none=True)
    assert grads["ep"]["layers.moe.wg"].abs().max() > 0
    for n, want in grads["sorted"].items():
        scale = max(float(want.abs().max()), 1e-30)
        assert float((grads["ep"][n] - want).abs().max()) <= 2e-5 * scale, n


def test_ep_needs_a_mesh_and_a_model_axis_that_divides_the_experts():
    _, cfg, _, tp = pair("gqa")
    x = torch.zeros((1, 4, cfg.d_model))
    layer = tp["layers"].layer(0)["moe"]
    with pytest.raises(ValueError, match="requires a mesh"):
        moe_ffn(x, layer, top_k=2, dispatch="ep")

    class ThreeWayModel:  # a (1, 3) mesh's shape, for the check alone
        mesh_dim_names = ("data", "model")
        shape = (1, 3)

        def get_local_rank(self, name):
            return 0

        def get_group(self, name):
            raise AssertionError("no collective before the check")

    with pytest.raises(ValueError, match="does not divide"):
        moe_ffn(x, layer, top_k=2, dispatch="ep", mesh=ThreeWayModel())


def test_mesh_train_step_with_ep_matches_the_mesh_less_sorted_step(mesh):
    """Three steps over DTensor params (the expert banks' blocks through
    ``Gathered.block``) against the one-device step: loss, grad norm and
    every param to fp32 rounding."""
    _, cfg, _, tp = pair("gqa", seed=4)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    plain = tm.params_from_numpy(_numpy_tree(tp), cfg, "cpu")
    sharded = sharding.shard_tree(tp, mesh, sharding.param_pspecs(mesh, tp, cfg))
    runs = {}
    for name, params, step in (
            ("plain", plain, make_train_step(cfg, ocfg, device="cpu")),
            ("mesh", sharded, make_train_step(cfg, ocfg, moe_dispatch="ep", mesh=mesh))):
        state = opt.init(params)
        rng = np.random.default_rng(9)
        out = []
        for _ in range(3):
            batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
            params, state, metrics = step(params, state, batch)
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        runs[name] = (out, dict(opt.leaves(sharding.gather_tree(params))))
    np.testing.assert_allclose(runs["mesh"][0], runs["plain"][0], rtol=1e-5)
    for path, want in runs["plain"][1].items():
        np.testing.assert_allclose(runs["mesh"][1][path].detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5, atol=1e-6, err_msg=path)


def _numpy_tree(params):
    out = {}
    for path, t in opt.leaves(params):
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t.detach().numpy().copy()
    return out


@pytest.mark.parametrize("case", ["dense", "moe-ep"])
def test_mesh_serve_and_prefill_steps_equal_the_mesh_less_ones(mesh, case):
    """At (1, 1) the gathers alias the storage, so the mesh steps give the
    mesh-less steps' logits bit for bit."""
    if case == "dense":
        cfg = tm.ModelConfig("d", "dense", 2, 64, 4, 2, 128, 97, dtype="float32")
        dispatch = "sorted"
    else:
        cfg, dispatch = moe_cfg(tm), "ep"
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    sharded = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg,
                                                                      serve=True))
    cache = tm.init_cache(cfg, 2, 12, device="cpu")
    mcache = sharding.shard_tree(tm.init_cache(cfg, 2, 12, device="cpu"), mesh,
                                 sharding.cache_pspecs(mesh, cache))
    plain = make_serve_step(cfg, device="cpu", moe_dispatch="sorted")
    meshed = make_serve_step(cfg, mesh=mesh, serve_layout=True, moe_dispatch=dispatch)
    tok = torch.ones(2, dtype=torch.int32)
    for _ in range(5):
        want, cache = plain(params, cache, tok)
        got, mcache = meshed(sharded, mcache, tok)
        assert torch.equal(got.full_tensor(), want)
        tok = want.argmax(-1).to(torch.int32)
    assert torch.equal(mcache["k"].full_tensor(), cache["k"])
    batch = {"tokens": torch.randint(0, 97, (2, 10), generator=torch.Generator().manual_seed(3))}
    pre = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
    got = make_prefill_step(cfg, mesh=mesh, moe_dispatch=dispatch)(pre, batch)
    assert torch.equal(got.full_tensor(), make_prefill_step(cfg, device="cpu")(params, batch))


def test_mesh_steps_refuse_params_that_are_not_sharded(mesh):
    cfg = tm.ModelConfig("d", "dense", 2, 64, 4, 2, 128, 97, dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    with pytest.raises(ValueError, match="shard_tree"):
        make_prefill_step(cfg, mesh=mesh)(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})


def test_meshes(mesh):
    assert dict(sharding.mesh_sizes(mesh)) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="every rank"):
        tmesh.make_debug_mesh(n_devices=2, device="cpu")


def test_debug_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_debug_mesh(device="cuda")


def test_h100_constants():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == H100_CLUSTER.network.bandwidth_bytes_per_s == 450e9
    assert tmesh.HBM_PER_CHIP == H100_CLUSTER.gpu_capacity_bytes == 80e9
