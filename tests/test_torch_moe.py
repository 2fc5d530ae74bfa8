"""The port's MoE family against ``repro``: routing, the grouped matmul's
oracle and plain twin (against the JAX oracle and the Pallas kernel in
interpret mode), the ``scan`` and ``sorted`` dispatches with and without
shared experts, MLA, and the reduced fp32 Qwen3-MoE and DeepSeek-V2 through
``forward``, ``next_token_loss``, ``decode_step`` and the serving engine,
all on the same numpy inputs and JAX-initialised weights."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import ExecutionEngine as RefEngine  # noqa: E402
from repro.serving import HostedModel as RefHosted  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import ExecutionEngine, HostedModel  # noqa: E402
from repro_torch.training import make_prefill_step  # noqa: E402

MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]
# fp32 logits agree to ~1e-6; 1e-4 (as the dense and SSM tests use) leaves
# room for the two packages' different summation orders in the matmuls.
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
GMM_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_kernels.py's GMM tolerance


def draw(seed, *shapes, scale=1.0):
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def both(tree):
    if isinstance(tree, dict):
        pairs = {k: both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or LAYER_TOL))


def pair(name, **overrides):
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(dtype="float32"), **overrides)
    cfg = dataclasses.replace(ARCHS[name].reduced(dtype="float32"), **overrides)
    jp = jm.init_params(rcfg, jax.random.key(1))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, rcfg, tp, jp


def tokens(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,d,e,k", [(16, 32, 4, 2), (37, 64, 128, 8), (1, 16, 8, 1)])
def test_route_matches_reference(t, d, e, k):
    x, w = draw(1, (t, d), (d, e))
    (jx, tx), (jw, tw) = both(x), both(w)
    gates, idx, aux = tmoe.route(tx, tw, k)
    jg, ji, ja = jmoe.route(jx, jw, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    close(gates, jg, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(ja), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------------
def _sizes(t, e, seed):
    rs = np.random.RandomState(seed)
    cuts = np.sort(rs.randint(0, t + 1, size=e - 1))
    return np.diff(np.concatenate([[0], cuts, [t]])).astype(np.int32)


# tests/test_kernels.py::test_moe_gmm_matches_oracle's cases (with its
# Pallas blocks), its empty-groups case, a trailing empty group and the
# Qwen3-MoE expert count at small widths
GMM_CASES = [
    (50, 64, 48, 4, 16, 16, None),
    (128, 32, 32, 8, 32, 32, None),
    (17, 16, 64, 3, 8, 16, None),        # ragged everything
    (64, 128, 96, 1, 64, 48, None),      # single expert == plain matmul
    (20, 16, 8, 5, 8, 8, [0, 20, 0, 0, 0]),
    (30, 24, 40, 4, 8, 8, [10, 0, 20, 0]),  # trailing empty group
    (96, 32, 48, 128, 8, 16, None),      # 128 experts, most of them empty
]


@pytest.mark.parametrize("t,din,dout,e,block_t,block_n,sizes", GMM_CASES)
def test_moe_gmm_ref_and_plain_match_oracle_and_pallas(t, din, dout, e, block_t, block_n, sizes):
    x, w = draw(6, (t, din), (e, din, dout))
    gs = np.asarray(sizes if sizes is not None else _sizes(t, e, e), np.int32)
    (jx, tx), (jw, tw), (jg, tg) = both(x), both(w), both(gs)
    oracle = jref.moe_gmm_ref(jx, jw, jg)
    pallas = pallas_gmm(jx, jw, jg, block_t=block_t, block_n=block_n, interpret=True)
    for got in (tref.moe_gmm_ref(tx, tw, tg), gmm.moe_gmm_plain(tx, tw, tg),
                gmm.moe_gmm(tx, tw, tg), ops.moe_gmm(tx, tw, tg, impl="ref")):
        assert got.shape == (t, dout) and got.dtype == torch.float32
        close(got, oracle, **GMM_TOL)
        close(got, pallas, **GMM_TOL)


def test_moe_gmm_rows_past_the_sizes_go_to_the_last_expert():
    """The JAX oracle's row assignment: row r belongs to the last expert
    whose group starts at or before r, so rows past the sizes' sum are the
    last expert's even when its group is empty."""
    x, w = draw(7, (12, 8), (3, 8, 4))
    gs = np.array([4, 5, 0], np.int32)
    want = jref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    (_, tx), (_, tw), (_, tg) = both(x), both(w), both(gs)
    close(tref.moe_gmm_ref(tx, tw, tg), want, **GMM_TOL)
    close(gmm.moe_gmm_plain(tx, tw, tg), want, **GMM_TOL)
    assert tref.group_bounds(tg, 12) == ([0, 4, 9], [4, 9, 12])


def test_moe_gmm_bf16_plain_rounds_once():
    """The plain twin computes in fp32 and rounds once to bf16, as the
    kernel does; the oracle multiplies in bf16 as the JAX oracle does."""
    x, w = draw(8, (40, 64), (4, 64, 32))
    gs = torch.tensor([10, 0, 25, 5], dtype=torch.int32)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = gmm.moe_gmm_plain(tx, tw, gs)
    want = tref.moe_gmm_ref(tx.float(), tw.float(), gs).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    jwant = jref.moe_gmm_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(gs.numpy()))
    close(tref.moe_gmm_ref(tx, tw, gs), jwant, atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------
def _ffn_params(d, e, f, shared, seed=2):
    names = {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f), "wd": (e, f, d)}
    if shared:
        names.update(shared_wg=(d, f * shared), shared_wu=(d, f * shared),
                     shared_wd=(f * shared, d))
    arrs = draw(seed, *names.values(), scale=0.2)
    return both(dict(zip(names, arrs)))


@pytest.mark.parametrize("ref_impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("dispatch", ["scan", "sorted"])
def test_moe_ffn_matches_reference(dispatch, shared, ref_impl):
    b, s, d, e, f, k = 2, 9, 32, 8, 24, 2
    jp, tp = _ffn_params(d, e, f, shared)
    (jx, tx), = [both(x) for x in draw(3, (b, s, d))]
    y, aux = tmoe.moe_ffn(tx, tp, top_k=k, dispatch=dispatch)
    ye, auxe = jmoe.moe_ffn(jx, jp, top_k=k, dispatch=dispatch, impl=ref_impl)
    assert y.shape == (b, s, d)
    close(y, ye)
    np.testing.assert_allclose(float(aux), float(auxe), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("ref_impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("shared", [0, 2])
def test_moe_scan_matches_reference_in_bf16(shared, ref_impl):
    """The scan dispatch, which serving decodes with, in bf16 at the
    reference's bf16 tolerance.  The reference adds the experts one by one
    in x's dtype; the port sums them in fp32 and rounds once, which moves
    outputs by about one bf16 ulp."""
    b, s, d, e, f, k = 2, 9, 32, 8, 24, 2
    jp, tp = _ffn_params(d, e, f, shared)
    jp = {n: w if n == "router" else w.astype(jnp.bfloat16) for n, w in jp.items()}
    tp = {n: w if n == "router" else w.to(torch.bfloat16) for n, w in tp.items()}
    (x,) = draw(3, (b, s, d))
    y, aux = tmoe.moe_ffn(torch.from_numpy(x).to(torch.bfloat16), tp, top_k=k, dispatch="scan")
    ye, auxe = jmoe.moe_ffn(jnp.asarray(x, jnp.bfloat16), jp, top_k=k, dispatch="scan",
                            impl=ref_impl)
    assert y.dtype == torch.bfloat16
    close(y, ye, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(float(aux), float(auxe), atol=1e-6, rtol=1e-6)


def test_moe_dispatches_agree_and_ep_names_its_roadmap_item():
    jp, tp = _ffn_params(16, 4, 8, 1)
    (tx,) = [torch.from_numpy(x) for x in draw(4, (1, 5, 16))]
    scan, _ = tmoe.moe_ffn(tx, tp, top_k=2, dispatch="scan")
    for impl in ("auto", "ref"):
        sorted_, _ = tmoe.moe_ffn(tx, tp, top_k=2, dispatch="sorted", impl=impl)
        torch.testing.assert_close(sorted_, scan, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="requires a mesh"):  # as the reference's does
        tmoe.moe_ffn(tx, tp, top_k=2, dispatch="ep")
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_ffn(tx, tp, top_k=2, dispatch="dense")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
MLA_DIMS = dict(n_heads=4, head_dim=16, rope_head_dim=8, theta=1e4, norm_eps=1e-6)


def _mla_params(d=32, ql=24, kvl=20, seed=5):
    h, hd, rd = MLA_DIMS["n_heads"], MLA_DIMS["head_dim"], MLA_DIMS["rope_head_dim"]
    shapes = {"wq_a": (d, ql), "wq_b": (ql, h * (hd + rd)), "wkv_a": (d, kvl + rd),
              "wkv_b": (kvl, h * 2 * hd), "wo": (h * hd, d), "q_norm": (ql,), "kv_norm": (kvl,)}
    arrs = dict(zip(shapes, draw(seed, *shapes.values(), scale=0.3)))
    arrs["q_norm"] = 1 + arrs["q_norm"]
    arrs["kv_norm"] = 1 + arrs["kv_norm"]
    return both(arrs)


@pytest.mark.parametrize("impl", ["auto", "ref", "ref_chunked"])
@pytest.mark.parametrize("window", [None, 5])
def test_mla_attention_matches_reference(impl, window):
    jp, tp = _mla_params()
    (jx, tx), = [both(x) for x in draw(6, (2, 13, 32))]
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    out, (ckv, krope) = tmla.mla_attention(tx, tp, torch.from_numpy(pos.copy()),
                                           window=window, impl=impl, **MLA_DIMS)
    want, (jckv, jkrope) = jmla.mla_attention(jx, jp, jnp.asarray(pos), window=window,
                                              **MLA_DIMS)
    assert out.shape == (2, 13, 32)
    close(out, want)
    close(ckv, jckv)
    close(krope, jkrope)


@pytest.mark.parametrize("impl", ["auto", "ref", "ref_grouped"])
@pytest.mark.parametrize("cache_update", ["scatter", "onehot"])
def test_mla_decode_attention_matches_reference(impl, cache_update):
    jp, tp = _mla_params()
    b, cap = 2, 10
    jc = (jnp.zeros((b, cap, 20)), jnp.zeros((b, cap, 8)))
    tc = (torch.zeros(b, cap, 20), torch.zeros(b, cap, 8))
    xs = draw(7, *[(b, 32)] * 6)
    for step, x in enumerate(xs):
        pos = np.array([step, step], np.int32)
        n = pos + 1
        out, tc = tmla.mla_decode_attention(
            torch.from_numpy(x), tp, torch.from_numpy(pos), *tc, torch.from_numpy(n),
            torch.from_numpy(pos), impl=impl, cache_update=cache_update, **MLA_DIMS)
        want, jc = jmla.mla_decode_attention(
            jnp.asarray(x), jp, jnp.asarray(pos), *jc, jnp.asarray(n), jnp.asarray(pos),
            cache_update=cache_update, **MLA_DIMS)
        close(out, want)
    close(tc[0], jc[0])
    close(tc[1], jc[1])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl,dispatch", [("auto", "sorted"), ("ref", "sorted"),
                                           ("auto", "scan")])
@pytest.mark.parametrize("name", MOE)
def test_forward_and_loss_match_reference(name, impl, dispatch):
    cfg, rcfg, tp, jp = pair(name)
    toks = tokens(cfg)
    fwd = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, rcfg, moe_dispatch=dispatch))
    loss = jax.jit(lambda p, t: jm.next_token_loss(p, {"tokens": t}, rcfg,
                                                   moe_dispatch=dispatch))
    jlogits, jaux = fwd(jp, jnp.asarray(toks))
    batch = {"tokens": torch.from_numpy(toks)}
    logits, aux = tm.forward(tp, batch, cfg, impl=impl, moe_dispatch=dispatch)
    assert logits.shape == (2, 24, cfg.vocab) and float(aux) > 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    got = tm.next_token_loss(tp, batch, cfg, impl=impl, moe_dispatch=dispatch)
    np.testing.assert_allclose(float(got), float(loss(jp, jnp.asarray(toks))), **TOL)


@pytest.mark.parametrize("dispatch", ["sorted", "scan"])
@pytest.mark.parametrize("name", MOE)
def test_decode_logits_match_reference(name, dispatch):
    cfg, rcfg, tp, jp = pair(name)
    steps, batch, capacity = 21, 2, 24
    toks = tokens(cfg, s=steps, seed=1)
    jcache = jm.init_cache(rcfg, batch, capacity)
    tcache = tm.init_cache(cfg, batch, capacity, device="cpu")
    jstep = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, rcfg, moe_dispatch=dispatch))
    for i in range(steps):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i]))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, i]), cfg,
                                    moe_dispatch=dispatch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{name} step {i}")
    assert set(tcache) == set(jcache)
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", MOE)
def test_forward_last_position_matches_teacher_forced_decode(name):
    """The port against itself: every position of the forward's logits
    equals decode_step's after the same tokens fed one at a time."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(tokens(cfg, s=17, seed=2))
    logits, _ = tm.forward(params, {"tokens": toks}, cfg)
    cache = tm.init_cache(cfg, 2, 17, device="cpu")
    for i in range(17):
        step, cache = tm.decode_step(params, cache, toks[:, i], cfg)
        torch.testing.assert_close(step, logits[:, i], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", MOE)
def test_prefill_step_passes_the_dispatch_through(name):
    """``make_prefill_step(moe_dispatch="scan")`` runs the scan dispatch
    (the sorted default is in test_torch_prefill.py)."""
    cfg, rcfg, tp, jp = pair(name)
    toks = tokens(cfg, s=12, seed=3)
    got = make_prefill_step(cfg, moe_dispatch="scan", device="cpu")(tp, {"tokens": toks})
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, rcfg, moe_dispatch="scan")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_engine_tokens_match_reference_engine():
    """One serving task on reduced Qwen3-MoE: the port's engine (scan
    dispatch, as the reference's) generates the reference engine's tokens."""
    cfg, rcfg, tp, jp = pair("qwen3-moe-30b-a3b")
    prompt = tokens(cfg, s=10, seed=4)
    want, _ = RefEngine({0: RefHosted(0, rcfg, jp)}, decode_tokens=5).run_task(0, prompt)
    engine = ExecutionEngine({0: HostedModel(0, cfg, tp, "cpu")}, decode_tokens=5, device="cpu")
    got, _ = engine.run_task(0, prompt)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (2, 5)
