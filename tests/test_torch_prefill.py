"""The port's full-sequence path against ``repro.models``: ``gqa_attention``
and ``mamba2_block`` on the same numpy inputs, and ``forward`` logits and
``next_token_loss`` of the reduced fp32 serve-example trio with
JAX-initialised weights carried over by ``params_from_numpy``; plus the
port's own forward against its teacher-forced decode, and
``make_prefill_step`` on the CPU.  The hybrid, VLM and audio families are
held in ``test_torch_families.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.training import make_prefill_step  # noqa: E402

TRIO = ["mamba2-780m", "mistral-nemo-12b", "granite-20b"]
MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]  # forward parity: test_torch_moe.py
# fp32 logits agree to ~1e-6; 1e-4 (as the decode tests use) leaves room
# for the two packages' different summation orders in the matmuls.
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
PORT_IMPLS = ("auto", "ref", "ref_chunked")


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


def tokens(cfg, b=2, s=40, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("h,kh,window", [(4, 2, None), (6, 1, None), (4, 4, 8)])
def test_gqa_attention(impl, h, kh, window):
    b, s, d, hd = 2, 24, 32, 8
    x, wq, wk, wv, wo = draw(1, (b, s, d), (d, h * hd), (d, kh * hd), (d, kh * hd),
                             (h * hd, d), scale=0.5)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jp, tp = both({"wq": wq, "wk": wk, "wv": wv, "wo": wo})
    jx, tx = both(x)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, theta=1e4, window=window)
    got, (gk, gv) = tl.gqa_attention(tx, tp, torch.from_numpy(pos.copy()), impl=impl, **kw)
    want, (wk_, wv_) = jl.gqa_attention(jx, jp, jnp.asarray(pos), **kw)
    assert got.shape == (b, s, d) and gk.shape == (b, s, kh, hd)
    close(got, want)
    close(gk, wk_)
    close(gv, wv_)


@pytest.mark.parametrize("impl", PORT_IMPLS + ("ref_sequential",))
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block(impl, with_state):
    cfg = ARCHS["mamba2-780m"].reduced(dtype="float32")
    rcfg = REF_ARCHS["mamba2-780m"].reduced(dtype="float32")
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
    proj = 2 * di + 2 * cfg.ssm_groups * n + h
    c = tssm.conv_channels(cfg)
    x, w_in, conv_w, conv_b, w_out = draw(
        2, (2, 37, d), (d, proj), (cfg.conv_kernel, c), (c,), (di, d), scale=0.2)
    dt_bias, a_log, d_skip = draw(3, (h,), (h,), (h,), scale=0.5)
    (state,) = draw(4, (2, h, cfg.ssm_head_dim, n))
    jp, tp = both({"w_in": w_in, "conv_w": conv_w, "conv_b": conv_b, "w_out": w_out,
                   "dt_bias": dt_bias, "a_log": a_log, "d_skip": d_skip})
    jx, tx = both(x)
    js, ts = both(state) if with_state else (None, None)
    y, st = tssm.mamba2_block(tx, tp, cfg, initial_state=ts, impl=impl)
    ye, ste = jssm.mamba2_block(jx, jp, rcfg, initial_state=js)
    assert y.shape == (2, 37, d) and st.dtype == torch.float32
    close(y, ye)
    close(st, ste, atol=1e-5, rtol=1e-4)


def test_causal_conv():
    x, w, bias = draw(5, (2, 9, 6), (4, 6), (6,))
    (jx, tx), (jw, tw), (jb, tb) = both(x), both(w), both(bias)
    close(tssm._causal_conv(tx, tw, tb), jssm._causal_conv(jx, jw, jb))


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("name", TRIO)
def test_forward_and_loss_match_reference(name, impl):
    cfg, rcfg, tp, jp = pair(name)
    toks = tokens(cfg)
    jlogits, jaux = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, rcfg))(jp, jnp.asarray(toks))
    jloss = jax.jit(lambda p, t: jm.next_token_loss(p, {"tokens": t}, rcfg))(jp, jnp.asarray(toks))
    batch = {"tokens": torch.from_numpy(toks)}
    logits, aux = tm.forward(tp, batch, cfg, impl=impl)
    assert logits.shape == (2, 40, cfg.vocab) and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    loss = tm.next_token_loss(tp, batch, cfg, impl=impl)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "granite-20b"])
def test_forward_with_a_window_matches_reference(name):
    cfg, rcfg, tp, jp = pair(name)
    toks = tokens(cfg, s=30, seed=1)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, rcfg, window=8)
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", TRIO)
def test_forward_last_position_matches_teacher_forced_decode(name):
    """The port against itself: the forward's logits at the last position
    equal decode_step's after the same tokens fed one at a time."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(tokens(cfg, s=33, seed=2))
    logits, _ = tm.forward(params, {"tokens": toks}, cfg)
    cache = tm.init_cache(cfg, 2, 33, device="cpu")
    for i in range(33):
        step, cache = tm.decode_step(params, cache, toks[:, i], cfg)
        torch.testing.assert_close(step, logits[:, i], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", TRIO + MOE)
def test_prefill_step_on_the_cpu(name):
    cfg, rcfg, tp, jp = pair(name)
    toks = tokens(cfg, s=20, seed=3)
    step = make_prefill_step(cfg, device="cpu")
    got = step(tp, {"tokens": toks})  # numpy tokens are moved to the device
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_step_refuses_a_missing_card_and_misplaced_params():
    cfg = ARCHS["granite-20b"].reduced(dtype="float32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_prefill_step(cfg)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_prefill_step(cfg, device="meta")
    with pytest.raises(ValueError, match="params are on"):
        step(params, {"tokens": np.zeros((1, 4), np.int32)})
