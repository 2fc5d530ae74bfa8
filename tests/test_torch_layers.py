"""The port's decode-path layers against ``repro.models`` on the same numpy
inputs, in fp32 at 1e-5 (bf16 where the cast order is the point)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def draw(seed, *shapes, scale=1.0):
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def both(tree, dtype="float32"):
    """A (nested dict of) numpy arrays as jnp and as torch, in ``dtype``."""
    if isinstance(tree, dict):
        pairs = {k: both(v, dtype) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    return (jnp.asarray(tree, getattr(jnp, dtype)),
            torch.from_numpy(np.array(tree)).to(getattr(torch, dtype)))


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_rms_norm(dtype, tol):
    x, w = draw(0, (3, 5, 64), (64,))
    (jx, jw), (tx, tw) = zip(both(x, dtype), both(w + 1.0, dtype))
    got, want = tl.rms_norm(tx, tw, 1e-5), jl.rms_norm(jx, jw, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_apply_rope(dtype, tol):
    (x,) = draw(1, (2, 3, 4, 32))
    pos = np.array([[0, 7, 300], [5, 6, 70000]], np.int32)
    jx, tx = both(x, dtype)
    got = tl.apply_rope(tx, torch.from_numpy(pos), 1e6)
    want = jl.apply_rope(jx, jnp.asarray(pos), 1e6)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, atol=tol, rtol=tol)


def test_rope_inv_freq():
    close(tl.rope_inv_freq(64, 1e4), jl.rope_inv_freq(64, 1e4))


def test_swiglu():
    x, wg, wu, wd = draw(2, (3, 32), (32, 48), (32, 48), (48, 32), scale=0.3)
    jp, tp = both({"wg": wg, "wu": wu, "wd": wd})
    (jx, tx) = both(x)
    close(tl.swiglu(tx, tp), jl.swiglu(jx, jp))


@pytest.mark.parametrize("mode", ["scatter", "onehot"])
def test_cache_write(mode):
    cache, new = draw(3, (3, 6, 2, 4), (3, 2, 4))
    idx = np.array([0, 5, 2], np.int32)
    jc, tc = both(cache)
    (jn, tn) = both(new)
    got = tl.cache_write(tc, tn, torch.from_numpy(idx), mode)
    assert got is tc  # written in place
    close(got, jl.cache_write(jc, jn, jnp.asarray(idx), mode))


def test_cache_write_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tl.cache_write(torch.zeros(1, 2, 3), torch.zeros(1, 3), torch.zeros(1, dtype=torch.int32), "gather")


@pytest.mark.parametrize("impl", ["ref", "ref_grouped", "auto"])
@pytest.mark.parametrize("mode", ["scatter", "onehot"])
def test_gqa_decode_attention(impl, mode):
    b, d, h, kh, hd, t = 2, 32, 4, 2, 8, 10
    x, wq, wk, wv, wo, kc, vc = draw(
        4, (b, d), (d, h * hd), (d, kh * hd), (d, kh * hd), (h * hd, d),
        (b, t, kh, hd), (b, t, kh, hd), scale=0.5,
    )
    pos = np.array([3, 9], np.int32)
    lens = pos + 1
    jp, tp = both({"wq": wq, "wk": wk, "wv": wv, "wo": wo})
    (jx, tx), (jk, tk), (jv, tv) = both(x), both(kc), both(vc)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, theta=1e4, cache_update=mode)
    got, (gk, gv) = tl.gqa_decode_attention(
        tx, tp, torch.from_numpy(pos), tk, tv, torch.from_numpy(lens),
        torch.from_numpy(pos), impl=impl, **kw,
    )
    want, (wk_, wv_) = jl.gqa_decode_attention(
        jx, jp, jnp.asarray(pos), jk, jv, jnp.asarray(lens), jnp.asarray(pos), **kw,
    )
    close(got, want)
    close(gk, wk_)
    close(gv, wv_)
    assert gk is tk and gv is tv  # caches written in place


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_mamba2_decode(dtype, tol):
    cfg = ARCHS["mamba2-780m"].reduced(dtype=dtype)
    rcfg = REF_ARCHS["mamba2-780m"].reduced(dtype=dtype)
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
    proj = 2 * di + 2 * cfg.ssm_groups * n + h
    c = tssm.conv_channels(cfg)
    assert c == jssm.conv_channels(rcfg)
    x, w_in, conv_w, conv_b, w_out, conv_st = draw(
        5, (2, d), (d, proj), (cfg.conv_kernel, c), (c,), (di, d),
        (2, cfg.conv_kernel - 1, c), scale=0.2,
    )
    dt_bias, a_log, d_skip = draw(6, (h,), (h,), (h,), scale=0.5)
    (ssm_st,) = draw(7, (2, h, cfg.ssm_head_dim, n))
    jp, tp = both({"w_in": w_in, "conv_w": conv_w, "conv_b": conv_b, "w_out": w_out}, dtype)
    jp32, tp32 = both({"dt_bias": dt_bias, "a_log": a_log, "d_skip": d_skip})
    jp.update(jp32)
    tp.update(tp32)
    (jx, tx), (jc, tc) = both(x, dtype), both(conv_st, dtype)
    (js, ts) = both(ssm_st)
    y, conv, st = tssm.mamba2_decode(tx, tp, cfg, tc, ts)
    ye, conve, ste = jssm.mamba2_decode(jx, jp, rcfg, jc, js)
    assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    assert conv is tc and st is ts  # states updated in place
    close(y, ye, atol=tol, rtol=tol)
    close(conv, conve, atol=tol, rtol=tol)
    close(st, ste, atol=tol, rtol=tol)
