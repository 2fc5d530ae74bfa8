"""The hybrid (zamba2), VLM (qwen2-vl) and audio (whisper) families of the
port against ``repro.models``: the M-RoPE and cross-attention layers on
the same numpy inputs, then ``forward`` and ``next_token_loss``,
step-by-step ``decode_step``, ``init_cache``, ``make_prefill_step`` and
``ExecutionEngine.run_task`` of reduced fp32 configs with JAX-initialised
weights carried over by ``params_from_numpy``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import ExecutionEngine as RefEngine  # noqa: E402
from repro.serving import HostedModel as RefHosted  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving import ExecutionEngine, HostedModel  # noqa: E402
from repro_torch.training import make_prefill_step  # noqa: E402

FAMILIES = ["zamba2-7b", "qwen2-vl-72b", "whisper-medium"]
# zamba2 at 4 layers with attn_period 2 runs the shared block twice; its
# 16-slot window is shorter than the 40-token sequences below
OVERRIDES = {"zamba2-7b": dict(n_layers=4, attn_period=2, sliding_window=16)}
# fp32 logits agree to ~1e-6; 1e-4 leaves room for the two packages'
# different summation orders in the matmuls (as tests/test_torch_model.py).
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
    """(port cfg, reference cfg, port params, reference params) with the
    reference's weights carried over."""
    kw = {**OVERRIDES.get(name, {}), **overrides}
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(dtype="float32"), **kw)
    cfg = dataclasses.replace(ARCHS[name].reduced(dtype="float32"), **kw)
    jp = jm.init_params(rcfg, jax.random.key(1))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, rcfg, tp, jp


def batch_np(cfg, b=2, s=40, seed=0):
    """tokens, and the family's extra input: 9 vision embeddings (a 3x3
    grid) or ``n_audio_frames`` stub frames."""
    rs = np.random.default_rng(seed)
    out = {"tokens": rs.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = (rs.standard_normal((b, 9, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.arch_type == "audio":
        out["audio_frames"] = (rs.standard_normal((b, cfg.n_audio_frames, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sections", [(4, 2, 2), (2, 3, 3), (8, 0, 0)])
def test_apply_mrope(sections):
    b, s, h, d = 2, 11, 3, 16
    (x,) = draw(1, (b, s, h, d))
    pos = np.random.default_rng(2).integers(0, 50, size=(3, b, s)).astype(np.int32)
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4, sections)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4, sections)
    close(got, want)


def test_apply_mrope_rejects_sections_that_miss_half_the_head_dim():
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2), 1e4, (4, 2, 1))


def test_text_mrope_positions_and_text_mrope_equals_rope():
    pos = np.arange(12, dtype=np.int32).reshape(2, 6)
    got = tl.text_mrope_positions(torch.from_numpy(pos))
    want = jl.text_mrope_positions(jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (3, 2, 6)
    # one position on every stream is plain RoPE, whatever the sections
    (x,) = draw(3, (2, 6, 2, 16))
    tx = torch.from_numpy(x)
    torch.testing.assert_close(tl.apply_mrope(tx, got, 1e4, (4, 2, 2)),
                               tl.apply_rope(tx, torch.from_numpy(pos), 1e4))


def _attn_params(seed, d, h, kh, hd):
    wq, wk, wv, wo = draw(seed, (d, h * hd), (d, kh * hd), (d, kh * hd), (h * hd, d), scale=0.3)
    return both({"wq": wq, "wk": wk, "wv": wv, "wo": wo})


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("grid", [False, True])
def test_gqa_attention_with_mrope(impl, grid):
    b, s, d, h, kh, hd, sections = 2, 20, 32, 4, 2, 16, (4, 2, 2)
    jp, tp = _attn_params(4, d, h, kh, hd)
    (x,) = draw(5, (b, s, d), scale=0.5)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    pos3 = (np.random.default_rng(6).integers(0, s, size=(3, b, s)).astype(np.int32)
            if grid else None)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, theta=1e4, mrope_sections=sections)
    got, (gk, gv) = tl.gqa_attention(
        torch.from_numpy(x), tp, torch.from_numpy(pos.copy()),
        mrope_positions=None if pos3 is None else torch.from_numpy(pos3), impl=impl, **kw)
    want, (wk, wv) = jl.gqa_attention(
        jnp.asarray(x), jp, jnp.asarray(pos),
        mrope_positions=None if pos3 is None else jnp.asarray(pos3), **kw)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


@pytest.mark.parametrize("impl", ["auto", "ref", "ref_grouped"])
def test_gqa_decode_attention_with_mrope(impl):
    b, d, h, kh, hd, t = 2, 32, 4, 2, 16, 12
    jp, tp = _attn_params(7, d, h, kh, hd)
    x, kc, vc = draw(8, (b, d), (b, t, kh, hd), (b, t, kh, hd), scale=0.5)
    pos = np.array([3, 9], np.int32)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, theta=1e4, mrope_sections=(4, 2, 2))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, _ = tl.gqa_decode_attention(torch.from_numpy(x), tp, torch.from_numpy(pos), tk, tv,
                                     torch.from_numpy(pos + 1), torch.from_numpy(pos),
                                     impl=impl, **kw)
    want, (wk, wv) = jl.gqa_decode_attention(jnp.asarray(x), jp, jnp.asarray(pos),
                                             jnp.asarray(kc), jnp.asarray(vc),
                                             jnp.asarray(pos + 1), jnp.asarray(pos), **kw)
    close(got, want)
    close(tk, wk)  # written in place
    close(tv, wv)


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("h,kh,t_enc", [(4, 4, 30), (4, 2, 7), (6, 1, 50)])
def test_cross_attention_over_projected_encoder_states(impl, h, kh, t_enc):
    b, s, d, hd = 2, 9, 32, 8
    jp, tp = _attn_params(9, d, h, kh, hd)
    x, enc = draw(10, (b, s, d), (b, t_enc, d), scale=0.5)
    jk, jv = jl.project_cross_kv(jnp.asarray(enc), jp, n_kv_heads=kh, head_dim=hd)
    tk, tv = tl.project_cross_kv(torch.from_numpy(enc), tp, n_kv_heads=kh, head_dim=hd)
    assert tk.shape == (b, t_enc, kh, hd)
    close(tk, jk)
    close(tv, jv)
    got = tl.cross_attention(torch.from_numpy(x), tp, tk, tv, n_heads=h, head_dim=hd, impl=impl)
    want = jl.cross_attention(jnp.asarray(x), jp, jk, jv, n_heads=h, head_dim=hd)
    assert got.shape == (b, s, d)
    close(got, want)


def test_sinusoidal_and_audio_encoder_match_reference():
    cfg, rcfg, tp, jp = pair("whisper-medium")
    close(tmodel._sinusoidal(37, cfg.d_model, "cpu"), jmodel._sinusoidal(37, cfg.d_model))
    frames = batch_np(cfg)["audio_frames"]
    got = tmodel._encode_audio(tp, torch.from_numpy(frames), cfg, impl="auto")
    want = jmodel._encode_audio(jp, jnp.asarray(frames), rcfg, impl="ref")
    close(got, want, **TOL)


def test_vision_positions_match_reference_grid():
    """A 10-embedding prefix sits on a 3-wide grid; the text follows at 10."""
    pos3 = tmodel._vision_positions(10, 4, 2, "cpu")
    assert pos3.shape == (3, 2, 14)
    np.testing.assert_array_equal(pos3[:, 0, :10].numpy(),
                                  [[0] * 10, [i // 3 for i in range(10)],
                                   [i % 3 for i in range(10)]])
    np.testing.assert_array_equal(pos3[:, 1, 10:].numpy(), [[10, 11, 12, 13]] * 3)


# ---------------------------------------------------------------------------
# forward, loss, prefill step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_loss_match_reference(name, impl):
    cfg, rcfg, tp, jp = pair(name)
    nb = batch_np(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jlogits, _ = jax.jit(lambda p, b: jm.forward(p, b, rcfg))(jp, jb)
    jloss = jax.jit(lambda p, b: jm.next_token_loss(p, b, rcfg))(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    logits, aux = tm.forward(tp, tb, cfg, impl=impl)
    assert logits.shape == (2, 40, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    loss = tm.next_token_loss(tp, tb, cfg, impl=impl)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


def test_zamba2_shared_block_takes_the_configs_window():
    """The shared block attends over ``cfg.sliding_window`` whatever window
    the caller passes, as the reference's does; a shorter window changes
    its logits."""
    cfg, rcfg, tp, jp = pair("zamba2-7b")
    toks = batch_np(cfg)["tokens"]
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, rcfg, window=4)
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg, window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    narrow, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                           dataclasses.replace(cfg, sliding_window=4))
    assert not torch.allclose(narrow, got, **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_step_hands_every_batch_entry_to_forward(name):
    cfg, rcfg, tp, jp = pair(name)
    nb = batch_np(cfg, s=20, seed=3)
    got = make_prefill_step(cfg, device="cpu")(tp, nb)  # numpy arrays are moved to the device
    want, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in nb.items()}, rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vlm_prefill_reads_the_vision_prefix():
    cfg, _, tp, _ = pair("qwen2-vl-72b")
    nb = batch_np(cfg, s=12)
    step = make_prefill_step(cfg, device="cpu")
    other = dict(nb, vision_embeds=nb["vision_embeds"] * 50.0)
    assert not torch.allclose(step(tp, nb), step(tp, other), **TOL)
    with pytest.raises(KeyError, match="vision_embeds"):
        step(tp, {"tokens": nb["tokens"]})


# ---------------------------------------------------------------------------
# cache and decode
# ---------------------------------------------------------------------------
def seed_cross_cache(cfg, params, frames, enc_fn, proj_fn, stack, layer_of):
    """The cross-attention cache from stub frames, as tests/test_archs.py
    seeds it: the encoder's output projected by each decoder layer."""
    enc = enc_fn(params, frames)
    ks, vs = zip(*(proj_fn(enc, layer_of(i)) for i in range(cfg.n_layers)))
    return stack(ks), stack(vs)


def run_both(name, steps, capacity, batch=2, seed=0, cross=False, **overrides):
    cfg, rcfg, tp, jp = pair(name, **overrides)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(steps, batch))
    jcache = jm.init_cache(rcfg, batch, capacity)
    tcache = tm.init_cache(cfg, batch, capacity, device="cpu")
    if cross:
        (frames,) = draw(seed + 1, (batch, cfg.n_audio_frames, cfg.d_model), scale=0.02)
        kw = dict(n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd)
        jcache["cross_k"], jcache["cross_v"] = seed_cross_cache(
            rcfg, jp, jnp.asarray(frames),
            lambda p, f: jmodel._encode_audio(p, f, rcfg, impl="ref"),
            lambda e, c: jl.project_cross_kv(e, c, **kw), jnp.stack,
            lambda i: jax.tree.map(lambda x: x[i], jp["layers"]["cross"]))
        tk, tv = seed_cross_cache(
            cfg, tp, torch.from_numpy(frames),
            lambda p, f: tmodel._encode_audio(p, f, cfg, impl="auto"),
            lambda e, c: tl.project_cross_kv(e, c, **kw), torch.stack,
            lambda i: tp["layers"].layer(i)["cross"])
        close(tk, jcache["cross_k"], **TOL)
        tcache["cross_k"].copy_(tk)
        tcache["cross_v"].copy_(tv)
    jstep = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, rcfg))
    for i in range(steps):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(toks[i], jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[i]), cfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"{name} step {i}")
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL,
                                   err_msg=key)
    return tcache


def test_whisper_decode_over_a_seeded_cross_cache():
    tcache = run_both("whisper-medium", steps=12, capacity=16, cross=True)
    assert int(tcache["pos"][0]) == 12
    assert tcache["cross_k"].abs().sum() > 0


def test_whisper_decode_over_a_zero_cross_cache():
    """What the serving engine decodes over: the cross cache as
    ``init_cache`` leaves it."""
    run_both("whisper-medium", steps=6, capacity=8, seed=2)


def test_qwen2_vl_decode_with_text_mrope():
    tcache = run_both("qwen2-vl-72b", steps=12, capacity=16)
    assert int(tcache["pos"][0]) == 12


@pytest.mark.parametrize("batch", [1, 2])
def test_zamba2_decode_past_the_wrap_of_an_8_slot_window(batch):
    """Two applications of the shared block, each over an 8-slot ring that
    20 steps wrap twice (``cache_len = min(pos + 1, 8)``)."""
    tcache = run_both("zamba2-7b", steps=20, capacity=32, batch=batch, seed=1, sliding_window=8)
    assert tuple(tcache["shared_k"].shape[:3]) == (2, batch, 8)
    assert int(tcache["pos"][0]) == 20


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dtype", [None, "float32"])
def test_init_cache_layout(name, dtype, cache_dtype):
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(dtype=dtype), **OVERRIDES.get(name, {}))
    cfg = dataclasses.replace(ARCHS[name].reduced(dtype=dtype), **OVERRIDES.get(name, {}))
    want = jm.init_cache(rcfg, 3, 40, dtype=cache_dtype and jnp.dtype(cache_dtype))
    got = tm.init_cache(cfg, 3, 40, dtype=cache_dtype and getattr(torch, cache_dtype),
                        device="cpu")
    assert set(got) == set(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == str(arr.dtype), key
        assert not got[key].any(), key


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_run_task_tokens_equal_the_reference_engines(name):
    cfg, rcfg, tp, jp = pair(name)
    prompt = np.random.default_rng(4).integers(1, cfg.vocab, size=(2, 10)).astype(np.int32)
    want, _ = RefEngine({0: RefHosted(0, rcfg, jp)}, decode_tokens=5).run_task(0, prompt)
    got, wall = ExecutionEngine({0: HostedModel(0, cfg, tp, "cpu")}, decode_tokens=5,
                                device="cpu").run_task(0, prompt)
    assert got.shape == (2, 5) and got.dtype == np.int32 and wall > 0
    np.testing.assert_array_equal(got, np.asarray(want))
