"""The port's decode path against ``repro.models``: decode logits of the
serve example's trio (reduced, fp32) with JAX-initialised weights carried
over by ``params_from_numpy``, the sliding-window ring, cache layouts, and
the parameter tree's names, shapes, dtypes and bytes."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.model import param_spec  # noqa: E402

TRIO = ["mamba2-780m", "mistral-nemo-12b", "granite-20b"]
MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]  # GQA and MLA; decode parity: test_torch_moe.py
# hybrid, VLM and audio; decode parity: test_torch_families.py
FAMILIES = ["zamba2-7b", "qwen2-vl-72b", "whisper-medium"]
# fp32 logits agree to ~1e-6; 1e-4 leaves room for the two packages'
# different summation orders in the matmuls.
TOL = dict(atol=1e-4, rtol=1e-4)


def pair(name, **overrides):
    """(port cfg, reference cfg, port params, reference params) with the
    reference's weights carried over."""
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(dtype="float32"), **overrides)
    cfg = dataclasses.replace(ARCHS[name].reduced(dtype="float32"), **overrides)
    jp = jm.init_params(rcfg, jax.random.key(1))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, rcfg, tp, jp


def run_both(name, steps, capacity, batch=2, seed=0, **overrides):
    cfg, rcfg, tp, jp = pair(name, **overrides)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(steps, batch))
    jcache = jm.init_cache(rcfg, batch, capacity)
    tcache = tm.init_cache(cfg, batch, capacity, device="cpu")
    jstep = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, rcfg))
    for i in range(steps):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[i], jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[i]), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{name} step {i}")
    return tcache, jcache


@pytest.mark.parametrize("name", TRIO)
def test_decode_logits_match_reference(name):
    tcache, jcache = run_both(name, steps=24, capacity=32)
    assert int(tcache["pos"][0]) == 24
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   **TOL, err_msg=key)


@pytest.mark.parametrize("name", ["granite-20b", "mistral-nemo-12b"])
def test_sliding_window_ring_wrapped_twice(name):
    """An 8-slot ring over 20 steps wraps twice; what the kernel sees is
    ``cache_len = min(pos + 1, 8)``."""
    tcache, _ = run_both(name, steps=20, capacity=8, batch=1, seed=1, sliding_window=8)
    assert int(tcache["pos"][0]) == 20


def test_token_ids_outside_the_vocab_follow_jax_gather():
    """A pipeline feeds one model's tokens to the next, whose vocabulary
    may be smaller: JAX's gather clamps ids past the table (and counts
    negative ids from the end); the port picks the same rows."""
    cfg, rcfg, tp, jp = pair("granite-20b")
    toks = np.array([cfg.vocab + 5, -3], np.int32)
    jl, _ = jm.decode_step(jp, jm.init_cache(rcfg, 2, 4), jnp.asarray(toks), rcfg)
    tl, _ = tm.decode_step(tp, tm.init_cache(cfg, 2, 4, device="cpu"),
                           torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_onehot_cache_update_matches_scatter():
    cfg, _, tp, _ = pair("mistral-nemo-12b")
    caches = {m: tm.init_cache(cfg, 2, 8, device="cpu") for m in ("scatter", "onehot")}
    for tok in [3, 9, 27, 81]:
        t = torch.tensor([tok, tok + 1])
        out = {m: tm.decode_step(tp, caches[m], t, cfg, cache_update=m)[0] for m in caches}
        torch.testing.assert_close(out["onehot"], out["scatter"], atol=0, rtol=0)


@pytest.mark.parametrize("name", TRIO + MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_layout(name, dtype):
    cfg = ARCHS[name].reduced(dtype=dtype)
    want = jm.init_cache(REF_ARCHS[name].reduced(dtype=dtype), 3, 17)
    got = tm.init_cache(cfg, 3, 17, device="cpu")
    assert set(got) == set(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == str(arr.dtype), key


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_full_size_param_layout_and_bytes(name):
    """Names, shapes, dtypes and bytes of every leaf equal the reference's
    at full size (abstract shapes on both sides, nothing allocated): fetch
    costs, and so placements, depend on the byte count.  MoE routers stay
    fp32 in a bf16 model, as the reference draws them."""
    want = dict(_leaves(jm.abstract_params(REF_ARCHS[name])))
    got = dict(_leaves(param_spec(ARCHS[name])))
    assert set(got) == set(want)
    total = 0
    for path, (shape, dtype, _) in got.items():
        ref = want[path]
        assert tuple(shape) == ref.shape, path
        assert str(dtype).removeprefix("torch.") == str(ref.dtype), path
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        assert nbytes == ref.size * ref.dtype.itemsize, path
        total += nbytes
    assert total == sum(x.size * x.dtype.itemsize for x in want.values())
    if ARCHS[name].arch_type == "moe":
        assert got["layers.moe.router"][1] == torch.float32


@pytest.mark.parametrize("name", TRIO + MOE + FAMILIES)
def test_param_tree_paths_and_size_bytes(name):
    from repro.serving import HostedModel as RefHosted
    from repro_torch.serving import HostedModel

    cfg, rcfg, tp, jp = pair(name)
    want = {".".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(tp.state_dict())
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].nbytes == leaf.size * leaf.dtype.itemsize, key
    ref_size = RefHosted(0, rcfg, jp).size_bytes
    assert HostedModel(0, cfg, tp, "cpu").size_bytes == ref_size
    gen = torch.Generator().manual_seed(0)
    assert HostedModel(0, cfg, tm.init_params(cfg, gen, "cpu"), "cpu").size_bytes == ref_size


def test_init_params_is_seeded():
    cfg = ARCHS["granite-20b"].reduced(dtype="bfloat16")
    a, b, c = (tm.init_params(cfg, torch.Generator().manual_seed(s), "cpu") for s in (7, 7, 8))
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert a["layers"]["ln1"].eq(1).all()


def test_ssm_fp32_leaves_stay_fp32():
    cfg = ARCHS["mamba2-780m"].reduced(dtype="bfloat16")
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for key in ("dt_bias", "a_log", "d_skip"):
        assert p["layers"][key].dtype == torch.float32
    assert p["layers"]["w_in"].dtype == torch.bfloat16


def test_convert_rejects_a_mismatched_tree():
    cfg, _, _, jp = pair("granite-20b")
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["wq"] = tree["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="layers.wq"):
        tm.params_from_numpy(tree, cfg, "cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        tm.params_from_numpy(tree, cfg, "cpu")


def test_bf16_weights_carry_over_bit_for_bit():
    rcfg = REF_ARCHS["mistral-nemo-12b"].reduced(dtype="bfloat16")
    cfg = ARCHS["mistral-nemo-12b"].reduced(dtype="bfloat16")
    jp = jm.init_params(rcfg, jax.random.key(2))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    want = np.asarray(jp["layers"]["mlp"]["wg"]).view(np.uint16)
    got = tp["layers"]["mlp"]["wg"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = ARCHS["granite-20b"].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_cache(cfg, 1, 4)
