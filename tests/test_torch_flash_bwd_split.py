"""The flash backward's choices that run on the host, and its split of a
KV head's group over CTAs, on the CPU: which body takes which inputs, the
split count the wgmma body picks from the shape and the SM count, and the
plain backward's emulation of the split (per-share fp32 partials summed in
share order) against ``splits=1`` and against ``jax.vjp`` of the
reference's ``attention_ref``.  Inputs are drawn from a seed with numpy.
Tolerances: ``tests/test_torch_flash_grad.py``'s against the reference
(2e-5 in fp32, 2e-2 in bf16, scaled to each tensor's largest magnitude);
splits against ``splits=1`` in fp32 within 1e-5 of that scale (the same
terms summed in another order).  The kernel itself is held to the plain
backward on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
H100_SMS = 132

# (b, sk, kh, g): the training shapes of chip_smoke.py's phase 2e
NEMO = (2, 2048, 8, 4)
GRANITE = (2, 2048, 1, 48)
WHISPER = (2, 1500, 16, 1)


@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_first_for_bf16_at_its_head_dims(d):
    assert fb.bodies_for(torch.bfloat16, d) == ("wgmma", "mma", "fp32")
    assert fb.body_for(torch.bfloat16, d) == "wgmma"
    # an input off a 16-byte boundary is no TMA source, and mma loads 16
    # bytes a thread: the fp32 body takes it
    assert fb.bodies_for(torch.bfloat16, d, aligned=False) == ("fp32",)
    assert fb.bodies_for(torch.float32, d) == ("fp32",)


@pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112])
def test_mma_keeps_the_other_multiples_of_16(d):
    assert fb.body_for(torch.bfloat16, d) == "mma"
    assert "wgmma" not in fb.bodies_for(torch.bfloat16, d)


@pytest.mark.parametrize("d", [8, 192, 256])
def test_fp32_body_takes_the_rest(d):
    assert fb.bodies_for(torch.bfloat16, d) == ("fp32",)


def test_no_split_at_nemos_shape():
    b, sk, kh, g = NEMO
    assert fb.splits_for(b, sk, kh, g, H100_SMS) == 1
    assert fb.dkdv_ctas(b, sk, kh, 1) == 512 // fb.KV_WGS  # 512 key tiles of 64


def test_granites_mqa_is_split_to_fill_the_card():
    b, sk, kh, g = GRANITE
    n = fb.splits_for(b, sk, kh, g, H100_SMS)
    tiles = (sk // fb.KEY_TILE) * kh * b  # 64 without a split
    assert n > 1 and g % n == 0
    assert tiles * n >= max(256, fb.TILES_PER_SM * H100_SMS)
    # the least such divisor: one fewer share would fall short
    smaller = [m for m in range(1, n) if g % m == 0]
    assert all(tiles * m < fb.TILES_PER_SM * H100_SMS for m in smaller)
    assert fb.dkdv_ctas(b, sk, kh, n) == tiles * n // fb.KV_WGS


@pytest.mark.parametrize("sms", [66, 114, 132, 144])
@pytest.mark.parametrize("shape", [NEMO, GRANITE, WHISPER, (1, 300, 2, 4), (1, 64, 1, 7)],
                         ids=["nemo", "granite", "whisper", "small", "prime-group"])
def test_split_rule_depends_on_the_shape_and_sm_count_only(shape, sms):
    b, sk, kh, g = shape
    n = fb.splits_for(b, sk, kh, g, sms)
    assert n == fb.splits_for(b, sk, kh, g, sms)
    assert 1 <= n <= g and g % n == 0
    tiles = -(-sk // fb.KEY_TILE) * kh * b
    assert n == 1 or tiles * n >= fb.TILES_PER_SM * sms or n == g
    # more SMs never ask for fewer shares
    assert fb.splits_for(b, sk, kh, g, 2 * sms) >= n


def draw(seed, b, sq, sk, h, kh, d):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d), (b, sq, h, d))]


def scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# (b, sq, sk, h, kh, d, causal, window, q_offset): G = 8 on one KV head
SPLIT_CASES = [
    (1, 40, 40, 8, 1, 16, True, None, 0),      # MQA, causal
    (2, 33, 33, 8, 1, 16, False, None, 0),     # MQA, bidirectional, ragged
    (1, 48, 48, 8, 1, 16, True, 12, 0),        # MQA, sliding window
    (1, 12, 30, 8, 1, 16, True, None, 18),     # MQA, a query block into a longer history
]
SPLIT_IDS = ["causal", "bidir", "window", "q_offset"]


def plain(arrs, dtype, splits, **kw):
    q, k, v, do = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return fb.flash_attention_bwd_plain(q, k, v, out, do, lse, splits=splits, **kw)


@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_partials_match_one_share(case, splits):
    """The split's fp32 partials, summed in share order, are the unsplit
    sums up to fp32 rounding; dq does not depend on the split."""
    b, sq, sk, h, kh, d, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    arrs = draw(sum(case[:6]) + splits, b, sq, sk, h, kh, d)
    got = plain(arrs, "float32", splits, **kw)
    want = plain(arrs, "float32", 1, **kw)
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("dk", "dv"), got[1:], want[1:]):
        assert scaled_err(g.numpy(), w.numpy()) <= 1e-5, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_plain_backward_matches_jax_vjp(case, splits, dtype):
    b, sq, sk, h, kh, d, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    arrs = draw(sum(case[:6]), b, sq, sk, h, kh, d)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(JAX_DT[dtype]) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, **kw), jq, jk, jv)
    want = vjp(jdo)
    got = plain(arrs, dtype, splits, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TORCH_DT[dtype]
        err = scaled_err(g.float().numpy(), np.asarray(w, np.float32))
        assert err <= TOL[dtype], f"{name}: {err:.3e} of the largest |gradient|"


def test_split_must_divide_the_group():
    arrs = draw(0, 1, 8, 8, 6, 1, 16)
    with pytest.raises(ValueError, match="divide"):
        plain(arrs, "float32", 4, causal=True)


def test_cpu_wrapper_takes_the_plain_split():
    """On CPU tensors the wrapper runs the plain backward, with the split
    it is given."""
    arrs = draw(1, 1, 24, 24, 8, 1, 16)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    for n in (1, 4):
        got = fb.flash_attention_bwd(q, k, v, out, do, lse, splits=n)
        want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, splits=n)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
