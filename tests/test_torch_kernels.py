"""The port's attention and SSD oracles and its kernels' plain twins
against the JAX package's oracles and its Pallas kernels (run in interpret
mode), on the same numpy inputs; plus the wrappers' host-side checks and
``ssd_decode_ref`` parity.  The grouped matmul's parity is in
``test_torch_moe.py``.  The CUDA kernels themselves run only on the card:
see ``test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(seed, b, h, kh, d, t, dtype, lens=None):
    """Same values for both packages: fp32 numpy draws, rounded to the
    working dtype the same way (round to nearest even) on each side."""
    rs = np.random.default_rng(seed)
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in [(b, h, d), (b, t, kh, d), (b, t, kh, d)])
    if lens is None:
        lens = np.random.RandomState(0).randint(1, t + 1, size=(b,))
    lens = np.asarray(lens, np.int32)
    jx = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)] + [jnp.asarray(lens)]
    tx = [torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)] + [torch.from_numpy(lens)]
    return jx, tx


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


PORT_IMPLS = {
    "plain": lambda q, k, v, n: da.decode_attention(q, k, v, n),
    "ref": lambda q, k, v, n: ops.decode_attention(q, k, v, n, impl="ref"),
    "ref_grouped": lambda q, k, v, n: ops.decode_attention(q, k, v, n, impl="ref_grouped"),
    "auto": lambda q, k, v, n: ops.decode_attention(q, k, v, n, impl="auto"),
}

# The shapes of tests/test_kernels.py::test_decode_attention_matches_oracle,
# plus the zoo's head dims that are not powers of two (zamba2 112, MLA 192).
SHAPES = [
    (1, 4, 4, 64, 128, 64),
    (2, 8, 2, 64, 300, 128),
    (4, 8, 1, 32, 64, 32),
    (2, 16, 8, 128, 512, 256),
    (2, 4, 2, 112, 96, 64),
    (2, 4, 1, 192, 80, 64),
]


@pytest.mark.parametrize("impl", sorted(PORT_IMPLS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,d,t,block_k", SHAPES)
def test_decode_attention_matches_reference(b, h, kh, d, t, block_k, dtype, impl):
    (jq, jk, jv, jl), (q, k, v, n) = inputs(4, b, h, kh, d, t, dtype)
    out = PORT_IMPLS[impl](q, k, v, n)
    assert out.dtype == TDT[dtype] and out.shape == (b, h, d)
    want = jref.decode_attention_ref(jq, jk, jv, jl)
    np.testing.assert_allclose(f32(out), f32(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,d,t,block_k", SHAPES[:4])
def test_plain_matches_pallas_interpret(b, h, kh, d, t, block_k, dtype):
    (jq, jk, jv, jl), (q, k, v, n) = inputs(5, b, h, kh, d, t, dtype)
    want = pallas_decode(jq, jk, jv, jl, block_k=block_k, interpret=True)
    got = da.decode_attention_plain(q, k, v, n)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_decode_attention_len_one():
    """A cache with one valid entry gives that entry's value."""
    _, (q, k, v, _) = inputs(7, 1, 2, 2, 16, 64, "float32")
    n = torch.tensor([1], dtype=torch.int32)
    for impl in PORT_IMPLS.values():
        np.testing.assert_allclose(impl(q, k, v, n)[0].numpy(), v[0, 0].numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", sorted(PORT_IMPLS))
def test_empty_row_gives_zero(impl):
    """``cache_len == 0`` gives 0, as ``decode_attention_ref`` does.  The
    Pallas kernel does not: its -1e30 mask turns every masked weight into
    exp(0) = 1, so it returns the mean of V over its first block.  Only the
    reference oracle is held here."""
    (jq, jk, jv, _), (q, k, v, _) = inputs(8, 2, 8, 2, 64, 96, "float32")
    lens = np.array([0, 37], np.int32)
    got = PORT_IMPLS[impl](q, k, v, torch.from_numpy(lens))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    assert float(torch.abs(got[0]).max()) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_cache_len_past_capacity_is_clamped():
    _, (q, k, v, _) = inputs(9, 2, 4, 2, 32, 40, "float32")
    full = torch.tensor([40, 40], dtype=torch.int32)
    over = torch.tensor([41, 1000], dtype=torch.int32)
    torch.testing.assert_close(da.decode_attention_plain(q, k, v, over),
                               da.decode_attention_plain(q, k, v, full))


def test_ssd_decode_matches_reference():
    rs = np.random.default_rng(3)
    b, h, p, n = 2, 3, 16, 8
    x = rs.standard_normal((b, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rs.standard_normal((b, h)))).astype(np.float32)
    a = -np.exp(rs.standard_normal(h) * 0.3).astype(np.float32)
    bb, cc = (rs.standard_normal((b, h, n)).astype(np.float32) * 0.5 for _ in range(2))
    st = rs.standard_normal((b, h, p, n)).astype(np.float32)
    y, s = ops.ssd_decode(*(torch.from_numpy(z) for z in (x, dt, a, bb, cc, st)))
    ye, se = jref.ssd_decode_ref(*(jnp.asarray(z) for z in (x, dt, a, bb, cc, st)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(se), atol=1e-5, rtol=1e-5)


def _good(d=64, dtype=torch.float32):
    return (torch.zeros(2, 8, d, dtype=dtype), torch.zeros(2, 16, 2, d, dtype=dtype),
            torch.zeros(2, 16, 2, d, dtype=dtype), torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize(
    "case,err",
    [
        ("lens_int64", ValueError),
        ("lens_shape", ValueError),
        ("fp16", TypeError),
        ("mixed_dtype", TypeError),
        ("d_too_big", ValueError),
        ("d_ragged_vector", ValueError),
        ("heads_not_grouped", ValueError),
        ("not_contiguous", ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    q, k, v, n = _good()
    if case == "lens_int64":
        n = n.long()
    elif case == "lens_shape":
        n = torch.zeros(3, dtype=torch.int32)
    elif case == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "d_too_big":
        q, k, v, n = _good(d=264)
    elif case == "d_ragged_vector":
        q, k, v, n = _good(d=36, dtype=torch.bfloat16)
    elif case == "heads_not_grouped":
        q = torch.zeros(2, 7, 64)
    elif case == "not_contiguous":
        k = torch.zeros(2, 2, 16, 64).transpose(1, 2)
    with pytest.raises(err):
        da._check(q, k, v, n)
    da._check(*_good())  # the good case passes


def test_unknown_impl_rejected():
    with pytest.raises(ValueError):
        ops.decode_attention(*_good(), impl="pallas")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def flash_inputs(seed, b, sq, sk, h, kh, d, dtype):
    rs = np.random.default_rng(seed)
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in [(b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)])
    return ([jnp.asarray(x, JDT[dtype]) for x in (q, k, v)],
            [torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)])


FLASH_IMPLS = {
    "plain": lambda q, k, v, **kw: fa.flash_attention(q, k, v, **kw),
    "ref": lambda q, k, v, **kw: ops.flash_attention(q, k, v, impl="ref", **kw),
    "ref_chunked": lambda q, k, v, **kw: tref.attention_chunked_ref(q, k, v, chunk_k=48, **kw),
    "auto": lambda q, k, v, **kw: ops.flash_attention(q, k, v, impl="auto", **kw),
}

# The shapes of tests/test_kernels.py::test_flash_attention_matches_oracle.
FLASH_SHAPES = [
    (1, 128, 4, 4, 64, True, None),     # MHA, aligned
    (2, 200, 8, 2, 64, True, None),     # GQA, ragged seq
    (2, 96, 8, 1, 32, True, None),      # MQA
    (1, 256, 4, 2, 128, False, None),   # bidirectional (encoder)
    (2, 160, 4, 4, 64, True, 64),       # sliding window
    (1, 64, 2, 2, 8, True, None),       # tiny head dim
]


@pytest.mark.parametrize("impl", sorted(FLASH_IMPLS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", FLASH_SHAPES)
def test_flash_attention_matches_reference(b, s, h, kh, d, causal, window, dtype, impl):
    (jq, jk, jv), (q, k, v) = flash_inputs(1, b, s, s, h, kh, d, dtype)
    out = FLASH_IMPLS[impl](q, k, v, causal=causal, window=window)
    assert out.dtype == TDT[dtype] and out.shape == (b, s, h, d)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(f32(out), f32(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", FLASH_SHAPES)
def test_flash_plain_matches_pallas_interpret(b, s, h, kh, d, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = flash_inputs(2, b, s, s, h, kh, d, dtype)
    want = pallas_flash(jq, jk, jv, causal=causal, window=window,
                        block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("impl", sorted(FLASH_IMPLS))
@pytest.mark.parametrize("sq,sk,q_offset", [(1, 96, 95), (40, 96, 56), (30, 50, 70)])
def test_flash_attention_q_offset(sq, sk, q_offset, impl):
    """A query block attending into a longer history, as in
    tests/test_kernels.py::test_flash_attention_q_offset (Sq = 1), and
    wider blocks; the Pallas kernel is held at the first."""
    (jq, jk, jv), (q, k, v) = flash_inputs(3, 2, sq, sk, 4, 2, 32, "float32")
    got = FLASH_IMPLS[impl](q, k, v, causal=True, q_offset=q_offset)
    want = jref.attention_ref(jq, jk, jv, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)
    if sq == 1:
        kernel = pallas_flash(jq, jk, jv, causal=True, q_offset=q_offset, block_k=32,
                              interpret=True)
        np.testing.assert_allclose(f32(got), f32(kernel), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", sorted(FLASH_IMPLS))
def test_flash_attention_unseen_rows_give_zero(impl):
    """With q_offset = -10 queries 0..9 see no key: the oracle gives 0 and
    so does the port (the Pallas kernel's -1e30 mask would give a mean of
    V there)."""
    (jq, jk, jv), (q, k, v) = flash_inputs(4, 2, 40, 40, 4, 2, 16, "float32")
    got = FLASH_IMPLS[impl](q, k, v, causal=True, q_offset=-10)
    want = jref.attention_ref(jq, jk, jv, causal=True, q_offset=-10)
    assert float(got[:, :10].abs().max()) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


def _flash_good(d=64, dtype=torch.float32):
    return (torch.zeros(2, 8, 8, d, dtype=dtype), torch.zeros(2, 16, 2, d, dtype=dtype),
            torch.zeros(2, 16, 2, d, dtype=dtype))


@pytest.mark.parametrize(
    "case,err",
    [
        ("q_rank", ValueError),
        ("kv_shape", ValueError),
        ("batch", ValueError),
        ("fp16", TypeError),
        ("mixed_dtype", TypeError),
        ("d_too_big", ValueError),
        ("d_ragged_vector", ValueError),
        ("heads_not_grouped", ValueError),
        ("not_contiguous", ValueError),
    ],
)
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    q, k, v = _flash_good()
    if case == "q_rank":
        q = q[:, 0]
    elif case == "kv_shape":
        v = v[:, :8]
    elif case == "batch":
        q = torch.zeros(3, 8, 8, 64)
    elif case == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        v = v.bfloat16()
    elif case == "d_too_big":
        q, k, v = _flash_good(d=264)
    elif case == "d_ragged_vector":
        q, k, v = _flash_good(d=36, dtype=torch.bfloat16)
    elif case == "heads_not_grouped":
        q = torch.zeros(2, 8, 7, 64)
    elif case == "not_contiguous":
        k = torch.zeros(2, 2, 16, 64).transpose(1, 2)
    with pytest.raises(err):
        fa._check(q, k, v)
    fa._check(*_flash_good())  # the good case passes


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
SSD_TOL = dict(atol=5e-5, rtol=5e-4)  # tests/test_kernels.py


def ssd_inputs(seed, b, t, h, p, n, with_state=False):
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((b, t, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((b, t, h)))).astype(np.float32)
    a = -np.exp(rs.standard_normal(h) * 0.3).astype(np.float32)
    bb, cc = ((rs.standard_normal((b, t, h, n)) * 0.5).astype(np.float32) for _ in range(2))
    arrays = [x, dt, a, bb, cc]
    if with_state:
        arrays.append(rs.standard_normal((b, h, p, n)).astype(np.float32))
    return [jnp.asarray(z) for z in arrays], [torch.from_numpy(z) for z in arrays]


SSD_IMPLS = {
    "plain": lambda *xs, chunk, **kw: ssd.ssd_scan(*xs, chunk=chunk, **kw),
    "ssd_ref": lambda *xs, chunk, **kw: tref.ssd_ref(*xs, **kw),
    "ssd_chunked_ref": lambda *xs, chunk, **kw: tref.ssd_chunked_ref(*xs, chunk=chunk, **kw),
    "ref": lambda *xs, chunk, **kw: ops.ssd_scan(*xs, chunk=chunk, impl="ref", **kw),
    "ref_sequential": lambda *xs, chunk, **kw: ops.ssd_scan(*xs, chunk=chunk,
                                                             impl="ref_sequential", **kw),
    "auto": lambda *xs, chunk, **kw: ops.ssd_scan(*xs, chunk=chunk, impl="auto", **kw),
}

# The shapes of tests/test_kernels.py::test_ssd_scan_matches_oracle.
SSD_SHAPES = [
    (1, 64, 2, 32, 16, 16),
    (2, 100, 3, 32, 16, 32),   # ragged chunks
    (1, 33, 1, 16, 8, 8),
    (2, 128, 4, 64, 32, 64),
]


@pytest.mark.parametrize("impl", sorted(SSD_IMPLS))
@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_matches_reference(b, t, h, p, n, chunk, impl):
    jx, tx = ssd_inputs(1, b, t, h, p, n)
    y, fs = SSD_IMPLS[impl](*tx, chunk=chunk)
    ye, fse = jref.ssd_ref(*jx)
    assert y.dtype == torch.float32 and fs.shape == (b, h, p, n)
    np.testing.assert_allclose(f32(y), f32(ye), **SSD_TOL)
    np.testing.assert_allclose(f32(fs), f32(fse), **SSD_TOL)


@pytest.mark.parametrize("b,t,h,p,n,chunk", SSD_SHAPES)
def test_ssd_plain_matches_pallas_interpret(b, t, h, p, n, chunk):
    jx, tx = ssd_inputs(2, b, t, h, p, n)
    ye, fse = pallas_ssd(*jx, chunk=chunk, interpret=True)
    y, fs = ssd.ssd_scan_plain(*tx, chunk=chunk)
    np.testing.assert_allclose(f32(y), f32(ye), **SSD_TOL)
    np.testing.assert_allclose(f32(fs), f32(fse), **SSD_TOL)


@pytest.mark.parametrize("impl", sorted(SSD_IMPLS))
def test_ssd_scan_from_an_initial_state(impl):
    """The port's kernel takes an initial state, as ``ssd_chunked_ref``
    does (the Pallas kernel refuses one): held to the reference oracles."""
    jx, tx = ssd_inputs(3, 2, 70, 3, 16, 8, with_state=True)
    y, fs = SSD_IMPLS[impl](*tx[:5], chunk=16, initial_state=tx[5])
    for want in (jref.ssd_ref(*jx[:5], initial_state=jx[5]),
                 jref.ssd_chunked_ref(*jx[:5], chunk=16, initial_state=jx[5])):
        np.testing.assert_allclose(f32(y), f32(want[0]), **SSD_TOL)
        np.testing.assert_allclose(f32(fs), f32(want[1]), **SSD_TOL)


def test_ssd_scan_bf16_rounds_y_only():
    """bf16 x/b/c: y comes back in bf16 and the state in fp32, both close
    to the JAX oracle run on the same bf16 values."""
    jx, tx = ssd_inputs(4, 1, 48, 2, 16, 8)
    jb = [z.astype(jnp.bfloat16) if i in (0, 3, 4) else z for i, z in enumerate(jx)]
    tb = [z.bfloat16() if i in (0, 3, 4) else z for i, z in enumerate(tx)]
    y, fs = ssd.ssd_scan(*tb, chunk=16)
    ye, fse = jref.ssd_chunked_ref(*jb, chunk=16)
    assert y.dtype == torch.bfloat16 and fs.dtype == torch.float32
    np.testing.assert_allclose(f32(y), f32(ye), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(f32(fs), f32(fse), **SSD_TOL)


def _ssd_good(p=16, n=8, dtype=torch.float32):
    return (torch.zeros(2, 10, 3, p, dtype=dtype), torch.zeros(2, 10, 3),
            torch.zeros(3), torch.zeros(2, 10, 3, n, dtype=dtype),
            torch.zeros(2, 10, 3, n, dtype=dtype))


@pytest.mark.parametrize(
    "case,err",
    [
        ("x_rank", ValueError),
        ("dt_shape", ValueError),
        ("a_shape", ValueError),
        ("fp16", TypeError),
        ("mixed_dtype", TypeError),
        ("dt_bf16", TypeError),
        ("p_ragged_vector", ValueError),
        ("n_ragged_vector", ValueError),
        ("chunk_zero", ValueError),
        ("state_shape", ValueError),
        ("not_contiguous", ValueError),
    ],
)
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    x, dt, a, b, c = _ssd_good()
    chunk, state = 4, None
    if case == "x_rank":
        x = x[0]
    elif case == "dt_shape":
        dt = dt[:, :5]
    elif case == "a_shape":
        a = torch.zeros(4)
    elif case == "fp16":
        x, b, c = x.half(), b.half(), c.half()
    elif case == "mixed_dtype":
        c = c.bfloat16()
    elif case == "dt_bf16":
        dt = dt.bfloat16()
    elif case == "p_ragged_vector":
        x, dt, a, b, c = _ssd_good(p=12, dtype=torch.bfloat16)
    elif case == "n_ragged_vector":
        x, dt, a, b, c = _ssd_good(n=6)
    elif case == "chunk_zero":
        chunk = 0
    elif case == "state_shape":
        state = torch.zeros(2, 3, 16, 4)
    elif case == "not_contiguous":
        b = torch.zeros(2, 10, 8, 3).transpose(2, 3)
    with pytest.raises(err):
        ssd._check(x, dt, a, b, c, chunk, state)
    ssd._check(*_ssd_good(), 4, torch.zeros(2, 3, 16, 8))  # the good case passes


@pytest.mark.parametrize("which", ["decode", "flash", "ssd", "gmm"])
def test_empty_input_gives_empty_output(which):
    """A batch of no rows (or no queries) gives an output of no elements
    in the right shape and dtype, and counts no launch."""
    before = (da.launches, fa.launches, ssd.launches, gmm.launches)
    if which == "decode":
        out = da.decode_attention(torch.zeros(0, 4, 8), torch.zeros(0, 5, 2, 8),
                                  torch.zeros(0, 5, 2, 8), torch.zeros(0, dtype=torch.int32))
        assert out.shape == (0, 4, 8)
    elif which == "flash":
        out = fa.flash_attention(torch.zeros(2, 0, 4, 8), torch.zeros(2, 5, 2, 8),
                                 torch.zeros(2, 5, 2, 8))
        assert out.shape == (2, 0, 4, 8)
    elif which == "gmm":
        out = gmm.moe_gmm(torch.zeros(0, 16), torch.zeros(4, 16, 8),
                          torch.zeros(4, dtype=torch.int32))
        assert out.shape == (0, 8)
    else:
        out, state = ssd.ssd_scan(torch.zeros(0, 10, 3, 16), torch.zeros(0, 10, 3),
                                  torch.zeros(3), torch.zeros(0, 10, 3, 8),
                                  torch.zeros(0, 10, 3, 8), chunk=4)
        assert out.shape == (0, 10, 3, 16) and state.shape == (0, 3, 16, 8)
        assert state.dtype == torch.float32
    assert out.dtype == torch.float32
    assert (da.launches, fa.launches, ssd.launches, gmm.launches) == before


def test_unknown_impl_rejected_by_every_op():
    with pytest.raises(ValueError):
        ops.flash_attention(*_flash_good(), impl="pallas")
    with pytest.raises(ValueError):
        ops.ssd_scan(*_ssd_good(), impl="pallas")
    with pytest.raises(ValueError):
        ops.moe_gmm(*_gmm_good(), impl="pallas")


# ---------------------------------------------------------------------------
# grouped matmul: the wrapper's host-side checks
# ---------------------------------------------------------------------------
def _gmm_good(t=12, d_in=16, d_out=8, e=4, dtype=torch.float32, device="cpu"):
    return (torch.zeros(t, d_in, dtype=dtype, device=device),
            torch.zeros(e, d_in, d_out, dtype=dtype, device=device),
            torch.zeros(e, dtype=torch.int32, device=device))


@pytest.mark.parametrize(
    "case,err",
    [
        ("x_rank", ValueError),
        ("w_rank", ValueError),
        ("d_in_mismatch", ValueError),
        ("sizes_int64", ValueError),
        ("sizes_shape", ValueError),
        ("no_expert", ValueError),
        ("fp16", TypeError),
        ("mixed_dtype", TypeError),
        ("sizes_elsewhere", ValueError),
        ("not_contiguous", ValueError),
    ],
)
def test_gmm_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    x, w, gs = _gmm_good()
    if case == "x_rank":
        x = x[None]
    elif case == "w_rank":
        w = w[0]
    elif case == "d_in_mismatch":
        w = torch.zeros(4, 15, 8)
    elif case == "sizes_int64":
        gs = gs.long()
    elif case == "sizes_shape":
        gs = torch.zeros(5, dtype=torch.int32)
    elif case == "no_expert":
        w, gs = torch.zeros(0, 16, 8), torch.zeros(0, dtype=torch.int32)
    elif case == "fp16":
        x, w = x.half(), w.half()
    elif case == "mixed_dtype":
        w = w.bfloat16()
    elif case == "sizes_elsewhere":
        gs = torch.zeros(4, dtype=torch.int32, device="meta")
    elif case == "not_contiguous":
        w = torch.zeros(4, 8, 16).transpose(1, 2)
    with pytest.raises(err):
        gmm._check(x, w, gs)
    gmm._check(*_gmm_good())  # the good case passes


def test_gmm_wrapper_checks_read_no_value():
    """The checks take shapes, dtypes and devices only, never a value:
    they pass on ``meta`` tensors, which hold none, so the sizes a CUDA
    call hands the kernel are never read on the host."""
    gmm._check(*_gmm_good(device="meta", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="runs on CUDA or CPU"):
        gmm.moe_gmm(*_gmm_good(device="meta"))


# ---------------------------------------------------------------------------
# which body a CUDA call runs, and the build's cache key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "dtype,d,bodies",
    [
        (torch.float32, 64, ("fp32",)),
        (torch.float32, 256, ("fp32",)),
        (torch.bfloat16, 64, ("wgmma", "mma", "fp32")),
        (torch.bfloat16, 128, ("wgmma", "mma", "fp32")),
        (torch.bfloat16, 192, ("wgmma", "mma", "fp32")),   # MLA's hd + rope dim
        (torch.bfloat16, 256, ("wgmma", "mma", "fp32")),
        (torch.bfloat16, 160, ("mma", "fp32")),            # no whole swizzle row
        (torch.bfloat16, 112, ("mma", "fp32")),            # zamba2: no whole swizzle row
        (torch.bfloat16, 32, ("mma", "fp32")),
        (torch.bfloat16, 8, ("fp32",)),
        (torch.bfloat16, 40, ("fp32",)),
        (torch.float16, 64, ()),
    ],
)
def test_flash_body_for(dtype, d, bodies):
    """The body follows the dtype and head dim alone: an input off a
    16-byte boundary is copied before the launch (tests/test_torch_alignment.py)."""
    assert fa.bodies_for(dtype, d) == bodies
    if bodies:
        assert fa.body_for(dtype, d) == bodies[0]
    else:
        with pytest.raises(TypeError):
            fa.body_for(dtype, d)


@pytest.mark.parametrize(
    "dtype,d_in,d_out,aligned,experts,bodies",
    [
        (torch.float32, 2048, 768, True, 128, ("fp32",)),
        (torch.float32, 999, 777, False, 8, ("fp32",)),
        (torch.bfloat16, 2048, 768, True, 128, ("wgmma", "mma", "mma_elem")),   # Qwen3-MoE
        (torch.bfloat16, 5120, 1536, True, 160, ("wgmma", "mma", "mma_elem")),  # DeepSeek-V2
        (torch.bfloat16, 1000, 776, True, 8, ("wgmma", "mma", "mma_elem")),
        (torch.bfloat16, 2048, 768, False, 128, ("mma_elem",)),
        (torch.bfloat16, 999, 777, True, 8, ("mma_elem",)),
        (torch.bfloat16, 1000, 777, True, 8, ("mma_elem",)),
        (torch.bfloat16, 2048, 768, True, 1025, ("mma", "mma_elem")),
        (torch.float16, 64, 64, True, 4, ()),
    ],
)
def test_gmm_body_for(dtype, d_in, d_out, aligned, experts, bodies):
    assert gmm.bodies_for(dtype, d_in, d_out, aligned, experts) == bodies
    if bodies:
        assert gmm.body_for(dtype, d_in, d_out, aligned, experts) == bodies[0]
    else:
        with pytest.raises(TypeError):
            gmm.body_for(dtype, d_in, d_out, aligned, experts)


def test_library_name_follows_every_shared_header(tmp_path, monkeypatch):
    """A library is named after its source, every ``csrc/*.cuh`` and the
    flags: an edited header gives a new name, so a stale build is never
    loaded as current; a new header too; an unrelated file does not."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("#define X 1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "notes.txt").write_text("not a header")
    assert _build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("#define X 2\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "more.cuh").write_text("\n")
    assert _build.library_path("k") not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("k") not in (first, second)
    assert _build.sources() == ["k"]  # headers are not kernel sources


# ---------------------------------------------------------------------------
# the split decode body and the chunked SSD body: their choices and their
# arithmetic, written out in PyTorch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "b,kh,t,splits,slots",
    [
        (2, 8, 13, 1, 64),        # NeMo's serving shape: one split, no combine
        (2, 1, 13, 1, 64),        # granite's
        (2, 8, 300, 5, 64),       # fewer tiles than the CTAs wanted: one tile each
        (2, 8, 4096, 16, 256),    # NeMo's long caches: about two CTAs per SM
        (2, 8, 32768, 17, 1984),
        (2, 1, 32768, 128, 256),  # granite's
        (2, 128, 300, 2, 192),    # DeepSeek-V2's MLA: B·KH already fills the card
        (1, 264, 4096, 1, 4096),  # more CTAs than wanted without splitting
        (1, 1, 0, 1, 64),         # no slot at all
    ],
)
def test_splits_for(b, kh, t, splits, slots):
    assert da.splits_for(b, kh, t, 132) == splits  # an H100 SXM's SMs
    assert da.slots_per_split(t, splits) == slots
    assert slots % da.SPLIT_TILE == 0 and splits * slots >= t
    assert t == 0 or (splits - 1) * slots < t  # every split holds a valid slot


@pytest.mark.parametrize(
    "dtype,d,g,splits,bodies",
    [
        (torch.bfloat16, 128, 4, 1, ("split", "single")),     # NeMo at T = 13
        (torch.bfloat16, 128, 48, 1, ("split", "single")),    # granite's MQA at T = 13
        (torch.bfloat16, 192, 1, 2, ("split", "single")),     # MLA's hd + rope dim
        (torch.bfloat16, 112, 1, 5, ("split", "single")),     # zamba2
        (torch.bfloat16, 256, 128, 17, ("split", "single")),
        (torch.bfloat16, 128, 129, 5, ("single",)),           # more rows than one CTA takes
        (torch.float32, 64, 64, 5, ("split", "single")),
        (torch.float32, 64, 65, 5, ("single",)),
        (torch.float32, 128, 48, 1, ("single", "split")),     # fp32, one range: single first
        (torch.float32, 128, 4, 2, ("split", "single")),      # fp32, two ranges: split first
        (torch.bfloat16, 264, 4, 1, ()),                      # head dim past 256
        (torch.bfloat16, 36, 4, 1, ()),                       # no whole 16-byte vectors
        (torch.float16, 128, 4, 1, ()),
    ],
)
def test_decode_body_for(dtype, d, g, splits, bodies):
    assert da.bodies_for(dtype, d, g, splits) == bodies
    if bodies:
        assert da.body_for(dtype, d, g, splits) == bodies[0]
    else:
        with pytest.raises(TypeError):
            da.body_for(dtype, d, g, splits)


@pytest.mark.parametrize(
    "dtype,p,n,chunk,bh,bodies",
    [
        (torch.bfloat16, 64, 128, 128, 96, ("chunked", "serial")),  # mamba2-780m, B = 2
        (torch.bfloat16, 64, 64, 64, 96, ("chunked", "serial")),    # zamba2's N, the ops chunk
        (torch.bfloat16, 64, 128, 128, 960, ("chunked", "serial")),  # bf16: B·H does not matter
        (torch.float32, 64, 128, 128, 96, ("serial", "chunked")),   # fp32: serial fills 96 SMs
        (torch.float32, 64, 128, 128, 48, ("chunked", "serial")),   # fp32, B = 1: 84 SMs idle
        (torch.float32, 64, 128, 128, 88, ("chunked", "serial")),   # two thirds of one wave
        (torch.float32, 64, 128, 128, 89, ("serial", "chunked")),
        (torch.float32, 64, 128, 128, 144, ("chunked", "serial")),  # B = 3: a second wave of 12
        (torch.float32, 64, 128, 128, 192, ("serial", "chunked")),  # B = 4: two waves, 73 % full
        (torch.bfloat16, 64, 128, 256, 96, ("serial",)),            # a chunk past 128
        (torch.bfloat16, 136, 16, 64, 96, ("serial",)),             # P past 128 in bf16
        (torch.float32, 136, 16, 64, 8, ("chunked", "serial")),
        (torch.bfloat16, 12, 16, 64, 96, ()),                       # no whole 16-byte vectors
        (torch.float16, 64, 128, 128, 96, ()),
    ],
)
def test_ssd_body_for(dtype, p, n, chunk, bh, bodies):
    sms = 132  # an H100 SXM
    assert ssd.bodies_for(dtype, p, n, chunk, bh, sms) == bodies
    if bodies:
        assert ssd.body_for(dtype, p, n, chunk, bh, sms) == bodies[0]
    else:
        with pytest.raises(TypeError):
            ssd.body_for(dtype, p, n, chunk, bh, sms)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kh,d,t,lens",
    [
        (4, 8, 2, 64, 300, [1, 63, 64, 65]),       # one slot; a tile's edge ± 1
        (3, 48, 1, 128, 200, [200, 129, 7]),       # granite's MQA, ragged across the batch
        (2, 4, 1, 192, 130, [128, 130]),           # MLA's head dim
        (2, 8, 8, 112, 97, [97, 33]),              # zamba2's head dim
    ],
)
def test_decode_split_plain_matches_reference(b, h, kh, d, t, lens, dtype):
    """The partials of 1, 2, 3 and 7 ranges, combined, against the plain
    version and the JAX package's oracle, for lengths of at least 1."""
    jx, tx = inputs(11, b, h, kh, d, t, dtype, lens=lens)
    want_port = f32(da.decode_attention_plain(*tx))
    want = f32(jref.decode_attention_ref(*jx))
    for splits in (1, 2, 3, 7):
        got = f32(da.decode_attention_split_plain(*tx, splits))
        np.testing.assert_allclose(got, want_port, atol=TOL[dtype], rtol=TOL[dtype])
        np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_decode_split_plain_gives_zero_for_an_empty_row():
    """A row of length 0 gives 0, and ranges past a row's length (m = -inf,
    l = 0) leave the other rows alone."""
    _, tx = inputs(12, 3, 8, 2, 64, 256, "float32", lens=[0, 65, 256])
    got = da.decode_attention_split_plain(*tx, 4)
    assert not got[0].any()
    torch.testing.assert_close(got, da.decode_attention_plain(*tx), atol=2e-5, rtol=2e-5)


def _ssd_steps(tx, chunk, initial_state=None):
    x, dt, a, b, c = tx
    states, decays = ssd.ssd_chunk_states_plain(x, dt, a, b, chunk=chunk)
    s_in, final = ssd.ssd_state_pass_plain(states, decays, initial_state)
    return ssd.ssd_chunk_out_plain(x, dt, a, b, c, s_in, chunk=chunk), final


@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (2, 200, 3, 16, 8, 64),    # a partial last chunk
    (1, 40, 2, 32, 16, 64),    # T < chunk: one chunk
    (2, 128, 2, 16, 8, 128),
])
def test_ssd_steps_compose_to_the_reference(b, t, h, p, n, chunk):
    """The chunked body's three steps, composed, against the port's chunked
    oracle, the JAX package's sequential oracle and its Pallas kernel in
    interpret mode (which starts from zero)."""
    jx, tx = ssd_inputs(13, b, t, h, p, n)
    y, fs = _ssd_steps(tx, chunk)
    assert y.dtype == torch.float32 and fs.shape == (b, h, p, n)
    ye, fse = tref.ssd_chunked_ref(*tx, chunk=chunk)
    np.testing.assert_allclose(f32(y), f32(ye), **SSD_TOL)
    np.testing.assert_allclose(f32(fs), f32(fse), **SSD_TOL)
    for want in (jref.ssd_ref(*jx), pallas_ssd(*jx, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(f32(y), f32(want[0]), **SSD_TOL)
        np.testing.assert_allclose(f32(fs), f32(want[1]), **SSD_TOL)


def test_ssd_steps_from_an_initial_state():
    jx, tx = ssd_inputs(14, 2, 150, 3, 16, 8, with_state=True)
    y, fs = _ssd_steps(tx[:5], 64, initial_state=tx[5])
    ye, fse = jref.ssd_chunked_ref(*jx[:5], chunk=64, initial_state=jx[5])
    np.testing.assert_allclose(f32(y), f32(ye), **SSD_TOL)
    np.testing.assert_allclose(f32(fs), f32(fse), **SSD_TOL)


def test_ssd_state_pass_plain_carries_the_states():
    """S_in[0] is the initial state, S_in[c + 1] = decay[c]·S_in[c] + S_c, and
    the final state is one step past the last chunk."""
    rs = np.random.default_rng(15)
    states = torch.from_numpy(rs.standard_normal((2, 3, 2, 4, 8)).astype(np.float32))
    decays = torch.from_numpy(rs.uniform(0.1, 1.0, (2, 3, 2)).astype(np.float32))
    init = torch.from_numpy(rs.standard_normal((2, 2, 4, 8)).astype(np.float32))
    s_in, final = ssd.ssd_state_pass_plain(states, decays, init)
    torch.testing.assert_close(s_in[:, 0], init)
    for c in range(2):
        torch.testing.assert_close(s_in[:, c + 1],
                                   decays[:, c, :, None, None] * s_in[:, c] + states[:, c])
    torch.testing.assert_close(final, decays[:, 2, :, None, None] * s_in[:, 2] + states[:, 2])
