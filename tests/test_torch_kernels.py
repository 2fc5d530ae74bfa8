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
