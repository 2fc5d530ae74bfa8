"""The port's decode-attention oracles and its kernel's plain twin against
the JAX package's ``decode_attention_ref`` and its Pallas kernel (run in
interpret mode), on the same numpy inputs; plus the wrapper's host-side
checks and ``ssd_decode_ref`` parity.  The CUDA kernel itself runs only on
the card: see ``test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
