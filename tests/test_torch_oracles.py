"""Properties of the port's plain oracles (``repro_torch.kernels.ref``), the
counterparts of ``tests/test_kernels.py``'s oracle tests: SSD decode steps
compose to the scan, and hypothesis properties of attention, the SSD map
and the grouped matmul.  Inputs are numpy draws from a seed."""

import numpy as np
import pytest

from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402


def rnd(seed, shape, scale=1.0):
    rs = np.random.default_rng(seed)
    return torch.from_numpy((rs.standard_normal(shape) * scale).astype(np.float32))


def ssd_inputs(b, t, h, p, n, seed=1, a_scale=0.3):
    x = rnd(seed, (b, t, h, p), scale=0.5)
    dt = torch.nn.functional.softplus(rnd(seed + 1, (b, t, h)))
    a = -torch.exp(rnd(seed + 2, (h,), scale=a_scale))
    bb = rnd(seed + 3, (b, t, h, n), scale=0.5)
    cc = rnd(seed + 4, (b, t, h, n), scale=0.5)
    return x, dt, a, bb, cc


def test_ssd_decode_consistent_with_scan():
    """T sequential decode steps == one scan over T."""
    b, t, h, p, n = 1, 24, 2, 16, 8
    x, dt, a, bb, cc = ssd_inputs(b, t, h, p, n)
    y_scan, fs = ref.ssd_ref(x, dt, a, bb, cc)
    state = torch.zeros((b, h, p, n), dtype=torch.float32)
    ys = []
    for i in range(t):
        yi, state = ref.ssd_decode_ref(x[:, i], dt[:, i], a, bb[:, i], cc[:, i], state)
        ys.append(yi)
    torch.testing.assert_close(torch.stack(ys, dim=1), y_scan, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(state, fs, atol=1e-5, rtol=1e-4)


@settings(max_examples=20, deadline=None)
@given(s=st.integers(2, 40), h=st.sampled_from([1, 2, 4]), group=st.sampled_from([1, 2]))
def test_attention_oracle_is_convex_combination(s, h, group):
    """Attention output lies in the convex hull of V rows: max|out| ≤ max|V|."""
    kh = h // group if h % group == 0 else h
    q, k, v = rnd(10, (1, s, h, 16)), rnd(11, (1, s, kh, 16)), rnd(12, (1, s, kh, 16))
    out = ref.attention_ref(q, k, v, causal=True)
    assert float(out.abs().max()) <= float(v.abs().max()) + 1e-5


@settings(max_examples=20, deadline=None)
@given(s=st.integers(1, 32))
def test_attention_first_token_is_v0(s):
    """Causally, position 0 attends only to itself."""
    q, k, v = rnd(13, (1, s, 2, 8)), rnd(14, (1, s, 2, 8)), rnd(15, (1, s, 2, 8))
    out = ref.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out[0, 0], v[0, 0], atol=1e-5, rtol=1e-5)


@settings(max_examples=15, deadline=None)
@given(t=st.integers(1, 30), scale=st.floats(0.1, 2.0))
def test_ssd_oracle_linearity_in_x(t, scale):
    """The SSD map is linear in x for fixed (dt, a, b, c)."""
    x, dt, a, bb, cc = ssd_inputs(1, t, 1, 8, 4, seed=16, a_scale=0.2)
    y1, _ = ref.ssd_ref(x, dt, a, bb, cc)
    y2, _ = ref.ssd_ref(x * scale, dt, a, bb, cc)
    torch.testing.assert_close(y2, y1 * scale, atol=1e-4, rtol=1e-3)


@settings(max_examples=15, deadline=None)
@given(t=st.integers(1, 50), e=st.integers(1, 6), seed=st.integers(0, 100))
def test_gmm_oracle_equals_blockwise_matmul(t, e, seed):
    sizes = np.random.RandomState(seed).multinomial(t, [1 / e] * e)
    x, w = rnd(seed, (t, 8)), rnd(seed + 1, (e, 8, 4))
    out = ref.moe_gmm_ref(x, w, torch.from_numpy(sizes.astype(np.int32)))
    start = 0
    for ei, sz in enumerate(sizes):
        if sz:
            torch.testing.assert_close(out[start:start + sz], x[start:start + sz] @ w[ei],
                                       atol=1e-5, rtol=1e-5)
        start += sz
