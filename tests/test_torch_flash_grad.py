"""The gradient of the port's flash attention on the CPU: the plain
backward ``flash_attention_bwd_plain`` against ``jax.vjp`` of the
reference's ``attention_ref`` and against autograd through the port's
plain forward, the forward's log-sum-exp, and the autograd Function that
``kops.flash_attention`` goes through under grad mode.  Inputs are drawn
from a seed with numpy and fed to both packages.  Tolerances are
``tests/test_kernels.py``'s (2e-5 in fp32, 2e-2 in bf16), scaled to each
tensor's largest magnitude.  The backward kernel itself is held to the
plain backward on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (b, sq, sk, h, kh, d, causal, window, q_offset)
CASES = [
    (2, 40, 40, 4, 4, 16, True, None, 0),      # MHA
    (2, 37, 37, 8, 2, 16, True, None, 0),      # GQA, ragged
    (1, 33, 33, 6, 1, 8, True, None, 0),       # MQA (granite's layout)
    (2, 24, 24, 4, 2, 16, False, None, 0),     # bidirectional (whisper's encoder)
    (2, 48, 48, 4, 2, 16, True, 8, 0),         # sliding window (zamba2's shared block)
    (1, 12, 30, 4, 2, 16, True, None, 18),     # Sq != Sk: a query block into a longer history
    (2, 20, 20, 4, 4, 8, True, None, -6),      # rows 0..5 see no key
    (1, 16, 40, 2, 1, 16, False, None, 0),     # cross-attention shape
]
IDS = ["mha", "gqa", "mqa", "bidir", "window", "q_offset", "unseen", "cross"]


def draw(seed, b, sq, sk, h, kh, d):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d), (b, sq, h, d))]


def assert_scaled(got, want, tol, what):
    """max |got - want| within ``tol`` times the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def torch_inputs(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]


def plain_grads(q, k, v, do, **kw):
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case, dtype):
    b, sq, sk, h, kh, d, causal, window, q_offset = case
    arrs = draw(sum(case[:6]), b, sq, sk, h, kh, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(JAX_DT[dtype]) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, **kw), jq, jk, jv)
    want = vjp(jdo)
    got = plain_grads(*torch_inputs(arrs, dtype), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TORCH_DT[dtype]
        assert_scaled(g.float().numpy(), np.asarray(w, np.float32), TOL[dtype], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd_of_the_plain_forward(case, dtype):
    """Autograd through the chunked fp32 oracle (its chunks of 16 keys
    exercise the online softmax), inputs and dO in ``dtype``."""
    b, sq, sk, h, kh, d, causal, window, q_offset = case
    arrs = draw(sum(case[:6]) + 1, b, sq, sk, h, kh, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = torch_inputs(arrs, dtype)
    leaves = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
    out = tref.attention_chunked_ref(*leaves, chunk_k=16, **kw)
    want = torch.autograd.grad(out, leaves, do.float())
    got = plain_grads(q, k, v, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_scaled(g.float().numpy(), w.numpy(), TOL[dtype], name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_lse(case):
    """The plain forward's LSE is the log-sum-exp of each query's visible
    scaled scores, -inf where it sees none; its output is unchanged."""
    b, sq, sk, h, kh, d, causal, window, q_offset = case
    q, k, v, _ = torch_inputs(draw(7, b, sq, sk, h, kh, d), "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, **kw))
    s = torch.einsum("bqhd,bkhd->bhqk", q, tref._gqa_expand(k, h)) * d ** -0.5
    mask = tref._visible(sq, sk, causal, window, q_offset, q.device)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    unseen = ~mask.any(-1)
    assert torch.isneginf(lse[:, :, unseen]).all()
    torch.testing.assert_close(lse[:, :, ~unseen], want[:, :, ~unseen], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["auto", "kernel"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kops_flash_attention_differentiates_through_the_function(case, impl):
    """Under grad mode ``kops.flash_attention`` goes through the autograd
    Function: the same output, and exactly the plain backward's gradients."""
    b, sq, sk, h, kh, d, causal, window, q_offset = case
    q, k, v, do = torch_inputs(draw(3, b, sq, sk, h, kh, d), "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = kops.flash_attention(*leaves, impl=impl, **kw)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), kops.flash_attention(q, k, v, impl=impl, **kw))
    out.backward(do)
    for leaf, want in zip(leaves, plain_grads(q, k, v, do, **kw)):
        assert torch.equal(leaf.grad, want)


@pytest.mark.parametrize("grad_mode", ["no_grad", "frozen"])
def test_no_graph_without_grad(grad_mode):
    """Under ``no_grad``, or with no input requiring grad, the call builds
    no graph (the serving and prefill path)."""
    q, k, v, _ = torch_inputs(draw(5, 2, 16, 16, 4, 2, 8), "float32")
    if grad_mode == "no_grad":
        q.requires_grad_(True)
        with torch.no_grad():
            out = kops.flash_attention(q, k, v)
    else:
        out = kops.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad


def test_bodies_for_backward():
    assert fb.body_for(torch.bfloat16, 128) == "mma"
    assert fb.body_for(torch.bfloat16, 112) == "mma"
    assert fb.body_for(torch.bfloat16, 64) == "mma"
    assert fb.bodies_for(torch.bfloat16, 192) == ("fp32",)
    assert fb.bodies_for(torch.bfloat16, 8) == ("fp32",)
    assert fb.bodies_for(torch.float32, 128) == ("fp32",)
    assert fb.bodies_for(torch.float16, 128) == ()
    with pytest.raises(TypeError):
        fb.body_for(torch.float16, 64)
