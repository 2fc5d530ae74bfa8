"""The gradient of the port's grouped matmul on the CPU: ``moe_gmm`` under
grad mode goes through ``MoeGmm``, whose backward on CPU tensors is the
plain twins (``moe_gmm_dx_plain``, ``moe_gmm_dw_plain``), against
``jax.vjp`` of the reference's ``moe_gmm_ref`` on the same numpy inputs and
cotangent, at ``tests/test_kernels.py``'s GMM tolerance (2e-4).  The
backward kernels themselves are held to the plain twins on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import moe_gmm_bwd as gb  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_kernels.py's GMM tolerance

# (tokens, d_in, d_out, group sizes)
CASES = [
    (24, 16, 8, [5, 0, 12, 0, 7]),       # empty groups between and after
    (8, 12, 20, [1, 1, 1, 1, 1, 1, 1, 1]),  # one-row groups
    (16, 8, 12, [0, 16, 0]),             # every row in one expert
    (30, 24, 40, [10, 0, 20, 0]),        # a trailing empty group
    (9, 16, 8, [1, 0, 0, 8]),            # a one-row group, then empties
]
IDS = ["empty", "one-row", "one-expert", "trailing-empty", "one-row-then-empty"]


def draw(seed, t, d_in, d_out, e):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((t, d_in)).astype(np.float32),
            (rs.standard_normal((e, d_in, d_out)) / np.sqrt(d_in)).astype(np.float32),
            rs.standard_normal((t, d_out)).astype(np.float32))


def jax_grads(x, w, sizes, dy):
    _, vjp = jax.vjp(lambda x, w: jref.moe_gmm_ref(x, w, jnp.asarray(sizes, jnp.int32)),
                     jnp.asarray(x), jnp.asarray(w))
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("wants", ["both", "x", "w"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_matches_jax_vjp(case, wants):
    """dx and dw through ``MoeGmm``; with x or w alone requiring grad, only
    that one's gradient is computed (the other leaf has none)."""
    t, d_in, d_out, sizes = case
    x, w, dy = draw(t + d_in + d_out, t, d_in, d_out, len(sizes))
    want_dx, want_dw = jax_grads(x, w, sizes, dy)
    xt = torch.from_numpy(x).requires_grad_(wants in ("both", "x"))
    wt = torch.from_numpy(w).requires_grad_(wants in ("both", "w"))
    gs = torch.tensor(sizes, dtype=torch.int32)
    out = gmm.moe_gmm(xt, wt, gs)
    assert type(out.grad_fn).__name__ == "MoeGmmBackward"
    out.backward(torch.from_numpy(dy))
    if wants in ("both", "x"):
        torch.testing.assert_close(xt.grad, torch.from_numpy(np.array(want_dx)), **TOL)
    else:
        assert xt.grad is None
    if wants in ("both", "w"):
        torch.testing.assert_close(wt.grad, torch.from_numpy(np.array(want_dw)), **TOL)
        empty = [e for e, n in enumerate(sizes) if n == 0 and e != len(sizes) - 1]
        assert not wt.grad[empty].any()  # an empty group's weight gradient is zero
    else:
        assert wt.grad is None


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_twins_match_jax_vjp_in_bf16(case):
    """The plain twins on bf16 inputs (their values rounded to bf16, the
    products in fp32 rounded once) against ``jax.vjp`` on the same values
    in fp32, within bf16's rounding of the result (2e-2)."""
    t, d_in, d_out, sizes = case
    x, w, dy = (torch.from_numpy(a).bfloat16()
                for a in draw(t + d_in + d_out, t, d_in, d_out, len(sizes)))
    want_dx, want_dw = jax_grads(x.float().numpy(), w.float().numpy(), sizes, dy.float().numpy())
    gs = torch.tensor(sizes, dtype=torch.int32)
    dx, dw = gb.moe_gmm_dx(dy, w, gs), gb.moe_gmm_dw(x, dy, gs, len(sizes))
    assert dx.dtype == dw.dtype == torch.bfloat16
    torch.testing.assert_close(dx.float(), torch.from_numpy(np.array(want_dx)), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(dw.float(), torch.from_numpy(np.array(want_dw)), atol=2e-2,
                               rtol=2e-2)


# (dtype, d_in, d_out, aligned, experts, the weight gradient's bodies in order)
DW_CHOICES = [
    (torch.bfloat16, 2048, 768, True, 128, ("wgmma", "mma", "mma_elem")),  # Qwen3-MoE
    (torch.bfloat16, 768, 2048, True, 128, ("wgmma", "mma", "mma_elem")),
    (torch.bfloat16, 200, 136, True, 4, ("wgmma", "mma", "mma_elem")),  # not multiples of 128
    (torch.bfloat16, 2048, 768, True, 1024, ("wgmma", "mma", "mma_elem")),
    (torch.bfloat16, 2048, 768, True, 1025, ("mma", "mma_elem")),  # past the shared tables
    (torch.bfloat16, 2048, 768, False, 128, ("mma_elem",)),  # off a 16-byte boundary
    (torch.bfloat16, 999, 777, True, 8, ("mma_elem",)),  # not whole 16-byte vectors
    (torch.float32, 2048, 768, True, 128, ("fp32",)),
    (torch.float16, 2048, 768, True, 128, ()),
]


@pytest.mark.parametrize("dtype,d_in,d_out,aligned,experts,want", DW_CHOICES)
def test_dw_bodies_in_order(dtype, d_in, d_out, aligned, experts, want):
    """``wgmma`` first for bf16 at whole 16-byte widths on aligned pointers
    over at most the forward's ``WGMMA_MAX_EXPERTS``; then ``mma``, then
    ``mma_elem``."""
    assert gb.dw_bodies_for(dtype, d_in, d_out, aligned, experts) == want
    assert gmm.WGMMA_MAX_EXPERTS == 1024
