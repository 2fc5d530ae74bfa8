"""The gradient of the port's SSD scan on the CPU: the plain backward
``ssd_scan_bwd_plain`` against ``jax.vjp`` of the reference's
``ssd_chunked_ref``, on the same numpy inputs and cotangents for y and the
final state, and the autograd Function that ``ssd_scan`` goes through
under grad mode against autograd through the port's ``ssd_chunked_ref``.
Tolerance: ``tests/test_kernels.py``'s 5e-5 absolute and 5e-4 relative,
the absolute part scaled to each tensor's largest magnitude.  bf16 inputs
(their values rounded to bf16) are compared in fp32: the backward's
arithmetic is fp32 either way.  The backward kernel itself is held to the
plain backward on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as sb  # noqa: E402

ATOL, RTOL = 5e-5, 5e-4  # tests/test_kernels.py's SSD tolerance
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("dx", "ddt", "da", "db", "dc", "d_init")

# (b, t, h, p, n, chunk, initial_state, groups): T a multiple of the chunk
# and ragged, chunk 64 and 128, several heads, b and c from one group
CASES = [
    (2, 128, 3, 8, 4, 64, False, 3),
    (2, 150, 3, 8, 4, 64, True, 3),      # ragged, from a given state
    (1, 256, 2, 16, 8, 128, True, 2),
    (2, 200, 4, 8, 8, 128, False, 1),    # ragged; b and c broadcast from one group
    (1, 77, 4, 4, 4, 64, True, 1),       # ragged, one group, a given state
    (2, 40, 2, 8, 4, 64, False, 2),      # one chunk shorter than the chunk length
]
IDS = ["even-64", "ragged-64-state", "even-128-state", "ragged-128-group",
       "ragged-64-group-state", "short"]


def draw(seed, b, t, h, p, n, groups):
    """x, dt, a, b and c per group, the initial state, and the cotangents of y
    and of the final state, as fp32 numpy arrays."""
    rs = np.random.default_rng(seed)

    def normal(*shape, scale=0.5):
        return (rs.standard_normal(shape) * scale).astype(np.float32)

    dt = np.log1p(np.exp(rs.standard_normal((b, t, h)))).astype(np.float32)  # softplus
    a = -np.exp(rs.standard_normal(h) * 0.3).astype(np.float32)
    return dict(x=normal(b, t, h, p), dt=dt, a=a, bg=normal(b, t, groups, n),
                cg=normal(b, t, groups, n), init=normal(b, h, p, n), dy=normal(b, t, h, p),
                dstate=normal(b, h, p, n))


def rounded(arrs, dtype):
    """The arrays whose dtype the scan takes in ``dtype`` (x, b, c and dy)
    rounded to it; dt, a and the states stay fp32."""
    if dtype == "float32":
        return arrs
    return {k: (np.asarray(torch.from_numpy(v).bfloat16().float()) if k in ("x", "bg", "cg", "dy")
                else v) for k, v in arrs.items()}


def assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want)
    bad = err > ATOL * scale + RTOL * np.abs(want)
    assert not bad.any(), f"{what}: max err {float(err.max()):.3e} (scale {scale:.3e})"


def jax_grads(arrs, h, chunk, with_state):
    """The reference's gradients by ``jax.vjp``, with b and c per group."""
    groups = arrs["bg"].shape[2]

    def f(x, dt, a, bg, cg, init):
        b = jnp.repeat(bg, h // groups, axis=2)
        c = jnp.repeat(cg, h // groups, axis=2)
        return jref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk,
                                    initial_state=init if with_state else None)

    primals = [jnp.asarray(arrs[k]) for k in ("x", "dt", "a", "bg", "cg", "init")]
    _, vjp = jax.vjp(f, *primals)
    return vjp((jnp.asarray(arrs["dy"]), jnp.asarray(arrs["dstate"])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case, dtype):
    b, t, h, p, n, chunk, with_state, groups = case
    arrs = rounded(draw(sum(case[:6]), b, t, h, p, n, groups), dtype)
    want = jax_grads(arrs, h, chunk, with_state)
    tt = {k: torch.from_numpy(v) for k, v in arrs.items()}
    x, bg, cg, dy = (tt[k].to(TORCH_DT[dtype]) for k in ("x", "bg", "cg", "dy"))
    bb = torch.repeat_interleave(bg, h // groups, dim=2)
    cc = torch.repeat_interleave(cg, h // groups, dim=2)
    init = tt["init"] if with_state else None
    states = ssd.ssd_state_pass_plain(
        *ssd.ssd_chunk_states_plain(x, tt["dt"], tt["a"], bb, chunk=chunk), init)[0]
    got = sb.ssd_scan_bwd_plain(x, tt["dt"], tt["a"], bb, cc, init, states, dy, tt["dstate"],
                                chunk=chunk)
    dx, ddt, da, db, dc, d_init = got
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    assert (d_init is None) == (not with_state)
    grouped = [dx, ddt, da,
               db.reshape(b, t, groups, h // groups, n).sum(3),
               dc.reshape(b, t, groups, h // groups, n).sum(3)]
    for name, g, w in zip(NAMES, grouped, want):
        assert tuple(g.shape) == w.shape, name
        assert_close(g.numpy(), w, name)
    if with_state:
        assert_close(d_init.numpy(), want[5], "d_init")


@pytest.mark.parametrize("case", [CASES[1], CASES[3]], ids=[IDS[1], IDS[3]])
def test_function_equals_autograd_through_the_ports_reference(case):
    """``ssd_scan`` under grad mode on the CPU (``SsdScan``: the plain
    forward and the plain backward) gives autograd's gradients through the
    port's ``ssd_chunked_ref``, for y and the final state together and for
    y alone (no cotangent of the state)."""
    b, t, h, p, n, chunk, with_state, groups = case
    arrs = draw(sum(case[:6]), b, t, h, p, n, h)
    names = ("x", "dt", "a", "bg", "cg") + (("init",) if with_state else ())
    for outputs in ("both", "y"):
        grads = []
        for fn in (ssd.ssd_scan, tref.ssd_chunked_ref):
            leaves = [torch.from_numpy(arrs[k]).requires_grad_(True) for k in names]
            init = leaves[5] if with_state else None
            y, state = fn(*leaves[:5], chunk=chunk, initial_state=init)
            if fn is ssd.ssd_scan:
                assert type(y.grad_fn).__name__ == "SsdScanBackward"
            cots = [torch.from_numpy(arrs["dy"]), torch.from_numpy(arrs["dstate"])]
            outs = [y, state] if outputs == "both" else [y]
            torch.autograd.backward(outs, cots[:len(outs)])
            grads.append([leaf.grad for leaf in leaves])
        for name, g, w in zip(names, *grads):
            assert_close(g.numpy(), w.numpy(), f"{outputs}: {name}")


def test_gradient_is_finite_where_the_decay_passes_exps_range():
    """At full width a·dt summed over a chunk passes 88, so exp(s_i − s_j)
    above the diagonal overflows fp32: the port's ``ssd_chunked_ref``
    masks the exponent, and its gradient is finite and equals the plain
    backward's (a mask after the exp gave 0 × inf = NaN there)."""
    b, t, h, p, n, chunk = 1, 128, 2, 8, 4, 128
    arrs = draw(5, b, t, h, p, n, h)
    arrs["dt"] = arrs["dt"] + 1.0                     # ≥ 1 a step
    arrs["a"] = np.full(h, -4.0, np.float32)          # s spans ~600 over the chunk
    leaves = [torch.from_numpy(arrs[k]).requires_grad_(True)
              for k in ("x", "dt", "a", "bg", "cg")]
    y, state = tref.ssd_chunked_ref(*leaves, chunk=chunk)
    assert float(-leaves[2][0].detach() * leaves[1][..., 0].detach().sum()) > 88
    torch.autograd.backward([y, state], [torch.from_numpy(arrs["dy"]),
                                         torch.from_numpy(arrs["dstate"])])
    got = [leaf.grad for leaf in leaves]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    x, dt, a, bb, cc = (leaf.detach() for leaf in leaves)
    states = ssd.ssd_state_pass_plain(*ssd.ssd_chunk_states_plain(x, dt, a, bb, chunk=chunk))[0]
    want = sb.ssd_scan_bwd_plain(x, dt, a, bb, cc, None, states, torch.from_numpy(arrs["dy"]),
                                 torch.from_numpy(arrs["dstate"]), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert_close(g.numpy(), w.numpy(), name)


# ---------------------------------------------------------------------------
# the backward kernel's bodies, and the mma body's roundings emulated
# ---------------------------------------------------------------------------
def test_bodies_in_order():
    """bf16 runs on ``mma`` first (the fp32 body still takes it); fp32 stays
    on ``fp32``: the reference's SSD tolerance (5e-5 / 5e-4) rules out TF32;
    no other dtype has a body."""
    assert sb.bodies_for(torch.bfloat16) == ("mma", "fp32")
    assert sb.bodies_for(torch.float32) == ("fp32",)
    assert sb.bodies_for(torch.float16) == ()
    assert sb.body_for(torch.bfloat16) == "mma" and sb.body_for(torch.float32) == "fp32"
    with pytest.raises(TypeError):
        sb.body_for(torch.float16)


def two_parts(v):
    """``v`` as the mma body holds an fp32 operand: its bf16 rounding plus
    the bf16 rounding of what that left (about 2^-17 of v, against 2^-9
    for the first rounding alone)."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float()


def grad_close(got, want, name):
    """chip_smoke.py's ``ssd_grad_close``: the gradients the kernel writes
    in bf16 (dx, db, dc) within 2e-2 of the tensor's largest |want|; the
    fp32 ones (d(dt), da, the initial state's) within 5e-5 of it plus 5e-4
    of |want|.  Returns (ok, max error over the largest |want|)."""
    scale = float(want.abs().max())
    err = (got - want).abs()
    if name in ("dx", "db", "dc"):
        ok = bool((err <= 2e-2 * scale).all())
    else:
        ok = bool((err <= ATOL * scale + RTOL * want.abs()).all())
    return ok, float(err.max()) / scale


def mamba2_chunk_case():
    """mamba2-780m's chunk (L = 128, P = 64, N = 128), two chunks of two
    heads from a given state with a gradient of the final state; x, b, c
    and ȳ rounded to bf16, as the kernel reads them."""
    b, t, h, p, n, chunk = 1, 256, 2, 64, 128, 128
    arrs = rounded(draw(26, b, t, h, p, n, h), "bfloat16")
    tt = {k: torch.from_numpy(v) for k, v in arrs.items()}
    x, bb, cc, dy = (tt[k] for k in ("x", "bg", "cg", "dy"))
    states = ssd.ssd_state_pass_plain(
        *ssd.ssd_chunk_states_plain(x, tt["dt"], tt["a"], bb, chunk=chunk), tt["init"])[0]
    return (x, tt["dt"], tt["a"], bb, cc, tt["init"], states, dy, tt["dstate"]), chunk


def test_mma_body_roundings_keep_fp32_accuracy():
    """The mma body's arithmetic at mamba2's chunk: C, B, X and ȳ exact in
    bf16, every fp32 operand of a product (exp(s_i)·ȳ_i, the masked and
    weighted tiles, S_in and S̄) as its bf16 high part plus its bf16 rest
    (:func:`two_parts`), sums in fp32.  Every gradient stays within
    ``ssd_grad_close``'s tolerance of the plain backward; the largest error
    here is 5.8e-6 of a tensor's largest magnitude (db), so d(dt), da and
    the initial state's gradient keep the fp32 tolerance as well."""
    args, chunk = mamba2_chunk_case()
    want = sb.ssd_scan_bwd_plain(*args, chunk=chunk)
    got = sb.ssd_scan_bwd_plain(*args, chunk=chunk, operand=lambda kind, v: two_parts(v))
    for name, g, w in zip(NAMES, got, want):
        ok, share = grad_close(g, w, name)
        assert ok and share < 2e-5, f"{name}: {share:.2e} of its largest magnitude"


@pytest.mark.parametrize("kind,hurt", [("tile", ("dx", "db", "dc")),
                                       ("state", ("dx", "ddt", "da", "db", "dc"))])
def test_one_bf16_rounding_of_an_fp32_operand_falls_short(kind, hurt):
    """The same case with one rounding to bf16 of one kind of fp32 operand
    (the other kinds still in two parts), which is what a single product
    per operand would give.  Rounding the masked, weighted tiles once moves
    dx, db and dc by 1.6e-3, 2.2e-3 and 1.4e-3 of their largest magnitude
    (two parts: at most 5.8e-6), 8-11 % of the bf16 tolerance from that
    one rounding, and outside the fp32 tolerance; rounding S_in and S̄ once
    also moves d(dt) and da, which the kernel writes in fp32, by 4.6e-4
    and 6.0e-4, outside their tolerance of 5e-5.  Each hurt gradient is at
    least 100 times as far off as with two parts."""
    args, chunk = mamba2_chunk_case()
    want = sb.ssd_scan_bwd_plain(*args, chunk=chunk)
    two = sb.ssd_scan_bwd_plain(*args, chunk=chunk, operand=lambda k, v: two_parts(v))
    one = sb.ssd_scan_bwd_plain(
        *args, chunk=chunk,
        operand=lambda k, v: v.bfloat16().float() if k == kind else two_parts(v))
    for name, g1, g2, w in zip(NAMES, one, two, want):
        ok1, share1 = grad_close(g1, w, name)
        ok2, share2 = grad_close(g2, w, name)
        assert ok2
        if name in hurt:
            assert share1 > 100 * share2, f"{name}: {share1:.2e} against {share2:.2e}"
            fp32_ok = bool(((g1 - w).abs() <= ATOL * float(w.abs().max())
                            + RTOL * w.abs()).all())
            assert not fp32_ok, name
