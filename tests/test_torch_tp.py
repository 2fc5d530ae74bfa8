"""Tensor-parallel compute over ``model`` on the CPU, in one process (the
multi-rank checks run in ``tests/test_torch_distributed.py``'s 2-rank
group): the plain partials path of decode attention over a cache split
along T, against the whole plain decode; the cache write into one rank's
slice under both update modes; the FLOPs a rank of a fake (1, 4) mesh
against a fake (1, 1) one; and the collectives of a mesh serve step, by
size: no attention cache leaf and, in the serve layout, no weight is
all-gathered over ``model``."""

import math

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import counter, dryrun  # noqa: E402
from repro_torch.launch.specs import abstract_world  # noqa: E402
from repro_torch.models import ModelConfig, abstract_params, sharding  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.layers import cache_write  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # chip_smoke.py's phase 2


def within(got, want, dtype):
    """Phase 2's check: |got - want| <= atol + tol·|want|, atol = tol in
    fp32 and, in bf16, tol scaled to each output row's largest |want|
    when that is below 1."""
    tol = TOL[dtype]
    atol = tol * want.abs().amax(dim=-1, keepdim=True).clamp(max=1.0) if dtype == torch.bfloat16 \
        else tol
    return bool(((got - want).abs() <= atol + tol * want.abs()).all())


# (name, B, H, KH, D, T, slice counts): GQA and MQA where T_loc is no
# multiple of 64 at 16 slices; whisper's 1,500 encoder frames (which 16
# does not divide)
SHAPES = [("gqa", 8, 2, 32, 208, (1, 2, 4, 16)), ("mqa", 12, 1, 32, 320, (1, 2, 4, 16)),
          ("whisper", 4, 4, 64, 1500, (1, 2, 4))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,h,kh,d,t,ns", SHAPES, ids=[s[0] for s in SHAPES])
def test_partials_then_combine_equal_the_whole_decode(name, h, kh, d, t, ns, dtype):
    """Each of n equal slices along T through ``decode_attention_partials_plain``
    with its local length clamp(len − r·T_loc, 0, T_loc), then
    ``combine_partials_plain`` in slice order, against
    ``decode_attention_plain`` over the whole cache.  Rows: every slot;
    five slots (every slice but the first empty); none (0 everywhere)."""
    g = torch.Generator().manual_seed(t + h)
    q = torch.randn(3, h, d, generator=g).to(dtype)
    k = torch.randn(3, t, kh, d, generator=g).to(dtype)
    v = torch.randn(3, t, kh, d, generator=g).to(dtype)
    lens = torch.tensor([t, 5, 0], dtype=torch.int32)
    want = da.decode_attention_plain(q, k, v, lens).float()
    for n in ns:
        t_loc = t // n
        cut = [slice(r * t_loc, (r + 1) * t_loc) for r in range(n)]
        parts = [da.decode_attention_partials_plain(q, k[:, c].contiguous(), v[:, c].contiguous(),
                                                    (lens - c.start).clamp(0, t_loc)) for c in cut]
        if n > 1:  # a slice with no valid slot: -inf, 0, 0
            m, l, acc = parts[-1]
            assert bool(torch.isinf(m[1]).all()) and not bool(l[1].any()) and not bool(acc[1].any())
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        got = da.combine_partials_plain(m, l, acc, dtype)
        assert got.dtype == dtype
        assert within(got.float(), want, dtype), (n, float((got.float() - want).abs().max()))
        assert not bool(got[2].ne(0).any())


def test_cache_write_into_a_slice_under_both_modes():
    """Writing one token into each of two slices of a cache (each from its
    first slot) gives the whole cache's write, by the indexed write and by
    the one-hot select: a row is written only into the slice that owns
    its slot."""
    g = torch.Generator().manual_seed(2)
    whole = torch.randn(3, 8, 2, 4, generator=g)
    new = torch.randn(3, 2, 4, generator=g)
    idx = torch.tensor([0, 5, 7], dtype=torch.int32)
    for mode in ("scatter", "onehot"):
        want = cache_write(whole.clone(), new, idx, mode)
        parts = [cache_write(whole[:, r * 4:(r + 1) * 4].clone(), new, idx, mode,
                             slot_offset=r * 4) for r in range(2)]
        assert torch.equal(torch.cat(parts, dim=1), want), mode


@pytest.fixture
def no_group():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


DENSE = ModelConfig(name="tp-count", arch_type="dense", n_layers=2, d_model=256, n_heads=8,
                    n_kv_heads=4, d_ff=1024, vocab=512, dtype="float32")


def test_flops_a_rank_fall_by_the_model_axis(no_group):
    """A prefill of a reduced dense config counted on fake tensors: a rank
    of a (1, 4) mesh does about a quarter of a (1, 1) rank's FLOPs (the
    norms, RoPE and residual stay replicated), within 10 %."""
    shape = InputShape("tp", 256, 2, "prefill")
    flops = {}
    for n in (1, 4):
        with abstract_world((1, n), ("data", "model")) as mesh:
            rec = dryrun.count_case(dryrun.abstract_case(DENSE, "prefill", shape), mesh, "sorted")
            flops[n] = rec["flops"]
    assert abs(flops[4] / flops[1] - 0.25) <= 0.1 * 0.25, flops


class _Collectives(counter.StepCounter):
    """A count that also lists each collective: (kind, its group's ranks,
    the numel of its result)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = func._overloadpacket
        if out is not NotImplemented and packet in counter._KINDS:
            result = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)] \
                or [x for x in tree_flatten(args[0])[0] if isinstance(x, torch.Tensor)]
            ranks = tuple(counter.group_ranks(func, args, kwargs or {}))
            self.seen.append((counter._KINDS[packet], ranks, sum(x.numel() for x in result)))
        return out


@pytest.mark.parametrize("serve_layout", [False, True], ids=["train-layout", "serve-layout"])
def test_serve_step_gathers_no_cache_leaf_and_no_weight_over_model(no_group, serve_layout):
    """One ``make_serve_step`` of a reduced dense config on a fake (2, 2)
    mesh, its collectives listed by size.  Over ``model`` (ranks 0 and 1)
    the all-gathers are activations only: in the serve layout each
    layer's (m, l, acc) partials and the logits, in the training layout
    also the new token's k, v and q; none has the size of an attention
    cache leaf or of one layer of it, nor of any weight matrix (a layer's,
    whole or a block of it)."""
    cfg, b, cap = DENSE, 4, 64
    with abstract_world((2, 2), ("data", "model")) as mesh:
        params = abstract_params(cfg)
        specs = sharding.param_pspecs(mesh, params, cfg, serve=serve_layout)
        matrices = [math.prod(t.shape[-2:]) for path, t in dryrun.opt.leaves(params)
                    if t.dim() == 2 + path.startswith("layers/")]
        weights = {n // k for n in matrices for k in (1, 2, 4)}  # a layer's, whole or a block
        params = sharding.shard_tree(params, mesh, specs)
        cache = init_cache(cfg, b, cap, device="cpu")
        cache = sharding.shard_tree(cache, mesh, sharding.cache_pspecs(mesh, cache))
        tokens = torch.zeros(b, dtype=torch.int32)
        step = make_serve_step(cfg, impl="ref", mesh=mesh, serve_layout=serve_layout)
        with _Collectives() as rec:
            step(params, cache, tokens)
    over_model = [size for kind, ranks, size in rec.seen
                  if kind == "all-gather" and ranks == (0, 1)]
    rows, hd = b // 2, cfg.hd
    partials = 2 * rows * cfg.n_heads * (hd + 2)
    want = [partials] * cfg.n_layers + [rows * cfg.vocab]
    if not serve_layout:  # k, v and q of the new token, a layer
        want = [rows * cfg.n_kv_heads * hd, rows * cfg.n_kv_heads * hd,
                rows * cfg.n_heads * hd, partials] * cfg.n_layers + [rows * cfg.vocab]
    assert over_model == want
    leaf = rows * cap * cfg.n_kv_heads * hd
    assert not {leaf, cfg.n_layers * leaf} & set(over_model)
    assert not weights & set(over_model)
