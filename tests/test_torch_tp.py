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
    with its local length clamp(len − r·T_loc, 0, T_loc), the n records
    stacked as the all-gather leaves them, then ``combine_partials_plain``
    in slice order, against ``decode_attention_plain`` over the whole
    cache.  Rows: every slot; five slots (every slice but the first empty);
    none (0 everywhere)."""
    g = torch.Generator().manual_seed(t + h)
    q = torch.randn(3, h, d, generator=g).to(dtype)
    k = torch.randn(3, t, kh, d, generator=g).to(dtype)
    v = torch.randn(3, t, kh, d, generator=g).to(dtype)
    lens = torch.tensor([t, 5, 0], dtype=torch.int32)
    want = da.decode_attention_plain(q, k, v, lens).float()
    for n in ns:
        t_loc = t // n
        cut = [slice(r * t_loc, (r + 1) * t_loc) for r in range(n)]
        recs = [da.decode_attention_partials_plain(q, k[:, c].contiguous(), v[:, c].contiguous(),
                                                   (lens - c.start).clamp(0, t_loc)) for c in cut]
        if n > 1:  # a slice with no valid slot: -inf, 0, 0
            m, l, acc = da.unpack_partials(recs[-1])
            assert bool(torch.isinf(m[1]).all()) and not bool(l[1].any()) and not bool(acc[1].any())
        got = da.combine_partials_plain(torch.stack(recs), dtype)
        assert got.dtype == dtype
        assert within(got.float(), want, dtype), (n, float((got.float() - want).abs().max()))
        assert not bool(got[2].ne(0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_partials_record_layout_and_padding(dtype):
    """The record (B, H, D + 4) fp32: acc's D values, m, l, then two zero
    pads, a whole number of 16-byte vectors at every kernel head dim;
    ``unpack_partials`` gives views of them; ``pack_partials`` builds the
    same record from its parts; and ``combine_partials`` (on the CPU, the
    plain combine) reads the records stacked, and through a stride-0 view of
    one record repeated."""
    g = torch.Generator().manual_seed(1)
    b, h, kh, d, t = 2, 8, 2, 64, 100
    q, k, v = (torch.randn(*shape, generator=g).to(dtype)
               for shape in ((b, h, d), (b, t, kh, d), (b, t, kh, d)))
    lens = torch.tensor([100, 37], dtype=torch.int32)
    rec = da.decode_attention_partials_plain(q, k, v, lens)
    assert rec.shape == (b, h, d + 4) and rec.dtype == torch.float32 and rec.is_contiguous()
    assert (rec.shape[-1] * rec.element_size()) % 16 == 0
    assert not bool(rec[..., d + 2:].any())
    m, l, acc = da.unpack_partials(rec)
    assert m.data_ptr() == rec[..., d].data_ptr() and acc.data_ptr() == rec.data_ptr()
    assert torch.equal(da.pack_partials(m, l, acc), rec)
    scores = torch.einsum("bkgd,btkd->bkgt", q.reshape(b, kh, h // kh, d).float(),
                          k.float()) * d ** -0.5
    valid = torch.arange(t) < lens[:, None, None, None]
    top = scores.masked_fill(~valid, float("-inf")).amax(-1).reshape(b, h)
    assert torch.allclose(m, top, atol=1e-5)
    assert bool((l >= 1).all())  # the largest score's own term is exp(0)
    one = da.combine_partials(rec[None], torch.float32)
    assert torch.allclose(one, acc / l[..., None], atol=1e-6)
    assert torch.equal(da.combine_partials(rec[None].expand(4, b, h, d + 4), torch.float32),
                       da.combine_partials(torch.stack([rec] * 4), torch.float32))
    for width in (64, 112, 128, 192, 256):  # every head dim the kernels take
        assert ((width + da.RECORD_EXTRA) * 4) % 16 == 0


def test_an_empty_slice_gives_the_empty_record():
    """A slice with no valid slot, whether of zero slots or of slots past
    every row's length: m = -inf, l = 0, acc = 0, zero pads; it weighs 0 in
    the combine, and a row empty in every slice gives 0."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 32, generator=g)
    k = torch.randn(2, 64, 2, 32, generator=g)
    for kc, lens in ((k[:, :0], [5, 9]), (k, [0, 0])):
        rec = da.decode_attention_partials_plain(q, kc, kc, torch.tensor(lens, dtype=torch.int32))
        m, l, acc = da.unpack_partials(rec)
        assert rec.shape == (2, 4, 36)
        assert bool(torch.isinf(m).all()) and bool((m < 0).all())
        assert not bool(l.any()) and not bool(acc.any()) and not bool(rec[..., 34:].any())
        full = da.decode_attention_partials_plain(q, k, k, torch.tensor([64, 3], dtype=torch.int32))
        both = da.combine_partials_plain(torch.stack([full, rec]), torch.float32)
        assert torch.equal(both, da.combine_partials_plain(full[None], torch.float32))
        assert not bool(da.combine_partials_plain(rec[None], torch.float32).any())


@pytest.mark.parametrize("splits", [1, 2, 4, 16])
@pytest.mark.parametrize("name,h,kh,d,t,ns", SHAPES, ids=[s[0] for s in SHAPES])
def test_the_cluster_merge_equals_the_plain_partials_of_the_slice(name, h, kh, d, t, ns, splits):
    """The cluster body's arithmetic in PyTorch: a slice cut into ``splits``
    ranges of ``slots_per_split`` slots, each range's partials merged in
    range order (``merge_partials_plain``), against the slice's own plain
    partials (fp32, to 2e-5 of l and acc's scale; m exactly), rows full,
    short and empty; the ranges past a row's length weigh 0."""
    g = torch.Generator().manual_seed(splits + t)
    q = torch.randn(3, h, d, generator=g)
    k = torch.randn(3, t, kh, d, generator=g)
    v = torch.randn(3, t, kh, d, generator=g)
    lens = torch.tensor([t, 70, 0], dtype=torch.int32)
    want = da.decode_attention_partials_plain(q, k, v, lens)
    got = da.decode_attention_cluster_plain(q, k, v, lens, splits)
    m, l, acc = da.unpack_partials(got)
    wm, wl, wacc = da.unpack_partials(want)
    assert torch.allclose(m, wm, atol=1e-5, rtol=0) or torch.equal(m, wm)
    assert torch.allclose(l, wl, rtol=2e-5) and torch.allclose(acc, wacc, rtol=2e-5, atol=2e-5)
    assert bool(torch.isinf(m[2]).all()) and not bool(got[2].any(-1).ne(
        torch.isinf(m[2])).any())
    assert not bool(got[..., d + 2:].any())


@pytest.mark.parametrize("b,kh,t,sms,splits", [
    (2, 8, 2048, 132, 16),    # NeMo's rank at n = 16: about two CTAs an SM
    (2, 8, 2048, 66, 8),      # a card of half the SMs: half the CTAs
    (2, 1, 2048, 132, 32),    # granite's MQA: every tile its own range
    (2, 1, 2048, 16, 16),
    (2, 8, 32768, 132, 17),   # the whole kernel's choice on 132 SMs stays as it was
    (2, 8, 32768, 264, 32),
    (1, 264, 4096, 132, 1),   # B·KH already fills the card
])
def test_the_split_count_follows_the_cards_sms(b, kh, t, sms, splits):
    """``splits_for`` aims for two CTAs an SM of the card it is given; on
    132 SMs it is what the split body took before."""
    assert da.splits_for(b, kh, t, sms) == splits


H100_FITS = {1: 396, 2: 198, 4: 99, 8: 48, 16: 20}  # clusters held at once, by size


@pytest.mark.parametrize("b,kh,t,sms,fits,want", [
    (2, 8, 2048, 132, H100_FITS, 16),                # NeMo: 16 clusters of 16, two tiles a CTA
    (2, 8, 2048, 132, {**H100_FITS, 16: 12}, 8),     # 16 clusters of 16 do not fit at once
    (2, 8, 2048, 132, {1: 9, 2: 4, 4: 2, 8: 1}, 8),  # none fits at once: the largest held
    (2, 1, 2048, 132, H100_FITS, 16),                # granite: 32 tiles in a cluster of 16
    (2, 8, 2048, 66, H100_FITS, 8),                  # fewer SMs: 9 CTAs a cluster wanted
    (2, 8, 200, 132, H100_FITS, 4),                  # four tiles
    (2, 8, 0, 132, H100_FITS, 1),                    # no slot
    (1, 264, 4096, 132, H100_FITS, 1),               # B·KH fills the card
])
def test_the_cluster_size_follows_the_slice_and_the_card(b, kh, t, sms, fits, want):
    """``cluster_splits``: a power of two, at most 16, the slice's tiles and
    about two CTAs an SM, the largest whose B·KH clusters the card holds at
    once; its ranges cover the slice in whole tiles."""
    n = da.cluster_splits(b, kh, t, sms, fits)
    assert n == want and n & (n - 1) == 0
    assert n * da.slots_per_split(t, n) >= t and da.slots_per_split(t, n) % da.SPLIT_TILE == 0


def test_partials_and_combine_bodies():
    """bf16 prefers ``cluster`` and fp32 takes ``split`` alone, both within
    the split body's rows and head dims; the combine prefers ``warp`` at
    whole float4s up to 256."""
    assert da.partials_bodies_for(torch.bfloat16, 128, 4) == ("cluster", "split")
    assert da.partials_bodies_for(torch.bfloat16, 128, 128) == ("cluster", "split")
    assert da.partials_bodies_for(torch.bfloat16, 128, 129) == ()
    assert da.partials_bodies_for(torch.float32, 128, 48) == ("split",)
    assert da.partials_bodies_for(torch.float32, 64, 65) == ()
    assert da.partials_bodies_for(torch.bfloat16, 264, 4) == ()
    assert da.combine_bodies_for(128) == ("warp", "block")
    assert da.combine_bodies_for(256) == ("warp", "block")
    assert da.combine_bodies_for(258) == ("block",) and da.combine_bodies_for(6) == ("block",)


def test_t_split_decode_attention_calls_one_partials_and_one_combine_a_layer(monkeypatch):
    """``t_split_decode_attention`` over a one-rank ``model`` (the (1, 1)
    mesh's gather is the identity) calls the partials once and the combine
    once, on the record itself: no concatenation, no copy and no other op
    between them; the output is the plain decode over the slice."""
    import types

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import ops
    from repro_torch.models.layers import t_split_decode_attention

    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 8, 32, generator=g)
    k = torch.randn(2, 40, 2, 32, generator=g)
    lens = torch.tensor([40, 9], dtype=torch.int32)
    calls, seen = [], []
    real = (ops.decode_attention_partials, ops.combine_partials)

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            seen.append(func._overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    def partials(*args, **kwargs):
        calls.append("partials")
        with _off():
            return real[0](*args, **kwargs)

    def combine(rec, dtype, **kwargs):
        calls.append(("combine", rec.shape, rec.data_ptr()))
        with _off():
            return real[1](rec, dtype, **kwargs)

    monkeypatch.setattr(ops, "decode_attention_partials", partials)
    monkeypatch.setattr(ops, "combine_partials", combine)
    one_rank = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    with Ops():
        out = t_split_decode_attention(q, k, k, lens, 0, one_rank)
    assert calls[0] == "partials" and calls[1][0] == "combine" and len(calls) == 2
    assert calls[1][1] == (1, 2, 8, 32 + 4)
    assert not {"cat", "clone", "contiguous", "copy_", "stack"} & set(seen), seen
    assert torch.allclose(out, da.decode_attention_plain(q, k, k, lens), atol=1e-6)


class _off:
    """Dispatch outside any mode while a stubbed kernel entry runs."""

    def __enter__(self):
        from torch.utils._python_dispatch import _disable_current_modes

        self._ctx = _disable_current_modes()
        self._ctx.__enter__()

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


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
    partials = 2 * rows * cfg.n_heads * (hd + 4)  # a rank's record of (acc, m, l, two pads)
    want = [partials] * cfg.n_layers + [rows * cfg.vocab]
    if not serve_layout:  # k, v and q of the new token, a layer
        want = [rows * cfg.n_kv_heads * hd, rows * cfg.n_kv_heads * hd,
                rows * cfg.n_heads * hd, partials] * cfg.n_layers + [rows * cfg.vocab]
    assert over_model == want
    leaf = rows * cap * cfg.n_kv_heads * hd
    assert not {leaf, cfg.n_layers * leaf} & set(over_model)
    assert not weights & set(over_model)
