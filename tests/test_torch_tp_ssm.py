"""The Mamba-2 layer tensor parallel over ``model``, counted on fake
tensors over fake meshes in one process (the multi-rank values run in
``tests/test_torch_distributed.py``'s 2-rank group, the ``TP_CASES`` of
``tools/mesh_ranks.py``): a rank's FLOPs of a reduced mamba2 prefill at
(1, 4) against (1, 1); a serve step's collectives by size on (2, 2) in
both layouts, where no SSM cache leaf and no weight moves over ``model``;
the ``conv`` cache at (1, 3), stored split along K − 1 and gathered for
the step while ``ssm`` is not; and H that ``model`` does not divide,
where the layer runs whole on every rank."""

import math

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from test_torch_tp import _Collectives, no_group  # noqa: E402,F401

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import abstract_world  # noqa: E402
from repro_torch.models import ModelConfig, abstract_params, sharding  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402

#: mamba2-780m cut to 2 layers of d_model 256: H = 16 heads of P = 32,
#: N = 16, 1,072 ``w_in`` columns, a vocabulary of 512
SSM = ARCHS["mamba2-780m"].reduced(dtype="float32")
#: H = 3 (d_inner 48) and w_in's 115 columns, a vocabulary of 97: 2
#: divides none of them
WHOLE = ModelConfig(name="ssm-whole", arch_type="ssm", n_layers=2, d_model=24, n_heads=0,
                    n_kv_heads=0, d_ff=0, vocab=97, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
                    dtype="float32")


def prefill_count(cfg, shape):
    """(FLOPs, the collectives listed) of a prefill of B = 2, S = 256 on
    fake tensors: a rank of a fake ``shape`` mesh, or mesh-less where
    ``shape`` is None."""
    def count(mesh):
        case = dryrun.abstract_case(cfg, "prefill", InputShape("tp", 256, 2, "prefill"))
        step, args, _ = dryrun.prepare_step(case, mesh, "sorted")
        with _Collectives() as rec:
            step(*args)
        return rec.counts.flops, rec.seen

    if shape is None:
        with FakeTensorMode():
            return count(None)
    with abstract_world(shape, ("data", "model")) as mesh:
        return count(mesh)


def test_ssm_flops_a_rank_fall_by_the_model_axis(no_group):
    """A rank of a (1, 4) mesh computes 4 of the 16 heads: about a quarter
    of a (1, 1) rank's FLOPs (B and C, the norms and the residual stay
    whole on every rank), within 15 %; B·S = 512 rows pass D = 256, so
    ``w_in`` is gathered whole and multiplied by the rank's columns."""
    flops = {n: prefill_count(SSM, (1, n))[0] for n in (1, 4)}
    assert abs(flops[4] / flops[1] - 0.25) <= 0.15 * 0.25, flops


def leaf_sizes(cfg, rows, n):
    """The numels of a serve step's SSM cache leaves of ``rows`` rows,
    whole and a ``model`` rank's block, and of one layer of each."""
    cache = init_cache(cfg, rows, 8, device="meta")
    out = set()
    for key in ("conv", "ssm"):
        whole = cache[key].numel()
        out |= {whole, whole // n, whole // cfg.n_layers, whole // cfg.n_layers // n}
    return out


def weight_sizes(params):
    """The numels of every weight matrix of a layer (``conv_w`` too),
    whole or a block of it over 2 or 4 ranks."""
    matrices = [math.prod(t.shape[-2:]) for path, t in dryrun.opt.leaves(params)
                if t.dim() == 2 + path.startswith("layers/")]
    return {m // k for m in matrices for k in (1, 2, 4)}


@pytest.mark.parametrize("serve_layout", [False, True], ids=["train-layout", "serve-layout"])
def test_ssm_serve_step_gathers_no_cache_leaf_and_no_weight_over_model(no_group, serve_layout):
    """One ``make_serve_step`` of the reduced mamba2 on a fake (2, 2) mesh,
    its collectives listed by size.  Over ``model`` (ranks 0 and 1) the
    all-gathers are the logits and, in the training layout, each layer's
    ``x @ w_in`` (a rank's B_loc × 1,072 / 2 block, gathered whole before
    a rank slices its heads' columns); the serve layout sums its partials
    instead.  None has the size of an ``ssm`` or ``conv`` cache leaf or one
    layer of it, nor of any weight or weight block."""
    cfg, b = SSM, 4
    with abstract_world((2, 2), ("data", "model")) as mesh:
        params = abstract_params(cfg)
        weights = weight_sizes(params)
        params = sharding.shard_tree(params, mesh,
                                     sharding.param_pspecs(mesh, params, cfg, serve=serve_layout))
        cache = init_cache(cfg, b, 8, device="cpu")
        specs = sharding.cache_pspecs(mesh, cache)
        assert specs["ssm"][2] == "model" and specs["conv"][2] is None
        cache = sharding.shard_tree(cache, mesh, specs)
        step = make_serve_step(cfg, impl="ref", mesh=mesh, serve_layout=serve_layout)
        with _Collectives() as rec:
            step(params, cache, torch.zeros(b, dtype=torch.int32))
    over_model = [size for kind, ranks, size in rec.seen
                  if kind == "all-gather" and ranks == (0, 1)]
    rows = b // 2
    proj = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads
    want = [] if serve_layout else [rows * proj] * cfg.n_layers
    assert over_model == want + [rows * cfg.vocab]
    assert not leaf_sizes(cfg, rows, 2) & set(over_model)
    assert not weights & set(over_model)


def test_conv_is_gathered_at_three_model_ranks_and_ssm_is_not(no_group):
    """At |model| = 3 the reference's rule splits the ``conv`` cache along
    its K − 1 = 3 (its dim 2) and the ``ssm`` cache by heads (H = 6): the
    serve step gathers ``conv`` over ``model`` (decode reads its window
    whole) and writes each rank's part back, and leaves ``ssm`` where it
    lies, each rank computing its 2 heads."""
    cfg = ModelConfig(name="ssm-3", arch_type="ssm", n_layers=2, d_model=48, n_heads=0,
                      n_kv_heads=0, d_ff=0, vocab=96, ssm_state=12, ssm_head_dim=16,
                      ssm_chunk=8, dtype="float32")
    b = 2
    with abstract_world((1, 3), ("data", "model")) as mesh:
        assert sharding.ssm_heads(cfg, mesh) == (0, 2)
        params = abstract_params(cfg)
        params = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
        cache = init_cache(cfg, b, 8, device="cpu")
        conv, ssm = cache["conv"].numel(), cache["ssm"].numel()
        specs = sharding.cache_pspecs(mesh, cache)
        assert specs["conv"][2] == "model" and specs["ssm"][2] == "model"
        cache = sharding.shard_tree(cache, mesh, specs)
        with _Collectives() as rec:
            make_serve_step(cfg, impl="ref", mesh=mesh)(params, cache,
                                                         torch.zeros(b, dtype=torch.int32))
    gathered = [size for kind, ranks, size in rec.seen
                if kind == "all-gather" and ranks == (0, 1, 2)]
    assert gathered.count(conv) == 1, gathered
    assert not {ssm, ssm // 3, ssm // cfg.n_layers, ssm // cfg.n_layers // 3} & set(gathered)


def test_heads_that_model_does_not_divide_run_whole(no_group):
    """H = 3 over 2 ``model`` ranks: ``ssm_heads`` is None (16 heads give
    each rank 8) and every rank runs the whole layer, as the mesh-less
    forward does: the same FLOPs (with a vocabulary of 97 nothing else
    splits either), with ``w_out``, stored row-split since 2 divides
    d_inner = 48, gathered whole over ``model``: each layer's 48 × 24
    among the all-gathers."""
    with abstract_world((1, 2), ("data", "model")) as mesh:
        m = sharding.model_rank(mesh)[0]
        assert sharding.ssm_heads(WHOLE, mesh) is None
        assert sharding.ssm_heads(SSM, mesh) == (8 * m, 8 * m + 8)
    flops, _ = prefill_count(WHOLE, None)
    flops_2, seen = prefill_count(WHOLE, (1, 2))
    assert flops_2 == flops
    over_model = [size for kind, ranks, size in seen if kind == "all-gather" and ranks == (0, 1)]
    assert over_model.count(WHOLE.d_inner * WHOLE.d_model) == WHOLE.n_layers, over_model


# (H of the call, CTAs an SM of the fused body, SMs, the body wanted): one
# rank's heads at |model| = 16 (mamba2's 3, zamba2's 7) and the whole
# calls, B = 2, T = 2,048 in chunks of 128 (16 chunks)
FUSED_CHOICE = [
    ("mamba2 rank", 3, 1, 132, "fused"),     # 96 CTAs: one wave at one an SM
    ("mamba2 rank", 3, 1, 66, "chunked"),    # half the SMs: two waves
    ("mamba2 rank", 3, 2, 66, "fused"),      # ... unless two fit an SM
    ("zamba2 rank", 7, 2, 132, "fused"),     # 224 CTAs at two an SM
    ("zamba2 rank", 7, 1, 132, "chunked"),
    ("zamba2 rank", 7, 2, 100, "chunked"),
    ("mamba2 whole", 48, 2, 132, "chunked"),  # 1,536 CTAs
    ("zamba2 whole", 112, 2, 132, "chunked"),  # 3,584 CTAs
    ("not known", 3, 0, 132, "chunked"),     # no occupancy read: not preferred
]


@pytest.mark.parametrize("what,h,per_sm,sms,want", FUSED_CHOICE,
                         ids=[f"{c[0]}-{c[3]}sms-{c[2]}" for c in FUSED_CHOICE])
def test_fused_is_preferred_where_a_ranks_grid_fits_one_wave(what, h, per_sm, sms, want):
    """bf16 takes the fused body only where B·H·chunks CTAs fit one wave at
    its CTAs an SM on the card's SMs, and prefers it there, the chunked
    body second; elsewhere the chunked body, and fused is not named; fp32
    never takes the fused body."""
    b, p, n, chunk, chunks = 2, 64, 128, 128, 16
    found = ssd.bodies_for(torch.bfloat16, p, n, chunk, b * h, sms, chunks, per_sm)
    assert found == (("fused", "chunked", "serial") if want == "fused" else ("chunked", "serial"))
    assert ssd.body_for(torch.bfloat16, p, n, chunk, b * h, sms, chunks, per_sm) == want
    assert "fused" not in ssd.bodies_for(torch.float32, p, n, chunk, b * h, sms, chunks, per_sm)
    assert ssd.bodies_for(torch.bfloat16, p, n, 256, b * h, sms, chunks, per_sm) == ("serial",)


@pytest.mark.parametrize("b,t,want", [(1, 256, "fused"), (1, 512, "chunked"),
                                       (2, 2048, "chunked")])
def test_a_short_one_card_call_fits_one_wave(b, t, want):
    """The choice reads the grid, not the mesh: mamba2's 48 heads on one
    card at B = 1, T = 256 are 96 CTAs, one wave at one an SM, and take the
    fused body (its bits are the chunked body's); at T = 512, and at
    phase 3b's B = 2, T = 2,048, the whole call stays on chunked."""
    chunks = -(-t // 128)
    assert ssd.body_for(torch.bfloat16, 64, 128, 128, b * 48, 132, chunks, 1) == want


@pytest.mark.parametrize("p,ctas,sms,per_sm,want", [
    (64, 96, 132, {2: 2, 4: 2}, 2),    # mamba2's rank: 192 CTAs at two an SM
    (64, 96, 132, {2: 1, 4: 2}, 1),    # one an SM: 192 do not fit
    (64, 224, 132, {2: 2}, 1),         # zamba2's rank: 448 do not fit
    (32, 48, 132, {2: 2}, 2),          # 16 columns each
    (16, 48, 132, {2: 4}, 1),          # 8 columns are no whole 16-column tile
    (64, 0, 132, {}, 1),
])
def test_the_fused_split_fills_one_wave(p, ctas, sms, per_sm, want):
    """``fused_split``: the most CTAs a chunk, up to ``FUSED_MAX_SPLIT``,
    whose shares of P are whole 16-column tiles and whose grid fits one
    wave at the CTAs an SM of that split."""
    assert ssd.FUSED_MAX_SPLIT == 2
    assert ssd.fused_split(p, ctas, sms, per_sm) == want
