"""The port's analysis tooling (``repro_torch.launch.specs``, ``counter``,
``dryrun``, ``roofline``, ``perf``) on the CPU.

* the cases of ``tests/test_dryrun_utils.py`` against the port: the skip
  rules, ``build_case`` for every (arch × shape), with each leaf's shape
  and dtype equal to the reference's ``jax.eval_shape`` tree, the
  accumulation counts;
* each collective kind's bytes, count and link on a fake 2×2 mesh, for a
  known ``redistribute`` and the in-place ``all_reduce``;
* the extrapolation from shallow variants equal to a direct count at a
  reduced depth
  for a dense, a hybrid and an audio config on a fake 2×2 mesh;
* fake counts equal to real CPU counts of the same step (prefill, train,
  decode; and a prefill over a real one-rank gloo mesh against a fake
  (1, 1) one);
* the grouped matmul as an op: its fake output, its flop formula against
  the real op's count, ``sorted`` bit for bit the per-group products;
* a hand-kernel launch inside a count raising; the roofline's terms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models.config import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.counter import COLLECTIVES, StepCounter  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.specs import (  # noqa: E402
    TRAIN_ACCUM,
    abstract_world,
    batch_specs,
    build_case,
    skip_reason,
)
from repro_torch.models import abstract_params, init_params  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.models.model import param_spec  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402


@pytest.fixture
def no_group():
    """A process holds one default group: drop the one an earlier test of
    this worker left (a later test starts its own), and leave none."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _leaves(tree, prefix=""):
    items = tree.items() if hasattr(tree, "items") else tree._asdict().items()
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, torch.Tensor):
            yield path, v
        else:
            yield from _leaves(v, path)


# ---------------------------------------------------------------------------
# specs: the cases of tests/test_dryrun_utils.py
# ---------------------------------------------------------------------------
def test_skip_rules():
    assert skip_reason(ARCHS["whisper-medium"], INPUT_SHAPES["long_500k"])
    assert not skip_reason(ARCHS["whisper-medium"], INPUT_SHAPES["decode_32k"])
    assert not skip_reason(ARCHS["llama3-405b"], INPUT_SHAPES["long_500k"])
    n_skipped = sum(bool(skip_reason(cfg, sh)) for cfg in ARCHS.values()
                    for sh in INPUT_SHAPES.values())
    assert n_skipped == 1  # exactly the documented whisper long_500k
    assert skip_reason(ARCHS["whisper-medium"], INPUT_SHAPES["long_500k"]) == \
        ref_specs.skip_reason(REF_ARCHS["whisper-medium"], REF_SHAPES["long_500k"])


def _ref_shapes(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_build_case_shapes(arch, shape):
    cfg = ARCHS[arch]
    sh = INPUT_SHAPES[shape]
    if skip_reason(cfg, sh):
        with pytest.raises(ValueError, match="skipped"):
            build_case(cfg, sh)
        return
    case = build_case(cfg, sh)
    assert case["kind"] == sh.kind
    leaves = list(_leaves(case["params"]))
    assert all(isinstance(t, FakeTensor) for _, t in leaves)  # no allocation
    if sh.kind in ("train", "prefill"):
        assert case["batch"]["tokens"].shape == (sh.global_batch, sh.seq_len)
        if cfg.arch_type == "vlm":
            assert "vision_embeds" in case["batch"]
        if cfg.arch_type == "audio":
            assert "audio_frames" in case["batch"]
    else:
        assert case["tokens"].shape == (sh.global_batch,)
        cache = list(_leaves(case["cache"]))
        assert all(isinstance(t, FakeTensor) for _, t in cache)
        if shape == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
            # windowed: cache time dim == window, not 524288
            assert max(t.shape[2] for _, t in cache if t.dim() > 2) <= 8192
    # leaf for leaf the reference's abstract case (its cfg adjusted alike)
    want = ref_specs.build_case(REF_ARCHS[arch], REF_SHAPES[shape])
    assert case["cfg"].sliding_window == want["cfg"].sliding_window
    got_params = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                  for p, t in leaves}
    assert got_params == _ref_shapes(want["params"])
    if sh.kind == "decode":
        assert {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for p, t in _leaves(case["cache"])} == _ref_shapes(want["cache"])
    if sh.kind == "train":
        assert case["accum_steps"] == want["accum_steps"]


def test_train_batch_divisible_for_accum():
    for arch, accum in TRAIN_ACCUM.items():
        assert INPUT_SHAPES["train_4k"].global_batch % accum == 0, arch
    assert TRAIN_ACCUM == ref_specs.TRAIN_ACCUM


def test_abstract_params_follow_param_spec():
    cfg = ARCHS["deepseek-v2-236b"]
    params = abstract_params(cfg, "cuda")  # a fake card tensor needs no card
    spec = param_spec(cfg)

    def check(tree, sp):
        for k, v in sp.items():
            if isinstance(v, dict):
                check(tree[k], v)
            else:
                t = tree[k]
                assert isinstance(t, FakeTensor) and t.device.type == "cuda"
                assert (tuple(t.shape), t.dtype) == (tuple(v[0]), v[1])

    check(params, spec)


# ---------------------------------------------------------------------------
# the counter's collectives on a fake 2x2 mesh
# ---------------------------------------------------------------------------
def test_collective_kinds_bytes_and_links(no_group):
    from torch.distributed import _functional_collectives as funcol

    with abstract_world((2, 2), ("data", "model")) as mesh:
        d = distribute_tensor(torch.empty(8, 6), mesh, [Shard(0), Shard(1)])  # local (4, 3)
        whole = distribute_tensor(torch.empty(8, 6), mesh, [Replicate(), Replicate()])
        with StepCounter() as c:
            # over model (4, 3) -> (4, 6), then over data (4, 6) -> (8, 6)
            d.redistribute(mesh, [Replicate(), Replicate()])
            # Shard(1) -> Shard(0) over model: a CPU mesh has no all-to-all,
            # so DTensor gathers (4, 3) -> (4, 6) and keeps a chunk
            d.redistribute(mesh, [Shard(0), Shard(0)])
            whole.redistribute(mesh, [Replicate(), Replicate()])  # nothing to move
            funcol.all_to_all_single(torch.empty(4, 3), None, None, (mesh, 1))
            t = torch.empty(5, dtype=torch.bfloat16)
            dist.all_reduce(t)                                     # c10d's in-place op
            dist.all_reduce(t, group=mesh.get_group("model"))
            funcol.reduce_scatter_tensor(torch.empty(4, 3), "sum", 0, (mesh, 0))
    got = c.counts.collectives
    assert got["all-gather"] == (4 * 6 + 8 * 6 + 4 * 6) * 4
    assert got["all-to-all"] == 4 * 3 * 4
    assert got["all-reduce"] == 2 * 5 * 2
    assert got["reduce-scatter"] == 2 * 3 * 4
    assert got["collective-permute"] == 0
    assert got["count"] == 7
    # four cards, one node: every group on NVLink
    assert c.counts.links["nic"] == {k: 0 for k in COLLECTIVES}
    assert c.counts.links["nvlink"] == {k: v for k, v in got.items() if k != "count"}


def test_collective_links_across_nodes(no_group):
    """On 16x16 a model group is 16 consecutive ranks (two 8-card nodes):
    across nodes, on the NIC."""
    with abstract_world((16, 16), ("data", "model")) as mesh:
        t = torch.empty(4)
        with StepCounter() as c:
            dist.all_reduce(t, group=mesh.get_group("model"))
    assert c.counts.links["nic"]["all-reduce"] == 16
    assert c.counts.links["nvlink"]["all-reduce"] == 0


def test_microbatches_split_each_ranks_rows(no_group):
    with abstract_world((2, 16, 16), ("pod", "data", "model")) as mesh:
        # 8 rows a rank: the spec's 16 microbatches become 8, one row each
        assert dryrun.rank_accum(16, 256, mesh) == 8
        assert dryrun.rank_accum(4, 256, mesh) == 4
    with abstract_world((16, 16), ("data", "model")) as mesh:
        assert dryrun.rank_accum(16, 256, mesh) == 16
        assert dryrun.rank_accum(3, 32, mesh) == 2  # 2 rows a rank
    from repro_torch.training import make_train_step

    cfg = ARCHS["mistral-nemo-12b"].reduced(dtype="float32")
    case = _real_case(cfg, "train", InputShape("t", 8, 3, "train"))
    step = make_train_step(cfg, accum_steps=2, impl="ref", device="cpu")
    with pytest.raises(ValueError, match="does not divide the 3 rows"):
        step(case["params"], opt.init(case["params"]), case["batch"])


# ---------------------------------------------------------------------------
# the extrapolation against the direct count
# ---------------------------------------------------------------------------
SMALL = {"train": InputShape("t", 32, 4, "train"), "prefill": InputShape("p", 32, 4, "prefill"),
         "decode": InputShape("d", 32, 4, "decode"),
         # a batch of one, as long_500k's: a one-deep stack would skip a copy
         "decode1": InputShape("d", 32, 1, "decode")}


@pytest.mark.parametrize("arch,depth,kind", [
    ("mistral-nemo-12b", dict(n_layers=4), "train"),
    ("mistral-nemo-12b", dict(n_layers=4), "decode"),
    ("mistral-nemo-12b", dict(n_layers=5), "decode1"),
    ("zamba2-7b", dict(n_layers=6, attn_period=3), "prefill"),
    ("zamba2-7b", dict(n_layers=6, attn_period=3), "decode1"),
    ("whisper-medium", dict(n_layers=4, n_encoder_layers=4), "prefill"),
])
def test_extrapolation_equals_direct_count(no_group, arch, depth, kind):
    cfg = ARCHS[arch].reduced(dtype="float32", **depth)
    shape = SMALL[kind]
    kind = shape.kind
    with abstract_world((2, 2), ("data", "model")) as mesh:
        case = dryrun.abstract_case(cfg, kind, shape, 2 if kind == "train" else 1, "cpu")
        direct = dryrun.count_case(case, mesh, "sorted")
        corr = dryrun.corrected_costs(cfg, kind, shape, mesh, "sorted",
                                      accum_steps=2 if kind == "train" else 1)
    for k in ("flops", "matmul_flops", "bytes_accessed", "collectives", "links",
              "state_bytes_per_device"):
        assert corr[k] == direct[k], k
    assert direct["collectives"]["count"] > 0


# ---------------------------------------------------------------------------
# fake counts against real counts of the same step
# ---------------------------------------------------------------------------
def _real_case(cfg, kind, shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, "cpu")
    rng = np.random.default_rng(seed)
    if kind == "decode":
        from repro_torch.models import init_cache
        return {"kind": kind, "cfg": cfg, "params": params,
                "cache": init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu"),
                "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape.global_batch)
                                           .astype(np.int32))}
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (shape.global_batch,
                                                                    shape.seq_len))
                                        .astype(np.int32))}
    out = {"kind": kind, "cfg": cfg, "params": params, "batch": batch}
    if kind == "train":
        out["accum_steps"] = 2
    return out


def _fake_case(cfg, kind, shape):
    case = dryrun.abstract_case(cfg, kind, shape, 2, "cpu")
    if kind == "decode":  # the real cache's capacity
        from repro_torch.launch.specs import abstract_cache
        case["cache"] = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    return case


@pytest.mark.parametrize("arch,kind,dispatch", [
    ("mistral-nemo-12b", "prefill", "sorted"),
    ("mistral-nemo-12b", "train", "sorted"),
    ("qwen3-moe-30b-a3b", "train", "sorted"),
    ("mamba2-780m", "decode", "sorted"),
    ("deepseek-v2-236b", "decode", "sorted"),
])
def test_fake_count_equals_real_count(arch, kind, dispatch):
    cfg = ARCHS[arch].reduced(dtype="float32")
    shape = SMALL[kind]
    real = dryrun.count_case(_real_case(cfg, kind, shape), None, dispatch)
    with FakeTensorMode():
        fake = dryrun.count_case(_fake_case(cfg, kind, shape), None, dispatch)
    assert fake == real
    assert real["flops"] > real["matmul_flops"] > 0


def test_fake_mesh_count_equals_real_gloo_count(no_group):
    cfg = ARCHS["mistral-nemo-12b"].reduced(dtype="float32")
    shape = SMALL["train"]
    mesh = make_debug_mesh(device="cpu")  # a one-rank gloo group
    real = dryrun.count_case(_real_case(cfg, "train", shape), mesh, "sorted")
    dist.destroy_process_group()
    with abstract_world((1, 1), ("data", "model")) as fmesh:
        fake = dryrun.count_case(_fake_case(cfg, "train", shape), fmesh, "sorted")
    assert fake == real
    assert real["collectives"]["all-reduce"] > 0  # the gradient norm's


def test_state_bytes_are_the_local_shards(no_group):
    cfg = ARCHS["mistral-nemo-12b"]
    with abstract_world((16, 16), ("data", "model")) as mesh:
        case = dryrun._shard_case(build_case(cfg, INPUT_SHAPES["train_4k"]), mesh, False)
        got = dryrun.state_bytes(case)
    n = sum(t.numel() * t.element_size() for _, t in _leaves(abstract_params(cfg)))
    params = sum(t.to_local().numel() * 2 for _, t in opt.leaves(case["params"]))
    assert got == params * 3  # bf16 params and two bf16 moments
    # every large matrix splits 256 ways; the norms are whole on each rank
    assert n / 256 <= params < n / 250


# ---------------------------------------------------------------------------
# the grouped matmul as an op
# ---------------------------------------------------------------------------
def _gmm_inputs(seed=0, t=48, d_in=16, d_out=24, sizes=(10, 0, 30, 8)):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(t, d_in, generator=gen).to(torch.bfloat16)
    w = torch.randn(len(sizes), d_in, d_out, generator=gen).to(torch.bfloat16)
    return x, w, torch.tensor(sizes, dtype=torch.int32)


@pytest.mark.parametrize("fp32", [False, True])
def test_grouped_matmul_bit_for_bit_and_grads(fp32):
    from repro_torch.kernels import moe_gmm

    x, w, gs = _gmm_inputs()
    product = ref._product(fp32)
    op = moe_gmm.moe_gmm_plain if fp32 else ref.moe_gmm_ref
    assert torch.equal(op(x, w, gs), ref.grouped_product(x, w, gs, product))
    # the gradients: autograd through the per-group products, as before the op
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    dy = torch.randn(x.shape[0], w.shape[2], generator=torch.Generator().manual_seed(1))
    dy = dy.to(torch.bfloat16)
    ref.grouped_product(xs, ws, gs, product).backward(dy)
    xo, wo = x.clone().requires_grad_(), w.clone().requires_grad_()
    op(xo, wo, gs).backward(dy)
    assert torch.equal(xo.grad, xs.grad) and torch.equal(wo.grad, ws.grad)


def test_grouped_matmul_fake_and_flops():
    x, w, gs = _gmm_inputs()
    want = 2 * x.shape[0] * x.shape[1] * w.shape[2]
    with StepCounter() as real:
        ref.moe_gmm_ref(x, w, gs)
    with FlopCounterMode(display=False) as fc:
        ref.moe_gmm_ref(x, w, gs)
    assert real.counts.matmul_flops == fc.get_total_flops() == want
    with FakeTensorMode() as mode:
        fx, fw, fgs = (mode.from_tensor(z) for z in (x, w, gs))
        with StepCounter() as fake:
            out = ref.moe_gmm_ref(fx, fw, fgs)
    assert isinstance(out, FakeTensor) and out.shape == (x.shape[0], w.shape[2])
    assert out.dtype == x.dtype
    assert fake.counts.as_record() == real.counts.as_record()
    # the backward: one more product for dx, one for dw
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    with StepCounter() as c:
        ref.moe_gmm_ref(xs, ws, gs).sum().backward()
    assert c.counts.matmul_flops == 3 * want


# ---------------------------------------------------------------------------
# the hand kernels inside a count; the roofline
# ---------------------------------------------------------------------------
def test_hand_kernel_launch_raises_inside_a_count():
    with StepCounter():
        with pytest.raises(RuntimeError, match="StepCounter"):
            _build.load("flash_attention")
    assert not _build._refusals
    # a fake card tensor on the kernel path raises too (no data to launch on)
    from repro_torch.kernels import ops
    with FakeTensorMode():
        q = torch.empty(1, 8, 2, 64, dtype=torch.bfloat16, device="cuda")
        with StepCounter():
            with pytest.raises(RuntimeError):
                ops.flash_attention(q, q, q, impl="kernel")


@pytest.mark.parametrize("entry", ["ssd_scan_bwd._entry", "ssd_scan_bwd.smem_bytes",
                                   "moe_gmm._entry", "moe_gmm_bwd._dw_entry"])
def test_backward_kernels_are_refused_inside_a_count(entry):
    """The SSD scan's and the grouped matmul's backward entries (dx runs
    on the forward's entry) load through ``_build``, so a count refuses
    them as it refuses the forward kernels."""
    import importlib

    module, fn = entry.split(".")
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    with StepCounter():
        with pytest.raises(RuntimeError, match="StepCounter"):
            getattr(mod, fn)(*((128, 64, 128) if fn == "smem_bytes" else ()))
    assert not _build._refusals


def test_roofline_terms_and_fit():
    links = {"nvlink": {k: 0 for k in COLLECTIVES}, "nic": {k: 0 for k in COLLECTIVES}}
    links["nvlink"]["all-reduce"] = 450e9
    links["nic"]["all-gather"] = 50e9
    t = roofline.terms(989e12, 3.35e12, links)
    assert t == pytest.approx({"compute": 1.0, "memory": 1.0, "collective": 3.0})
    rec = {"ok": True, "arch": "mistral-nemo-12b", "shape": "prefill_32k", "mesh": "16x16",
           "n_chips": 256, "direct": True, "flops": 989e12, "bytes_accessed": 1.0,
           "links": links, "state_bytes_per_device": 81e9, "peak_bytes": 90e9}
    a = roofline.analyze(rec)
    assert a["dominant"] == "collective" and not a["fits_hbm"] and not a["peak_fits_hbm"]
    cfg = ARCHS["mistral-nemo-12b"]
    assert a["model_flops"] == 2.0 * cfg.param_count() * 32 * 32768
    assert a["useful_ratio"] == pytest.approx(a["model_flops"] / (989e12 * 256))


def test_batch_specs_modalities():
    for arch, key in (("qwen2-vl-72b", "vision_embeds"), ("whisper-medium", "audio_frames")):
        cfg = ARCHS[arch]
        got = batch_specs(cfg, 2, 16)
        assert set(got) == {"tokens", key}
        assert got[key].dtype == torch.bfloat16 and got[key].shape[0] == 2
