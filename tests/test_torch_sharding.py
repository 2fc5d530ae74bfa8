"""The port's partition rules (``repro_torch.models.sharding``) against the
reference's (``repro.models.sharding``): params (train and serve layouts),
batches and decode caches of all ten configs at full size, spec by spec,
on the reference's ``AbstractMesh`` of (1, 1), (2, 1), (16, 16) and
(2, 16, 16) (no devices: the rules read axis names and sizes).  Trees come
from ``jax.eval_shape`` on the reference's side and from ``param_spec`` and
``init_cache`` on the ``meta`` device on the port's.  Then the specs as
DTensor placements, and each rank's block against a numpy slicing
oracle."""

import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import sharding as rs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import sharding as ts  # noqa: E402
from repro_torch.models.model import param_spec  # noqa: E402

NAMES = sorted(ARCHS)
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x1": ((2, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
BATCH, SEQ, CAPACITY = 32, 128, 1024
POD_2_4_8 = AbstractMesh((2, 4, 8), ("pod", "data", "model"))


def abstract_mesh(key):
    return AbstractMesh(*MESHES[key])


def ref_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(s)
            for path, s in flat}


def port_flat(specs, prefix=""):
    out = {}
    for k, v in specs.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(port_flat(v, path) if isinstance(v, dict) else {path: tuple(v)})
    return out


def meta_tree(spec):
    return {k: meta_tree(v) if isinstance(v, dict) else
            torch.empty(v[0], dtype=v[1], device="meta") for k, v in spec.items()}


@functools.lru_cache(maxsize=None)
def trees(name):
    """(reference params, port params, reference cache, port cache,
    reference batch, port batch), all shapes only."""
    rcfg, cfg = REF_ARCHS[name], ARCHS[name]
    rp = jm.abstract_params(rcfg)
    tp = meta_tree(param_spec(cfg))
    rc = jax.eval_shape(lambda: jm.init_cache(rcfg, BATCH, CAPACITY))
    tc = tm.init_cache(cfg, BATCH, CAPACITY, device="meta")
    shapes = {"tokens": ((BATCH, SEQ), np.int32), "odd": ((3, SEQ), np.int32)}
    if cfg.arch_type == "vlm":
        shapes["vision_embeds"] = ((BATCH, 9, cfg.d_model), np.float32)
    if cfg.arch_type == "audio":
        shapes["audio_frames"] = ((BATCH, cfg.n_audio_frames, cfg.d_model), np.float32)
    rb = {k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in shapes.items()}
    tb = {k: torch.empty(s, device="meta") for k, (s, _) in shapes.items()}
    return rp, tp, rc, tc, rb, tb


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
def test_param_pspecs_match_the_reference(name, mesh, serve):
    rp, tp = trees(name)[:2]
    m = abstract_mesh(mesh)
    want = ref_flat(rs.param_pspecs(m, rp, REF_ARCHS[name], serve=serve))
    got = port_flat(ts.param_pspecs(m, tp, ARCHS[name], serve=serve))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cache_and_batch_pspecs_match_the_reference(name, mesh):
    _, _, rc, tc, rb, tb = trees(name)
    m = abstract_mesh(mesh)
    assert port_flat(ts.cache_pspecs(m, tc)) == ref_flat(rs.cache_pspecs(m, rc))
    assert port_flat(ts.batch_pspecs(m, tb)) == ref_flat(rs.batch_pspecs(m, rb))


def test_the_rules_shard_at_production_size():
    """On the (16, 16) pod NeMo's big matrices are split two ways, its
    norms replicated and its cache split over batch and sequence."""
    m = abstract_mesh("16x16")
    _, tp, _, tc, _, _ = trees("mistral-nemo-12b")
    specs = ts.param_pspecs(m, tp)
    assert specs["layers"]["wq"] == ts.P(None, "data", "model")
    assert ts.param_pspecs(m, tp, serve=True)["layers"]["wq"] == ts.P(None, "model", "data")
    assert specs["layers"]["ln1"] == ts.P(None, None)
    assert ts.cache_pspecs(m, tc)["k"] == ts.P(None, "data", "model", None, None)


# ---------------------------------------------------------------------------
# placements and each rank's block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,want", [
    (ts.P(None, "model"), [Replicate(), Replicate(), Shard(1)]),
    (ts.P(("pod", "data"), None), [Shard(0), Shard(0), Replicate()]),
    (ts.P("data", "model", None), [Replicate(), Shard(0), Shard(1)]),
    (ts.P(None, None), [Replicate(), Replicate(), Replicate()]),
])
def test_placements(spec, want):
    assert ts.placements(POD_2_4_8, spec) == want


def test_placements_refuse_a_tuple_out_of_the_mesh_order():
    with pytest.raises(ValueError, match="order"):
        ts.placements(POD_2_4_8, ts.P(("data", "pod"), None))


def test_partition_spec_reads_as_the_reference():
    assert tuple(ts.P(("data",), None, ("pod", "data"))) == \
        tuple(jax.sharding.PartitionSpec(("data",), None, ("pod", "data")))


def oracle_block(arr, sizes, coords, spec):
    """The block by index arithmetic: for each tensor dim, the flat index of
    the coordinates of its axes (major to minor) picks one of
    prod(sizes) equal blocks."""
    index = []
    for i, entry in enumerate(spec):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        flat = int(np.ravel_multi_index([coords[a] for a in axes], [sizes[a] for a in axes])) \
            if axes else 0
        step = arr.shape[i] // n
        index.append(slice(flat * step, (flat + 1) * step))
    return arr[tuple(index)]


@pytest.mark.parametrize("spec", [
    ts.P(("pod", "data"), "model", None),
    ts.P(None, ("pod", "data"), "model"),
    ts.P("model", None, "data"),
    ts.P(None, None, None),
    ts.P("pod", None, ("data", "model")),
])
def test_local_shard_matches_a_numpy_oracle(spec):
    sizes = {"pod": 2, "data": 2, "model": 2}
    arr = np.arange(8 * 8 * 8, dtype=np.float32).reshape(8, 8, 8)
    t = torch.from_numpy(arr)
    for c in itertools.product(range(2), repeat=3):
        coords = dict(zip(sizes, c))
        block = ts.local_shard(t, sizes, coords, spec)
        want = oracle_block(arr, sizes, coords, spec)
        np.testing.assert_array_equal(block.numpy(), want)
    # every element is held: the blocks of the distinct coordinates tile the array
    held = {tuple(ts.local_shard(t, sizes, dict(zip(sizes, c)), spec).flatten().tolist())
            for c in itertools.product(range(2), repeat=3)}
    assert sorted(x for block in held for x in block) == sorted(set(arr.flatten().tolist()))


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "qwen3-moe-30b-a3b", "zamba2-7b"])
def test_local_shards_of_a_real_tree_match_the_oracle(name):
    """Every leaf of a reduced config's params on a (2, 2) mesh, every
    rank's block by both."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sizes = {"data": 2, "model": 2}
    specs = port_flat(ts.param_pspecs(AbstractMesh((2, 2), ("data", "model")), params, cfg))
    for path, leaf in dict(params.named_parameters()).items():
        spec = specs[path.replace(".", "/")]
        for c in itertools.product(range(2), repeat=2):
            coords = dict(zip(sizes, c))
            np.testing.assert_array_equal(ts.local_shard(leaf.detach(), sizes, coords, spec).numpy(),
                                          oracle_block(leaf.detach().numpy(), sizes, coords, spec))


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_perf_variants.py, tests/test_training.py)
# ---------------------------------------------------------------------------
def test_serve_layout_pspecs_put_tp_on_contraction():
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(device="cpu")
    cfg = ARCHS["mistral-nemo-12b"].reduced()
    params = meta_tree(param_spec(cfg))
    train = ts.param_pspecs(mesh, params, cfg, serve=False)
    serve = ts.param_pspecs(mesh, params, cfg, serve=True)
    assert port_flat(train).keys() == port_flat(serve).keys()
    assert all(isinstance(s, ts.PartitionSpec) for s in port_flat_tensors(serve).values())


@pytest.mark.parametrize("arch", ["llama3-405b", "deepseek-v2-236b", "mamba2-780m",
                                  "zamba2-7b", "whisper-medium"])
def test_param_pspecs_cover_tree(arch):
    """Every param leaf gets a spec of matching rank; large matrices are
    actually sharded on a >1 mesh."""
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(device="cpu")
    cfg = ARCHS[arch].reduced()
    params = meta_tree(param_spec(cfg))
    flat_p = port_flat_tensors(params)
    flat_s = port_flat(ts.param_pspecs(mesh, params, cfg))
    assert flat_p.keys() == flat_s.keys()
    for path, t in flat_p.items():
        assert len(flat_s[path]) <= t.dim(), (arch, path)
    big = port_flat(ts.param_pspecs(AbstractMesh((2, 2), ("data", "model")), params, cfg))
    assert any(any(e is not None for e in s) for s in big.values())


def port_flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(port_flat_tensors(v, path) if isinstance(v, dict) else {path: v})
    return out
