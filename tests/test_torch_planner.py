"""The port's vectorized Navigator planner (``repro_torch.core.torch_planner``)
against the JAX planner (``repro.core.jax_planner``, JAX on the CPU) and
the Python Navigator, three ways at once: assignments equal, planned
finish times within rel 1e-5 (the reference's own tolerance), and the
Eq. 2 component arrays of ``return_components`` equal to the JAX
planner's.  The cases are the reference's planner cases
(``tests/test_jax_planner.py``, the liveness case of ``test_churn.py``,
the intents case of ``test_prefetch.py``, the rack case of
``test_topology.py``, the provenance case of ``test_telemetry.py``), each
run on both packages' types, and a W = 250 plan with every lane on."""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402

import repro.core as rcore  # noqa: E402
import repro.workflows as rwf  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.workflows as twf  # noqa: E402
from repro.core import jax_planner  # noqa: E402
from repro.core.packed import PackedViews as RPacked  # noqa: E402
from repro_torch.core import torch_planner  # noqa: E402
from repro_torch.core.packed import PackedViews as TPacked  # noqa: E402

GB, MB = rcore.GB, rcore.MB
#: (core, workflows, vectorized planner class, PackedViews) of each package.
SIDES = {
    "jax": (rcore, rwf, jax_planner.JaxNavigatorPlanner, RPacked),
    "torch": (tcore, twf, lambda p, c: torch_planner.TorchNavigatorPlanner(p, c, device="cpu"),
              TPacked),
}


def heavy_dfg(core):
    """``tests/test_topology.py``'s pipeline with big inter-task outputs."""
    return core.DFG(
        "heavy",
        tasks=[
            core.TaskSpec("src", 0.1, model_id=0, output_bytes=200 * MB, input_bytes=1 * MB),
            core.TaskSpec("mid", 0.1, model_id=1, output_bytes=200 * MB),
            core.TaskSpec("sink", 0.1, model_id=3, output_bytes=1 * MB),
        ],
        edges=[("src", "mid"), ("mid", "sink")],
    )


def dfgs_of(core, wf):
    return {d.name: d for d in wf.paper_dfgs() + [heavy_dfg(core)]}


def random_rows(n, seed, p_bit=0.4, lanes=False):
    """Seeded SST rows as field dicts; ``lanes`` adds intents (fresh and
    stale), in-flight fetches with ETAs, and dead and suspect rows."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        bitmap = intent = 0
        for m in range(8):
            if rng.rand() < p_bit:
                bitmap |= 1 << m
            if lanes and rng.rand() < 0.3:
                intent |= 1 << m
        row = dict(ft_estimate_s=float(rng.uniform(0, 5)), cache_bitmap=bitmap,
                   free_cache_bytes=float(rng.uniform(0, 16 * GB)))
        if lanes:
            fetch = int(rng.randint(-1, 8))
            row.update(pushed_at=float(rng.choice([1.0, -30.0])), intent_bitmap=bitmap | intent,
                       liveness=str(rng.choice(["alive", "alive", "alive", "suspect", "dead"])),
                       fetch_model_id=fetch,
                       fetch_eta_s=float(rng.uniform(0.5, 3.0)) if fetch >= 0 else 0.0)
        rows.append(row)
    return rows


@functools.lru_cache(maxsize=None)
def planners(side, cluster, cfg):
    """``side``'s profiles, Python Navigator, vectorized planner and DFGs
    on ``CLUSTERS[cluster]`` with ``NavigatorConfig(**dict(cfg))``, kept
    across cases (the JAX planner compiles once per DFG and planner)."""
    core, wf, planner, _ = SIDES[side]
    profiles = core.ProfileRepository(CLUSTERS[cluster](core), wf.MODELS)
    dfgs = dfgs_of(core, wf)
    for d in dfgs.values():
        profiles.register(d)
    config = core.NavigatorConfig(**dict(cfg))
    return profiles, core.NavigatorScheduler(profiles, config), planner(profiles, config), dfgs


def three_way(cluster, cfg_kw, rows, dfg_name, now, origin, packed=False):
    """Plans one job with each package's Python Navigator and vectorized
    planner; checks the four agree and returns the torch planner's ADFG."""
    got = {}
    for side, (core, _, _, packed_cls) in SIDES.items():
        _, py, vec, dfgs = planners(side, cluster, tuple(sorted(cfg_kw.items())))
        sst = [core.SSTRow(**r) for r in rows]
        if packed:
            sst = packed_cls.from_rows(sst, reader=origin)
        job = core.Job(0, dfgs[dfg_name], now)
        got[side] = (py.plan(job, now, origin, sst), vec.plan(job, now, origin, sst))
    (rpy, jx), (tpy, tv) = got["jax"], got["torch"]
    assert rpy.assignment == tpy.assignment
    for t in jx.assignment:
        assert tv[t] == jx[t] == tpy[t], (t, tv.assignment, jx.assignment, tpy.assignment)
        assert tv.planned_ft[t] == pytest.approx(jx.planned_ft[t], rel=1e-5)
        assert tv.planned_ft[t] == pytest.approx(tpy.planned_ft[t], rel=1e-5)
    return tv


@settings(max_examples=25, deadline=None)
@given(dfg_idx=st.integers(0, 3), seed=st.integers(0, 1000), origin=st.integers(0, 4))
def test_matches_jax_and_python(dfg_idx, seed, origin):
    """``tests/test_jax_planner.py``'s property, on three planners."""
    name = rwf.paper_dfgs()[dfg_idx].name
    three_way("flat5", dict(eviction_penalty_s=1.5), random_rows(5, seed), name, 1.0, origin)


@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
def test_matches_under_liveness(packed):
    """``tests/test_churn.py``'s liveness case: a dead worker is never
    planned, a suspect one is priced."""
    rows = [dict(free_cache_bytes=16 * GB) for _ in range(3)]
    rows[1]["liveness"] = rcore.DEAD
    rows[2]["liveness"] = rcore.SUSPECT
    adfg = three_way("flat3", dict(eviction_penalty_s=1.5, suspect_penalty_s=3.0), rows,
                     "translation", 0.0, 0, packed=packed)
    assert all(w != 1 for _, w in adfg.items())


@pytest.mark.parametrize("trial", range(15))
def test_matches_with_intents(trial):
    """``tests/test_prefetch.py``'s intents case (trial by trial)."""
    rng = np.random.RandomState(0)
    for _ in range(trial + 1):
        rows = []
        for _ in range(5):
            bitmap = intent = 0
            for m in range(8):
                if rng.rand() < 0.3:
                    bitmap |= 1 << m
                if rng.rand() < 0.3:
                    intent |= 1 << m
            rows.append(dict(ft_estimate_s=float(rng.uniform(0, 5)), cache_bitmap=bitmap,
                             free_cache_bytes=float(rng.uniform(0, 16 * GB)), pushed_at=1.0,
                             intent_bitmap=bitmap | intent))
    cfg = dict(eviction_penalty_s=1.5, intent_confidence=0.7, intent_herd_margin=0.15)
    three_way("flat5", cfg, rows, rwf.paper_dfgs()[trial % 4].name, 1.0, trial % 5)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 500), origin=st.integers(0, 7))
def test_matches_on_rack_topology(seed, origin):
    """``tests/test_topology.py``'s rack case: the (W, W) path matrices."""
    rows = random_rows(8, seed)
    for name in (rwf.paper_dfgs()[0].name, "heavy"):
        three_way("rack2", dict(eviction_penalty_s=1.5), rows, name, 1.0, origin)


def every_lane(core, n=250):
    """A rack topology of ``n`` workers with heterogeneous GPU capacity."""
    from_sizes = [n // 4] * 3 + [n - 3 * (n // 4)]
    return core.ClusterSpec(
        n_workers=n,
        worker_gpu_capacity={w: (8 * GB if w % 7 == 0 else 16 * GB) for w in range(n)},
        topology=core.rack_topology(from_sizes))


#: The clusters of the cases, built in either package's types.
CLUSTERS = {
    "flat3": lambda core: core.ClusterSpec(n_workers=3),
    "flat5": lambda core: core.ClusterSpec(n_workers=5),
    "rack2": lambda core: core.fleet("rack2"),
    "every_lane": every_lane,
}
EVERY_LANE_CFG = dict(eviction_penalty_s=1.5, intent_confidence=0.7, intent_herd_margin=0.15,
                      suspect_penalty_s=3.0)


@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("seed", range(4))
def test_matches_at_250_workers_every_lane(seed, packed):
    """W = 250 with dead and suspect rows, fresh and stale intents with
    in-flight fetch ETAs, a rack topology, heterogeneous capacity, the
    speculative cache and the anti-herd margin."""
    name = (rwf.paper_dfgs()[seed].name if seed < 4 else "heavy")
    three_way("every_lane", EVERY_LANE_CFG, random_rows(250, seed, p_bit=0.2, lanes=True), name,
              1.0, (37 * seed) % 250, packed=packed)


def feeds(n, seed):
    """One seeded feed as numpy arrays, for both ``plan_vectorized``s."""
    rng = np.random.default_rng(seed)
    return dict(
        ft0=rng.uniform(0, 5, n).astype(np.float32),
        cache_bits=rng.uniform(size=(n, 64)) < 0.3,
        avc0=rng.uniform(0, 16 * GB, n).astype(np.float32),
        intent_bits=rng.uniform(size=(n, 64)) < 0.3,
        intent_fresh=rng.uniform(size=n) < 0.7,
        liveness_cost=np.where(rng.uniform(size=n) < 0.1, np.inf,
                               np.where(rng.uniform(size=n) < 0.1, 3.0, 0.0)).astype(np.float32),
        fetch_model=rng.integers(-1, 8, n).astype(np.int32),
        fetch_eta=rng.uniform(0, 3, n).astype(np.float32),
    )


@pytest.mark.parametrize("topology", [False, True], ids=["flat", "racks"])
@pytest.mark.parametrize("dfg_idx", range(4))
def test_return_components_match_jax(dfg_idx, topology):
    """``plan_vectorized(..., return_components=True)``: the assignment,
    the planned finish times and the six (T, W) Eq. 2 component arrays
    equal the JAX planner's, on one feed given to both."""
    n = 40
    outs = {}
    for side, (core, wf, _, _) in SIDES.items():
        cluster = every_lane(core, n) if topology else core.ClusterSpec(n_workers=n)
        profiles = core.ProfileRepository(cluster, wf.MODELS)
        dfg = wf.paper_dfgs()[dfg_idx]
        profiles.register(dfg)
        cfg = core.NavigatorConfig(**EVERY_LANE_CFG)
        mod = jax_planner if side == "jax" else torch_planner
        static = mod.build_static_inputs(profiles, dfg)
        cap = np.array([cluster.gpu_capacity(w) for w in range(n)], np.float32)
        xfer = [np.asarray(a, np.float32) for a in cluster.topology.pair_matrices()] \
            if topology else [None, None]
        f = feeds(n, dfg_idx)
        if side == "jax":
            conv = jnp.asarray
            now, origin = jnp.float32(1.0), jnp.int32(3)
        else:
            conv = torch.from_numpy
            now, origin = torch.tensor(1.0), torch.tensor(3)
        out = mod.plan_vectorized(
            static, cfg, n, conv(f["ft0"]), conv(f["cache_bits"]), conv(f["avc0"]), now, origin,
            intent_bits=conv(f["intent_bits"]), intent_fresh=conv(f["intent_fresh"]),
            gpu_capacity=conv(cap), liveness_cost=conv(f["liveness_cost"]),
            xfer_inv_bw=None if xfer[0] is None else conv(xfer[0]),
            xfer_delta=None if xfer[1] is None else conv(xfer[1]),
            fetch_model=conv(f["fetch_model"]), fetch_eta=conv(f["fetch_eta"]),
            return_components=True)
        outs[side] = [np.asarray(o) for o in out]
    assert len(outs["torch"]) == len(outs["jax"]) == 8
    for j, t in zip(outs["jax"], outs["torch"]):
        assert j.shape == t.shape
        np.testing.assert_array_equal(t, j)


def test_recorder_matches_jax_and_python():
    """``tests/test_telemetry.py``'s provenance case: the recorded Eq. 2
    candidates agree with the Python Navigator's, and the recorder's JSONL
    equals the JAX planner's byte for byte (the same ``navigator-jax``
    label)."""
    jsonl = {}
    for side, (core, wf, planner, _) in SIDES.items():
        cluster = core.ClusterSpec(n_workers=3)
        profiles = core.ProfileRepository(cluster, wf.MODELS)
        for d in wf.paper_dfgs():
            profiles.register(d)
        sst = core.SharedStateTable(3)
        for w in range(3):
            sst.update_cache(w, 0b111 if w == 0 else 0, 8.0 * GB, 0.0)
            sst.push(w, 0.0)
        view = sst.view(0, 0.0)
        job = core.Job(0, wf.translation_dfg(), arrival_time=0.0)
        py = core.NavigatorScheduler(profiles)
        py.recorder = core.FlightRecorder(3)
        adfg_py = py.plan(job, 0.0, 0, view)
        vec = planner(profiles, None)
        vec.recorder = core.FlightRecorder(3)
        adfg_vec = vec.plan(job, 0.0, 0, view)
        assert vec.recorder.placements
        for tid in job.dfg.tasks:
            assert adfg_py[tid] == adfg_vec[tid]
            dp, dv = py.recorder.decisions(0, tid), vec.recorder.decisions(0, tid)
            assert len(dp) == len(dv) == 1 and dp[0].chosen == dv[0].chosen
            assert dv[0].scheduler == "navigator-jax"
            for cp, cv in zip(dp[0].candidates, dv[0].candidates):
                assert cp.worker == cv.worker
                if cp.total_s == float("inf"):
                    assert cv.total_s == float("inf")
                    continue
                assert cv.model_s == pytest.approx(cp.model_s, abs=1e-3)
                assert cv.total_s == pytest.approx(cp.total_s, abs=1e-3)
        jsonl[side] = vec.recorder.to_jsonl()
    assert jsonl["torch"] == jsonl["jax"]


def test_packed_and_row_feeds_are_equal():
    """``_pack_feed`` gives the same arrays from a row list and from its
    ``PackedViews``, and the same as the JAX planner's unpack."""
    rows = random_rows(37, 5, lanes=True)
    profiles = tcore.ProfileRepository(tcore.ClusterSpec(n_workers=37), twf.MODELS)
    rprofiles = rcore.ProfileRepository(rcore.ClusterSpec(n_workers=37), rwf.MODELS)
    tp = torch_planner.TorchNavigatorPlanner(profiles, tcore.NavigatorConfig(), device="cpu")
    jp = jax_planner.JaxNavigatorPlanner(rprofiles, rcore.NavigatorConfig())
    sst = [tcore.SSTRow(**r) for r in rows]
    a = tp._pack_feed(sst, 2.0, 37)
    b = tp._pack_feed(TPacked.from_rows(sst), 2.0, 37)
    c = jp._pack_feed([rcore.SSTRow(**r) for r in rows], 2.0, 37)
    for x, y, z in zip(a, b, c):
        assert x.dtype == y.dtype == z.dtype
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def test_cpu_plan_is_eager_and_card_is_refused_without_one():
    profiles = tcore.ProfileRepository(tcore.ClusterSpec(n_workers=4), twf.MODELS)
    tp = torch_planner.TorchNavigatorPlanner(profiles, device="cpu")
    dfg = twf.paper_dfgs()[0]
    profiles.register(dfg)
    tp.plan(tcore.Job(0, dfg, 0.0), 0.0, 0, [tcore.SSTRow() for _ in range(4)])
    assert tp.graphs == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            torch_planner.TorchNavigatorPlanner(profiles)
