"""The port's serving cluster with its four options (gossip, prefetch,
trace, health) against the JAX package's, on the CPU in fp32.

Each cluster's ``engine.run_task`` is pinned in both packages to return
the real tokens and a fixed wall time, so the two virtual clocks are
identical; then everything the options produce must be equal: the
assignments, virtual latencies, cache hit rate and tokens, every SST row,
the prefetch stats, the health summary and the flight recorder's JSONL,
byte for byte.  The reference's own serving checks of these options
(``tests/test_engine_parity.py``, ``tests/test_prefetch.py``) follow, run
on the port; then the engine's cache pool."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as rcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.serving import HostedModel as RefHosted  # noqa: E402
from repro.serving import ServingCluster as RefCluster  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro.core.healthplane import calibrate as ref_calibrate  # noqa: E402
from repro.core.telemetry import SimReport as RefReport  # noqa: E402
from repro_torch.core.healthplane import DETECTOR_KINDS, calibrate  # noqa: E402
from repro_torch.core.telemetry import SimReport, build_spans  # noqa: E402
from repro_torch.core.types import DFG, MB, TaskSpec  # noqa: E402
from repro_torch.examples import serve_cluster as ex  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import ExecutionEngine, HostedModel, ServingCluster  # noqa: E402

WALL_S = 0.05  # the pinned wall time of every task


def options(core, which):
    """The cluster keyword arguments of option set ``which`` from ``core``."""
    out = {}
    if which in ("gossip", "all"):
        out["gossip"] = core.GossipConfig(period_s=0.05, fanout=1, seed=3)
    if which in ("prefetch", "all"):
        out["prefetch"] = core.PrefetchConfig()
    if which in ("trace+health", "all"):
        out.update(trace=True, health=True)
    return out


@pytest.fixture(scope="module")
def weights():
    """The serve example's reduced fp32 trio, weights from ``jax.random.key(mid)``."""
    return {mid: (arch, jm.init_params(REF_ARCHS[arch].reduced(dtype="float32"),
                                       jax.random.key(mid)))
            for mid, arch in ex.HOSTED_ARCHS}


def ref_hosted(weights):
    return [RefHosted(mid, REF_ARCHS[arch].reduced(dtype="float32"), p)
            for mid, (arch, p) in weights.items()]


def port_hosted(weights):
    out = []
    for mid, (arch, p) in weights.items():
        cfg = ARCHS[arch].reduced(dtype="float32")
        out.append(HostedModel(mid, cfg, params_from_numpy(jax.tree.map(np.asarray, p), cfg,
                                                           "cpu"), "cpu"))
    return out


def pin(sc):
    """Pin ``sc``'s task wall time to ``WALL_S``; the tokens stay real."""
    real = sc.engine.run_task

    def run_task(mid, prompt):
        tokens, _ = real(mid, prompt)
        return np.asarray(tokens), WALL_S

    sc.engine.run_task = run_task
    return sc


def serve(core, cluster_cls, hosted, scheduler, kw, requests, dfgs):
    """The example's run of ``requests`` with pinned wall times."""
    sc = pin(cluster_cls(core.ClusterSpec(n_workers=3, gpu_capacity_bytes=1 * core.GB),
                         hosted, scheduler=scheduler, decode_tokens=6, **kw))
    for d in dfgs:
        sc.register_pipeline(d)
    for i, (kind, prompt) in enumerate(requests):
        dfg, entry = (dfgs[0], "draft") if kind == 0 else (dfgs[1], "perceive")
        sc.submit(dfg, {entry: prompt}, origin=i % 3)
    return sc


def ref_dfgs():
    """The example's two pipelines as the reference's types."""
    out = []
    for d in ex.build_pipelines():
        tasks = [rcore.TaskSpec(**dataclasses.asdict(t)) for t in d.tasks.values()]
        out.append(rcore.DFG(d.name, tasks, d.edges))
    return out


class Served:
    """What ``SimReport`` and ``calibrate`` read of a run: its trace and
    scheduler (they join placements with spans only, no job records)."""

    def __init__(self, sc, scheduler):
        self.records, self.trace, self.scheduler = [], sc.recorder, scheduler


def rows(sst, n):
    """Every SST row: the observer's view, then each worker's own view."""
    views = [sst.view(None, 1e9)] + [sst.view(w, 1e9) for w in range(n)]
    return [[dataclasses.asdict(r) for r in v] for v in views]


@pytest.mark.parametrize("which", ["none", "gossip", "prefetch", "trace+health", "all"])
@pytest.mark.parametrize("scheduler", ["navigator", "hash"])
def test_serving_options_match_reference(weights, scheduler, which):
    requests = ex.make_requests()
    want = serve(rcore, RefCluster, ref_hosted(weights), scheduler, options(rcore, which),
                 requests, ref_dfgs())
    got = serve(tcore, ServingCluster, port_hosted(weights), scheduler,
                dict(options(tcore, which), device="cpu"), requests,
                list(ex.build_pipelines()))
    assert len(got.results) == len(want.results) == 10
    for g, w in zip(got.results, want.results):
        assert (g.dfg_name, g.assignment) == (w.dfg_name, w.assignment)
        assert g.virtual_latency_s == w.virtual_latency_s
        assert set(g.outputs) == set(w.outputs)
        for tid in w.outputs:
            np.testing.assert_array_equal(g.outputs[tid], np.asarray(w.outputs[tid]),
                                          err_msg=f"job {w.job_id} task {tid}")
    assert got.cache_hit_rate() == want.cache_hit_rate()
    assert got.workers_used() == want.workers_used()
    assert rows(got.sst, 3) == rows(want.sst, 3)
    for plane in ("prefetch_plane", "health", "recorder"):
        assert (getattr(got, plane) is None) == (getattr(want, plane) is None)
    if want.prefetch_plane is not None:
        assert dataclasses.asdict(got.prefetch_plane.stats) == \
            dataclasses.asdict(want.prefetch_plane.stats)
        assert want.prefetch_plane.stats.prefetches_completed > 0
    if want.health is not None:
        assert got.health.summary() == want.health.summary()
    if want.recorder is not None:
        jsonl = want.recorder.to_jsonl()
        assert jsonl and got.recorder.to_jsonl() == jsonl
        assert got.recorder.to_chrome_trace() == want.recorder.to_chrome_trace()
        cal = calibrate(SimReport(Served(got, scheduler)))
        assert cal.as_dict() == ref_calibrate(RefReport(Served(want, scheduler))).as_dict()
        assert cal.joined > 0 or scheduler == "hash"  # hash records no placements
    if which in ("gossip", "all"):
        assert got.sst.messages_sent == want.sst.messages_sent > 0


# ---------------------------------------------------------------------------
# the reference's own serving checks of the options, on the port
# ---------------------------------------------------------------------------
def _pipeline_dfg():
    return DFG(
        "p",
        tasks=[
            TaskSpec("a", 0.05, model_id=1, output_bytes=0.01 * MB, input_bytes=0.01 * MB),
            TaskSpec("b", 0.1, model_id=0, output_bytes=0.01 * MB),
        ],
        edges=[("a", "b")],
    )


def _hosted():
    out = []
    for mid, arch in enumerate(["mistral-nemo-12b", "mamba2-780m"]):
        cfg = ARCHS[arch].reduced(dtype="float32")
        out.append(HostedModel(mid, cfg, tm.init_params(
            cfg, torch.Generator().manual_seed(mid), "cpu"), "cpu"))
    return out


def _taxonomy(jsonl):
    """kind -> (key set, worker ids seen) over a JSONL stream."""
    tax, workers = {}, {}
    for line in jsonl.splitlines():
        d = json.loads(line)
        tax.setdefault(d["kind"], set()).update(d.keys())
        workers.setdefault(d["kind"], set()).add(d["worker"])
    return tax, workers


@pytest.fixture(scope="module")
def serving_trace():
    sc = ServingCluster(tcore.ClusterSpec(n_workers=2, gpu_capacity_bytes=1 * tcore.GB),
                        _hosted(), scheduler="navigator", decode_tokens=4, trace=True,
                        health=True, device="cpu")
    dfg = _pipeline_dfg()
    sc.register_pipeline(dfg)
    prompt = np.array([[3, 4, 5]], np.int32)
    for origin in (0, 1, 0):
        sc.submit(dfg, {"a": prompt}, origin=origin)
    return sc


#: The canonical key set of a health detector's event.
HEALTH_EVENT_KEYS = {"t", "kind", "seq", "worker", "value", "threshold", "detail"}


def test_core_lifecycle_kinds_present(serving_trace):
    core = {"job.arrive", "job.done", "sched.place", "task.start",
            "task.input", "task.done", "fetch.start", "fetch.done"}
    tax, _ = _taxonomy(serving_trace.recorder.to_jsonl())
    assert core <= set(tax), f"serving missing {core - set(tax)}"
    for kind in set(tax) & set(DETECTOR_KINDS):
        assert tax[kind] == HEALTH_EVENT_KEYS


def test_job_lifecycle_on_global_ring(serving_trace):
    _, workers = _taxonomy(serving_trace.recorder.to_jsonl())
    for kind in ("job.arrive", "job.done"):
        assert workers[kind] == {-1}


def test_spans_build_from_serving_stream(serving_trace):
    spans = build_spans(serving_trace.recorder.events())
    done = [s for s in spans.values() if s.t_done is not None]
    assert len(done) == 6  # 3 jobs x 2 tasks
    for s in done:
        assert s.t_start is not None and s.t_done >= s.t_start


def test_serving_publishes_health_digests_to_the_sst():
    sc = ServingCluster(tcore.ClusterSpec(n_workers=2, gpu_capacity_bytes=1 * tcore.GB),
                        _hosted(), scheduler="navigator", decode_tokens=4, health=True,
                        device="cpu")
    dfg = _pipeline_dfg()
    sc.register_pipeline(dfg)
    for origin in (0, 1):
        sc.submit(dfg, {"a": np.array([[1, 2]], np.int32)}, origin=origin)
    s = sc.health.summary()
    assert s["schema_version"] == 1
    assert s["fleet_job_latency"]["count"] == 2
    assert any(r.health_p99_latency_s > 0.0 for r in sc.sst.view(None, 1e9))


def test_serving_cluster_prefetch_parity():
    """The engine stages intended models at plan time and publishes the
    intent bitmap (``tests/test_prefetch.py``'s serving case)."""
    dfg = DFG(
        "pp",
        tasks=[
            TaskSpec("a", 0.05, model_id=1, output_bytes=0.01 * MB, input_bytes=0.01 * MB),
            TaskSpec("b", 0.1, model_id=0, output_bytes=0.01 * MB),
        ],
        edges=[("a", "b")],
    )
    sc = ServingCluster(tcore.ClusterSpec(n_workers=2, gpu_capacity_bytes=1 * tcore.GB),
                        _hosted(), scheduler="navigator", decode_tokens=2,
                        prefetch=tcore.PrefetchConfig(), device="cpu")
    sc.register_pipeline(dfg)
    prompts = {"a": np.array([[3, 1, 4]], np.int32)}
    r1 = sc.submit(dfg, prompts, origin=0)
    assert set(r1.assignment) == {"a", "b"}
    assert r1.outputs["b"].shape[0] == 1
    for w in range(2):
        row = sc.sst.view(None)[w]
        assert row.intent_bitmap & row.cache_bitmap == row.cache_bitmap
    r2 = sc.submit(dfg, prompts, origin=1)
    assert r2.virtual_latency_s <= r1.virtual_latency_s
    assert sc.cache_hit_rate() > 0.0
    assert sc.prefetch_plane.stats.prefetches_completed >= 1


def test_cluster_exposes_the_references_attributes():
    sc = ServingCluster(tcore.ClusterSpec(n_workers=2, gpu_capacity_bytes=1 * tcore.GB),
                        _hosted(), gossip=tcore.GossipConfig(period_s=0.05), device="cpu")
    assert isinstance(sc.sst, tcore.GossipPlane)
    assert sc.recorder is None and sc.health is None and sc.prefetch_plane is None
    dfg = _pipeline_dfg()
    sc.register_pipeline(dfg)
    for origin in (0, 1, 0):
        sc.submit(dfg, {"a": np.array([[1, 2, 3]], np.int32)}, origin=origin)
    assert sc.sst.messages_sent > 0


# ---------------------------------------------------------------------------
# the engine's cache pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "mamba2-780m", "zamba2-7b",
                                  "whisper-medium"])
def test_pooled_cache_gives_the_tokens_of_a_fresh_cache(arch):
    """A task run from a reused, zeroed cache gives the tokens of the loop
    over a freshly allocated one (the engine's loop before the pool), and
    the pool holds one cache per (model, batch, capacity)."""
    cfg = ARCHS[arch].reduced(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    engine = ExecutionEngine({0: HostedModel(0, cfg, params, "cpu")}, decode_tokens=5,
                             device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=(2, s)).astype(np.int32) for s in (7, 7, 4, 7)]

    def fresh(prompt):
        b, s = prompt.shape
        cache = tm.init_cache(cfg, b, s + 6, device="cpu")
        toks, out = torch.as_tensor(prompt), []
        for i in range(s):
            logits, cache = tm.decode_step(params, cache, toks[:, i], cfg, moe_dispatch="scan")
        nxt = torch.argmax(logits, dim=-1)
        for _ in range(5):
            out.append(nxt)
            logits, cache = tm.decode_step(params, cache, nxt, cfg, moe_dispatch="scan")
            nxt = torch.argmax(logits, dim=-1)
        return torch.stack(out, dim=1).numpy().astype(np.int32)

    caches = []
    for prompt in prompts:
        got, wall = engine.run_task(0, prompt)
        np.testing.assert_array_equal(got, fresh(prompt))
        assert got.dtype == np.int32 and wall > 0
        caches.append(engine.caches[(0, 2, prompt.shape[1] + 6)])
    assert sorted(engine.caches) == [(0, 2, 10), (0, 2, 13)]
    assert caches[0] is caches[1] is caches[3] and caches[2] is not caches[0]
    assert engine.graphs == {} and engine.captures == 0  # graphs are CUDA-only
    engine.close()
    assert engine.caches == {}
