"""The port's serve example against the JAX package's, with the same
weights and the same seed-0 requests: per-request assignments, the cache
hit rate, the workers used and the generated tokens (fp32, on the CPU).
Virtual latencies include each task's measured wall time, so they are
not compared; placements do not depend on them in this synchronous engine."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.serving import HostedModel as RefHosted  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import ClusterSpec, GB  # noqa: E402
from repro_torch.examples import serve_cluster as port_example  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import ExecutionEngine, HostedModel, ServingCluster  # noqa: E402

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "serve_cluster.py"


@pytest.fixture(scope="module")
def ref_example():
    spec = importlib.util.spec_from_file_location("ref_serve_cluster", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    """The reference example's weights: its configs, ``jax.random.key(mid)``."""
    out = {}
    for mid, arch in port_example.HOSTED_ARCHS:
        rcfg = REF_ARCHS[arch].reduced(dtype="float32")
        out[mid] = (arch, rcfg, jm.init_params(rcfg, jax.random.key(mid)))
    return out


def test_example_pipelines_and_requests_match_reference(ref_example):
    for got, want in zip(port_example.build_pipelines(), ref_example.build_pipelines()):
        assert got.name == want.name and got.edges == want.edges
        assert [vars(t) for t in got.tasks.values()] == [vars(t) for t in want.tasks.values()]
    rng = np.random.default_rng(0)
    want = [(int(rng.integers(0, 2)), rng.integers(1, 64, size=(2, 12)).astype(np.int32))
            for _ in range(10)]
    got = port_example.make_requests()
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32


@pytest.mark.parametrize("scheduler", ["navigator", "hash"])
def test_serving_matches_reference(ref_example, weights, scheduler):
    requests = port_example.make_requests()

    def ref_hosted():
        return [RefHosted(mid, rcfg, p) for mid, (_, rcfg, p) in weights.items()]

    def port_hosted():
        return [
            HostedModel(mid, ARCHS[arch].reduced(dtype="float32"),
                        params_from_numpy(jax.tree.map(np.asarray, p),
                                          ARCHS[arch].reduced(dtype="float32"), "cpu"),
                        "cpu")
            for mid, (arch, _, p) in weights.items()
        ]

    want, _, _ = ref_example.run(scheduler, requests, ref_hosted)
    got, _, _ = port_example.run(scheduler, requests, port_hosted, device="cpu")
    assert [h.size_bytes for h in got.hosted.values()] == \
        [h.size_bytes for h in want.hosted.values()]
    assert len(got.results) == len(want.results) == 10
    for g, w in zip(got.results, want.results):
        assert (g.dfg_name, g.assignment) == (w.dfg_name, w.assignment)
        assert set(g.outputs) == set(w.outputs)
        for tid in w.outputs:
            assert g.outputs[tid].dtype == np.int32
            np.testing.assert_array_equal(g.outputs[tid], np.asarray(w.outputs[tid]),
                                          err_msg=f"job {w.job_id} task {tid}")
    assert got.cache_hit_rate() == want.cache_hit_rate()
    assert got.workers_used() == want.workers_used()


def test_serving_cluster_without_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cluster = ClusterSpec(n_workers=2, gpu_capacity_bytes=1 * GB)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingCluster(cluster, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExecutionEngine({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_example.reduced_hosted("cuda")


def test_engine_rejects_a_model_on_another_device():
    hosted = port_example.reduced_hosted("cpu")
    hosted[0].device = torch.device("meta")
    with pytest.raises(ValueError, match="hosted on"):
        ExecutionEngine({h.model_id: h for h in hosted}, device="cpu")


def test_reduced_example_runs_with_port_weights():
    """The example as its module runs it: weights from torch generators."""
    sc, total, makespan = port_example.run(
        "navigator", port_example.make_requests(n=3),
        lambda: port_example.reduced_hosted("cpu"), device="cpu",
    )
    assert len(sc.results) == 3 and total >= makespan > 0
    for r in sc.results:
        for out in r.outputs.values():
            assert out.shape == (2, 6) and out.dtype == np.int32
