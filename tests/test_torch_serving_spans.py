"""The serving path's profiler ranges (``ServingCluster(..., spans=True)``)
on the CPU: one ``compass.run_task`` a pipeline task, holding every other
range; in each one ``replay`` a step, one ``zero_cache`` and one
``to_host``; with the switch off, no range and no task time, and the same
tokens either way."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import ClusterSpec, GB  # noqa: E402
from repro_torch.examples import serve_cluster as ex  # noqa: E402
from repro_torch.serving import ServingCluster  # noqa: E402

DECODE = 3
PROMPT = 5


@pytest.fixture(scope="module")
def hosted():
    return ex.reduced_hosted("cpu")


def served(hosted, spans):
    """Two requests, one of each pipeline, under the profiler: (the
    cluster, the ``compass.`` ranges (name, start ns, end ns), the tokens)."""
    sc = ServingCluster(ClusterSpec(n_workers=3, gpu_capacity_bytes=1 * GB), hosted,
                        decode_tokens=DECODE, spans=spans, device="cpu")
    spec, summ = ex.build_pipelines()
    sc.register_pipeline(spec)
    sc.register_pipeline(summ)
    rng = np.random.default_rng(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i, (dfg, entry) in enumerate([(spec, "draft"), (summ, "perceive")]):
            prompt = rng.integers(1, 64, size=(2, PROMPT)).astype(np.int32)
            sc.submit(dfg, {entry: prompt}, origin=i)
    ranges = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("compass."))
    tokens = [r.outputs for r in sc.results]
    return sc, ranges, tokens


def inside(ranges, outer, name):
    """The ranges ``compass.<name>`` within ``outer``."""
    return [r for r in ranges
            if r[0] == "compass." + name and outer[1] <= r[1] and r[2] <= outer[2]]


def test_each_task_opens_one_run_task(hosted):
    """The two requests hold 3 and 2 model tasks; the front end and the
    planner open no range."""
    sc, ranges, _ = served(hosted, spans=True)
    count = collections.Counter(r[0] for r in ranges)
    assert count["compass.run_task"] == 5
    assert set(count) == {"compass." + n for n in ("run_task", "zero_cache", "replay", "to_host")}
    run_tasks = [r for r in ranges if r[0] == "compass.run_task"]
    for r in ranges:
        if r[0] != "compass.run_task":
            assert sum(rt[1] <= r[1] and r[2] <= rt[2] for rt in run_tasks) == 1


def test_each_run_task_holds_its_steps(hosted):
    """Every task here is fed a prompt of ``PROMPT`` tokens (a later task's
    prompt is its predecessor's ``DECODE`` outputs): one replay a step."""
    sc, ranges, _ = served(hosted, spans=True)
    run_tasks = [r for r in ranges if r[0] == "compass.run_task"]
    steps = sorted(len(inside(ranges, rt, "replay")) for rt in run_tasks)
    assert steps == sorted([PROMPT + DECODE] * 2 + [DECODE + DECODE] * 3)
    for rt in run_tasks:
        assert len(inside(ranges, rt, "zero_cache")) == 1
        assert len(inside(ranges, rt, "to_host")) == 1
        assert inside(ranges, rt, "capture") == []  # graphs are the card's
    # every range nests in the one around it: none straddles another
    for a in ranges:
        for b in ranges:
            assert not (a[1] < b[1] < a[2] < b[2])
    assert sc.engine.task_times == []  # timed by CUDA events, on a card only


def test_switched_off_the_path_opens_no_range(hosted, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    sc, ranges, tokens = served(hosted, spans=False)
    assert ranges == [] and calls == [] and sc.engine.task_times == []
    _, on_ranges, on_tokens = served(hosted, spans=True)
    assert len(calls) == len(on_ranges)
    for a, b in zip(tokens, on_tokens):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
