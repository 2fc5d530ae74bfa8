"""What the traced run reads from a profile, on synthetic records, and
the readers of the per-layer metrics on a made-up run."""

import numpy as np
import pytest

from perfbench import harness as hb
from perfbench import trace

W = "perfbench.window"
DEVICE = [("k1", 100, 50), ("decode_split_kernel<8>", 120, 50), ("decode_combine", 300, 20),
          ("k2", 500, 100)]
SPANS = [(W, 0, 1000), ("perfbench.submit", 50, 900), ("perfbench.run_task", 90, 650),
         ("perfbench.plan", 60, 80)]


def test_merged_and_busy():
    assert trace.merged(DEVICE) == [(100, 170), (300, 320), (500, 600)]
    assert trace.busy_s(DEVICE, SPANS) == pytest.approx(190e-9)


def test_idle_gaps_by_host_span():
    got = dict(trace.idle_gaps(DEVICE, SPANS))
    # 0-100: mid 50 in submit (plan starts at 60); 170-300 and 320-500: run_task;
    # 600-1000: mid 800 in submit
    assert got == pytest.approx({"submit": 500e-9, "run_task": 310e-9})
    assert sum(got.values()) + trace.busy_s(DEVICE, SPANS) == pytest.approx(1000e-9)


def test_busy_within_spans_of_one_name():
    # run_task 90-650 holds every record: 70 + 20 + 100
    assert trace.busy_within(DEVICE, SPANS, "perfbench.run_task") == pytest.approx(190e-9)
    two = [(W, 0, 1000), ("perfbench.run_task", 90, 310), ("perfbench.run_task", 550, 580)]
    # 100-170, 300-310 of 300-320, 550-580 of 500-600
    assert trace.busy_within(DEVICE, two, "perfbench.run_task") == pytest.approx(110e-9)
    assert trace.busy_within(DEVICE, SPANS, "perfbench.none") == 0.0


def test_device_ops_and_decode_attention():
    ops = trace.device_ops(DEVICE, top=2)
    assert ops == [["k2", 100e-9], ["k1", 50e-9]]
    secs, calls = trace.decode_attention(DEVICE)
    assert secs == pytest.approx(70e-9) and calls == 1


def made_up_run(with_trace=True):
    m = {"arch_type": "dense", "dtype": "bfloat16", "n_layers": 2, "d_model": 8, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 2, "d_ff": 16, "vocab": 10}
    tasks = [hb.Task("a", 0, 2, 3, 2), hb.Task("b", 0, 2, 2, 2)]
    reqs = [hb.Request(i, "p", 3, lat, True, tasks=list(tasks))
            for i, lat in enumerate([0.1, 0.2, 0.3, 0.4, 1.0])]
    run = hb.Run({0: m}, reqs, window_s=2.0, setup_s=3.0, replays=45,
                 timers={"plan_s": 0.01, "run_task_s": 0.9, "submit_s": 1.0})
    if with_trace:
        launches = 2 * (5 + 4)  # layers × steps of the two tasks
        device = [("decode_split", i * 10, 4) for i in range(launches)]
        run.trace = hb.Trace(device, [(W, 0, 1000)], 1e-6, 0.25e-6, 0.2e-6, list(tasks))
    return run, m


def test_readers_on_a_made_up_run():
    run, m = made_up_run()
    read = {e["name"]: hb.metric(e["name"]).read(run)
            for e in hb.spec()["end_to_end"] + hb.spec()["per_layer"]}
    lat = sorted(r.latency_s for r in run.requests)
    assert read["request_p95_s"] == pytest.approx(np.quantile(lat, 0.95))
    assert read["generated_tokens_per_s"] == pytest.approx(5 * 2 * 2 * 2 / 2.0)
    assert read["setup_s"] == 3.0
    assert read["plan_ms"] == pytest.approx(2.0)
    assert read["front_end_ms"] == pytest.approx((1.0 - 0.01 - 0.9) / 5 * 1e3)
    assert read["step_ms"] == pytest.approx(0.9 / 45 * 1e3)
    assert read["device_idle_share"] == pytest.approx(75.0)
    from perfbench import counting

    # the step metrics: the profiled deck's tasks over the device time inside run_task
    flops = sum(counting.step_flops(m, 2, p) for t in (5, 4) for p in range(t))
    assert read["step_mfu"] == pytest.approx(100 * flops / (0.2e-6 * 989e12))
    nbytes = sum(counting.step_bytes(m, 2, p) for t in (5, 4) for p in range(t))
    assert read["step_hbm_share"] == pytest.approx(100 * nbytes / (0.2e-6 * 3.35e12))
    bound = sum(counting.decode_bound(2, 4, 2, 2, [p + 1] * 2, "bfloat16", 2)[0] * 2
                for t in (5, 4) for p in range(t))
    assert read["decode_attention_roofline"] == pytest.approx(100 * bound / 1e3 / (18 * 4e-9))


def test_readers_leave_out_what_they_cannot_read():
    run, _ = made_up_run(with_trace=False)
    run.timers = None
    for name in ("plan_ms", "front_end_ms", "step_ms", "decode_attention_roofline",
                 "device_idle_share", "step_mfu", "step_hbm_share"):
        assert hb.metric(name).read(run) is None
    run, _ = made_up_run()
    run.trace.device = run.trace.device[:-1]  # a launch the profile lost
    assert hb.metric("decode_attention_roofline").read(run) is None
    moe = dict(run.models[0], arch_type="moe", n_experts=4, top_k=2, d_ff_expert=4)
    run.models[0] = moe
    assert hb.metric("step_hbm_share").read(run) is None  # no routing read
    for t in run.trace.tasks:
        t.experts = np.full((2, t.steps), 3)
    assert hb.metric("step_hbm_share").read(run) > 0
