"""The program's ranges in a profile, on synthetic events: each record put
down to the range around its launch call by correlation id, the five
readings and ``idle_by_cause``; the engine's task times; and the
harness's own readings of a profile, the same with the program's ranges
in it as without."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from perfbench import harness as hb  # noqa: E402
from perfbench import program_trace as pt  # noqa: E402
from perfbench import trace  # noqa: E402
from repro_torch.serving.engine import TaskTime  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    """One event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, end, cid=0, device=CPU):
        self._v = (name, start, end - start, cid, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def dev(name, start, end, cid):
    return Ev(name, start, end, cid, CUDA)


#: The harness's part of a profile: the ballast's kernel and synchronise,
#: its window and spans, and the card's records.  A task zeroes its cache
#: and replays two steps, with one kernel launched between them.
HARNESS = [
    dev("ballast_add", 1, 2, 5), Ev("cudaLaunchKernel", 0, 1, 5),
    Ev("cudaDeviceSynchronize", 3, 5, 10),
    Ev("perfbench.window", 100, 1000), Ev("perfbench.submit", 105, 995),
    Ev("perfbench.plan", 118, 142), Ev("perfbench.run_task", 158, 892),
    dev("memset", 180, 190, 20),
    dev("copy", 190, 195, 21), dev("k1", 205, 230, 22), dev("k2", 240, 270, 22),
    dev("between", 285, 290, 25),
    dev("copy", 320, 325, 23), dev("k1", 330, 350, 24), dev("k2", 350, 360, 24),
]
#: What the program adds with its spans on: its ranges, and the calls
#: that launched the records, by correlation id.
PROGRAM = [
    Ev("compass.run_task", 160, 890),
    Ev("compass.zero_cache", 165, 175), Ev("compass.replay", 180, 260),
    Ev("compass.replay", 300, 340),
    Ev("cudaDeviceSynchronize", 346, 365, 28),
    Ev("cudaMemsetAsync", 168, 172, 20),
    Ev("cudaMemcpyAsync", 185, 188, 21), Ev("cudaGraphLaunch", 190, 250, 22),
    Ev("cudaLaunchKernel", 280, 282, 25),
    Ev("cudaMemcpyAsync", 310, 312, 23), Ev("cudaGraphLaunch", 315, 370, 24),
    Ev("cudaEventRecord", 178, 179, 26), Ev("cudaEventRecord", 342, 343, 27),
]


def attributed(events=None):
    return pt.attribute(pt.read(HARNESS + PROGRAM if events is None else events))


def test_records_belong_to_the_range_around_their_launch_call():
    at = attributed()
    assert at.pt.window == (100, 1000) and at.pt.event_records == 2
    assert [r[1] for r in at.pt.records][:2] == ["memset", "copy"]  # the ballast's left out
    labels = {(r[1], r[2]): at.label(s) for r, s in zip(at.pt.records, at.span)}
    assert labels == {("memset", 180): "zero_cache", ("copy", 190): "replay",
                      ("k1", 205): "replay", ("k2", 240): "replay",  # inside the graph
                      ("between", 285): "run_task",  # between two replays
                      ("copy", 320): "replay", ("k1", 330): "replay", ("k2", 350): "replay"}
    assert at.launch[0] == 168
    assert pt.coverage(at) == {"run_task_device_s": 110e-9, "attributed_share": 100.0,
                               "launches_after_their_record": 0, "after_alignment": 0,
                               "latest_after_alignment_ns": 0.0}


def test_the_cards_clock_aligned_to_the_hosts():
    """The quickest record starts 5 ns after its launch call began: host
    time t is t + 5 on the card's clock.  With the card's records 8 ns
    early, two start before their calls; aligned, none does, and the gaps
    between records keep their causes."""
    at = attributed()
    assert pt.offsets(at.pt, at.launch) == [(185, 5)]
    assert at.on_device(200) == 205.0
    early = [dev(e.name(), e.start_ns() - 8, e.start_ns() + e.duration_ns() - 8,
                 e.correlation_id()) if e.device_type() == CUDA and e.correlation_id() > 10
             else e for e in HARNESS]
    shifted = attributed(early + PROGRAM)
    assert shifted.anchors == [(185, -3)] and shifted.on_device(168) == 165.0
    cov = pt.coverage(shifted)
    assert cov["launches_after_their_record"] == 2 and cov["after_alignment"] == 0
    got, want = dict(pt.idle_by_cause(shifted)), dict(pt.idle_by_cause(at))
    # the window's edges are the host's: only the first gap and the last move
    assert got["zero_cache/host_late"] == pytest.approx(want["zero_cache/host_late"] - 8e-9)
    assert got["client"] == pytest.approx(want["client"] + 8e-9)
    for k in ("zero_cache/queued", "run_task/host_late", "replay/host_late", "replay/queued"):
        assert got[k] == pytest.approx(want[k])


def test_innermost_of_nested_ranges():
    spans = [("a", 0, 100), ("b", 10, 50), ("c", 20, 30), ("d", 60, 70), ("e", 200, 300)]
    assert pt.innermost(spans, [25, 5, 40, 65, 80, 150, 250, 20, 30]) == [
        2, 0, 1, 3, 0, None, 4, 2, 1]


def test_idle_by_cause_and_host_late_share():
    at = attributed()
    got = dict(at_labels(pt.idle_by_cause(at)))
    # on the card's clock a launch call begins 5 ns later (the quickest
    # launch): 100-180 ends at the memset launched at 168 + 5; 270-285 at
    # the kernel launched at 280 + 5 between the replays; 290-320 at the copy
    # launched at 310 + 5; 195-205, 230-240 and 325-330 inside a graph or
    # after its copy
    assert got == pytest.approx({
        "zero_cache/host_late": 73, "zero_cache/queued": 7, "run_task/host_late": 15,
        "replay/host_late": 25, "replay/queued": 10 + 10 + 5 + 5, "client": 640})
    idle = 900 - (10 + 5 + 25 + 30 + 5 + 5 + 20 + 10)
    assert sum(got.values()) == pytest.approx(idle)
    span_list = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in HARNESS if e.name().startswith("perfbench.")]
    old = [(e.name(), e.start_ns(), e.duration_ns()) for e in HARNESS
           if e.device_type() == CUDA and e.correlation_id() > 10]
    assert sum(got.values()) == pytest.approx(
        (1000 - 100) - trace.busy_s(old, span_list) * 1e9)
    assert pt.host_late_share(at) == pytest.approx(100 * (73 + 15 + 25) / 900)


def at_labels(rows):
    return [(k, v * 1e9) for k, v in rows]


def test_a_lost_launch_call_and_a_call_outside_the_program():
    # the memset launched from run_task itself
    at = attributed(HARNESS + [e for e in PROGRAM if e.name() != "compass.zero_cache"])
    got = dict(at_labels(pt.idle_by_cause(at)))
    assert got["run_task/host_late"] == pytest.approx(15 + 73)
    at = attributed(HARNESS + [e for e in PROGRAM if e.correlation_id() != 20])
    got = dict(at_labels(pt.idle_by_cause(at)))
    assert got["unattributed/queued"] == pytest.approx(80)
    assert pt.coverage(at)["attributed_share"] == pytest.approx(100 * 100 / 110)
    outside = [e for e in PROGRAM if not e.name().startswith("compass.")]
    at = attributed(HARNESS + outside)
    assert set(dict(pt.idle_by_cause(at))) == {"none/host_late", "none/queued", "client"}


def test_replay_gap_and_in_replay_idle():
    at = attributed()
    # from the first replay's last record (270) to the second's first (320),
    # less the kernel between them (285-290)
    assert pt.replay_gap_us(at) == pytest.approx(45e-3)
    # extents 190-270 and 320-360: idle 195-205, 230-240 and 325-330
    assert pt.in_replay_idle_share(at) == pytest.approx(100 * 25 / 120)
    none = attributed(HARNESS + [e for e in PROGRAM if e.name() != "compass.replay"])
    assert pt.replay_gap_us(none) is None and pt.in_replay_idle_share(none) is None


def test_annotations_on_the_device_are_not_records():
    at = attributed(HARNESS + PROGRAM + [dev("compass.replay", 180, 270, 0)])
    assert at.pt.annotations == 1 and len(at.pt.records) == 8


def test_task_times_over_the_window():
    a, b = (0, 4, 250), (1, 4, 70)
    times = ([TaskTime(a, 10, 10e-3, float(i)) for i in range(9)]
             + [TaskTime(a, 10, 10.5e-3, 9.0), TaskTime(a, 10, 10.1e-3, 10.0),
                TaskTime(a, 10, 9.9e-3, 11.0)]
             + [TaskTime(b, 5, 10e-3, 12.0), TaskTime(b, 5, 10.1e-3, 13.0),
                TaskTime(b, 5, 10.5e-3, 14.0)])
    assert pt.step_device_ms(times) == pytest.approx(
        1e3 * sum(t.device_s for t in times) / (12 * 10 + 3 * 5))
    # a: 12 tasks, so the reference is the second fastest (10 ms over 10
    # replays); b: under ten, so its fastest
    assert pt.references(times) == pytest.approx({a: 1e-3, b: 2e-3})
    assert pt.slow(times) == [False] * 9 + [True, False, False, False, False, True]
    total = sum(t.device_s for t in times)
    assert pt.slow_step_share(times) == pytest.approx(100 * (10.5e-3 + 10.5e-3) / total)
    assert pt.step_device_ms([]) is None and pt.slow_step_share([]) is None


class FakeProfile:
    """``torch.profiler.profile`` holding ``events``."""

    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def cpu_profiled(monkeypatch, events):
    """``trace.profiled`` on the CPU, its profile holding ``events``."""
    zeros = torch.zeros
    with monkeypatch.context() as m:
        m.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(*a, **k))
        m.setattr(torch.cuda, "synchronize", lambda *a: None)
        m.setattr(torch.profiler, "profile", lambda **k: FakeProfile(events))
        yield


def test_the_harness_reads_the_same_with_the_programs_ranges(monkeypatch):
    """``trace.profiled`` and every reading of it are the same whether the
    profile holds the program's ranges and launch calls or not."""
    readings = []
    for events in (HARNESS, HARNESS + PROGRAM):
        with cpu_profiled(monkeypatch, events):
            device, spans, _, lost = trace.profiled(lambda: None)
        run, _ = made_up_run()
        run.trace = hb.Trace(device, spans, 900e-9, trace.busy_s(device, spans),
                             trace.busy_within(device, spans, trace.SPAN + "run_task"),
                             run.trace.tasks)
        readings.append((device, spans, lost, trace.idle_gaps(device, spans),
                         trace.busy_s(device, spans),
                         trace.busy_within(device, spans, trace.SPAN + "run_task"),
                         {e["name"]: hb.metric(e["name"]).read(run)
                          for e in hb.spec()["per_layer"]}))
    assert readings[0] == readings[1]
    device, spans = readings[0][:2]
    assert len(device) == 8 and [s[0] for s in spans] == [
        "perfbench.window", "perfbench.submit", "perfbench.plan", "perfbench.run_task"]


def made_up_run():
    from perfbench.tests.test_perfbench_trace import made_up_run as run

    return run()
