"""The port's copies of the serving planes against their originals: the
gossip plane (``core/sst_exchange.py``), the prefetch plane
(``core/prefetch.py``), the health plane (``core/healthplane.py``) and
the flight recorder and metrics registry (``core/telemetry.py``).

Each ``drive_*`` runs one seeded sequence of operations through a
package's plane and returns everything it exposes; the two packages must
return equal values, bit for bit.  The cases of the reference's own tests
that need no simulator (``tests/test_sst_gossip.py``,
``test_prefetch.py``, ``test_healthplane.py``, ``test_telemetry.py``)
follow, each run on both packages."""

import dataclasses
import json
import random
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as rcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import healthplane as rhealth  # noqa: E402
from repro.core import sst_exchange as rsst  # noqa: E402
from repro.core import telemetry as rtel  # noqa: E402
from repro.workflows import MODELS, paper_dfgs, translation_dfg  # noqa: E402
from repro_torch.core import healthplane as thealth  # noqa: E402
from repro_torch.core import sst_exchange as tsst  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Each package's core and the modules of its planes.
PACKAGES = {
    "repro": dict(core=rcore, sst=rsst, health=rhealth, tel=rtel),
    "repro_torch": dict(core=tcore, sst=tsst, health=thealth, tel=ttel),
}
both = pytest.mark.parametrize("pkg", list(PACKAGES))


def load_schema(name):
    return json.loads((ROOT / "schemas" / name).read_text())


def dfgs_of(core):
    """The paper's DFGs in ``core``'s types."""
    out = []
    for d in paper_dfgs():
        tasks = [core.TaskSpec(**dataclasses.asdict(t)) for t in d.tasks.values()]
        out.append(core.DFG(d.name, tasks, d.edges))
    return out


def models_of(core):
    return {mid: core.MLModel(m.model_id, m.name, m.size_bytes) for mid, m in MODELS.items()}


def rows(view):
    return [dataclasses.asdict(r) for r in view]


# ---------------------------------------------------------------------------
# seeded drives, compared between the packages
# ---------------------------------------------------------------------------
def drive_gossip(core, seed, n=6, steps=160):
    """Random row updates, heartbeats, drains, rejoins and pushes, with
    gossip rounds (some messages held back and delivered later) and
    ``advance``: every worker's view with its membership verdicts, the
    counters and the staleness after each step."""
    rng = np.random.default_rng(seed)
    plane = core.GossipPlane(n, core.GossipConfig(period_s=0.2, fanout=2, drop_prob=0.1,
                                                  seed=seed),
                             seed=seed, lease=core.LeaseConfig())
    held, log, now = [], [], 0.0
    for _ in range(steps):
        now += float(rng.exponential(0.05))
        w = int(rng.integers(n))
        op = int(rng.integers(9))
        if op == 0:
            plane.update_load(w, float(rng.uniform(0, 5)), now)
        elif op == 1:
            plane.update_cache(w, int(rng.integers(1 << 12)), float(rng.uniform(0, 16e9)), now)
        elif op == 2:
            plane.update_intent(w, int(rng.integers(1 << 12)), now)
        elif op == 3:
            plane.update_health(w, int(rng.integers(10)), float(rng.uniform()),
                                float(rng.uniform()), float(rng.uniform(0, 2)), now)
        elif op == 4:
            plane.heartbeat(w, now)
        elif op == 5:
            plane.set_draining(w, bool(rng.integers(2)), now)
        elif op == 6:
            plane.join(w, now) if rng.uniform() < 0.2 else plane.push(w, now)
        elif op == 7:
            for q, updates, _ in plane.exchange(w, now):
                if rng.uniform() < 0.3:
                    held.append((q, updates))
                else:
                    plane.deliver(q, updates, now)
            if held and rng.uniform() < 0.5:
                q, updates = held.pop(0)
                plane.deliver(q, updates, now)
        else:
            plane.advance(now)
        log.append(([rows(plane.view(r, now)) for r in range(n)], rows(plane.view(None, now)),
                    plane.messages_sent, plane.rows_sent, plane.messages_dropped,
                    plane.staleness(now)))
    return log


def drive_prefetch(core, seed, n=5, jobs=12):
    """Plans of seeded jobs turned into intents and admitted, then the
    worker-side queue ops (issue with random residency and peer bits,
    complete, promote, stall, preempt, cancel, consume, rehome, drop):
    the intents, queues, in-flight intents, advertised bits and stats
    after each job."""
    rng = np.random.default_rng(seed)
    cluster = core.ClusterSpec(n_workers=n)
    profiles = core.ProfileRepository(cluster, models_of(core))
    dfgs = dfgs_of(core)
    for d in dfgs:
        profiles.register(d)
    sched = core.NavigatorScheduler(profiles)
    plane = core.PrefetchPlane(n, core.PrefetchConfig(max_queue=6, herd_backoff_s=0.3,
                                                      intent_ttl_s=4.0),
                               fetch_time_fn=profiles.td_model)
    log, now = [], 0.0
    for j in range(jobs):
        now += float(rng.exponential(0.5))
        job = core.Job(j, dfgs[int(rng.integers(len(dfgs)))], now)
        sst = [core.SSTRow(free_cache_bytes=16 * core.GB, pushed_at=now,
                           cache_bitmap=int(rng.integers(1 << 6))) for _ in range(n)]
        adfg = sched.plan(job, now, int(rng.integers(n)), sst)
        per = plane.plan_intents(job, adfg, profiles, now)
        for w, intents in sorted(per.items()):
            plane.admit(w, intents, now)
        for _ in range(6):
            w = int(rng.integers(n))
            op = int(rng.integers(8))
            resident = set(rng.choice(12, size=3, replace=False).tolist())
            if op < 3:
                got = plane.next_intent(w, now, lambda m: m in resident,
                                        int(rng.integers(1 << 6)))
                log.append(("next", w, None if got[0] is None else
                            dataclasses.asdict(got[0]), got[1]))
            elif op == 3 and plane.inflight[w] is not None:
                plane.complete_inflight(w) if rng.uniform() < 0.5 else plane.promote_inflight(w)
            elif op == 4 and plane.inflight[w] is not None:
                plane.stall_inflight(w, now + 0.1) if rng.uniform() < 0.5 else \
                    plane.preempt_inflight(w, requeue=bool(rng.integers(2)))
            elif op == 5:
                tid = str(rng.choice(sorted(job.dfg.tasks)))
                got = plane.cancel(w, job.job_id, tid, migrated=bool(rng.integers(2)))
                log.append(("cancel", None if got is None else dataclasses.asdict(got)))
            elif op == 6:
                plane.consume(w, job.job_id, str(rng.choice(sorted(job.dfg.tasks))))
            elif rng.uniform() < 0.3:
                log.append(("drop", [dataclasses.asdict(i) for i in plane.drop_worker(w)]))
        log.append(([sorted((k, dataclasses.asdict(v)) for k, v in plane.queues[w].items())
                     for w in range(n)],
                    [None if i is None else dataclasses.asdict(i) for i in plane.inflight],
                    [plane.advertised_bits(w) for w in range(n)],
                    [plane.queue_depth(w) for w in range(n)],
                    dataclasses.asdict(plane.stats)))
    return log


def drive_health(pkg, seed, n=4, steps=400):
    """Seeded samples through every hook of a health monitor attached to
    a flight recorder, and a quantile sketch with merges: the digests
    along the way, the summary, the recorder's JSONL, the sketch's
    centroids and quantiles."""
    m = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    rec = m["tel"].FlightRecorder(n)
    hm = m["health"].HealthMonitor(n, m["health"].HealthConfig(window_s=0.5, max_windows=8,
                                                               queue_depth_threshold=4),
                                   recorder=rec)
    digests, t = [], 0.0
    for _ in range(steps):
        t += float(rng.exponential(0.05))
        w = int(rng.integers(n))
        op = int(rng.integers(7))
        if op == 0:
            hm.sample_queue(w, t, int(rng.integers(8)))
        elif op == 1:
            hm.sample_memory(w, t, float(rng.uniform()), int(rng.integers(0, 3 + int(t))))
        elif op == 2:
            hm.fetch_state(w, t, bool(rng.integers(2)))
        elif op == 3:
            hm.on_transfer(t, str(rng.choice(["flat", "spine.rack0", "leaf.1"])),
                           float(rng.uniform(1e5, 1e8)), float(rng.uniform(0.1, 1.0)),
                           cross=bool(rng.integers(2)))
        elif op == 4:
            hm.task_done(w, t, float(rng.lognormal(-2, 1)), float(rng.uniform(0.01, 0.2)))
        elif op == 5:
            hm.job_done(t, float(rng.lognormal(-1, 0.5)))
        else:
            digests.append(dataclasses.asdict(hm.digest(w, t)))
    sketches = [m["health"].QuantileSketch(compression=50) for _ in range(3)]
    for i, v in enumerate(rng.lognormal(0.0, 1.0, 3000)):
        sketches[i % 3].add(float(v))
    merged = m["health"].QuantileSketch()
    for s in sketches:
        merged.merge(s)
    return (digests, hm.summary(), rec.to_jsonl(), [s.centroids() for s in sketches],
            merged.centroids(), [merged.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)])


def drive_telemetry(pkg, seed):
    """A registry's counters, gauges and histograms and a recorder's
    events (small rings, so some drop) and placement records: the exports."""
    m = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    reg = m["tel"].MetricsRegistry()
    rec = m["tel"].FlightRecorder(3, m["tel"].TraceConfig(ring_capacity=40))
    for i in range(200):
        t = i * 0.01
        kind = str(rng.choice(["task.start", "task.done", "fetch.start", "net.xfer"]))
        reg.counter("events", kind=kind).inc()
        reg.gauge("depth", worker=str(i % 3)).set(float(rng.uniform()))
        reg.histogram("lat", bounds=(0.01, 0.1, 1.0)).observe(float(rng.lognormal(-3, 1)))
        rec.emit(t, kind, worker=int(rng.integers(-1, 3)), job=i // 10, task=f"t{i % 4}",
                 gen=0, model=int(rng.integers(5)), miss=bool(rng.integers(2)),
                 dur=float(rng.uniform()))
        if i % 25 == 0:
            cands = tuple(m["tel"].CandidateCost(w, *map(float, rng.uniform(0, 1, 7)))
                          for w in range(3))
            rec.record_placement(m["tel"].PlacementDecision(t, i // 10, f"t{i % 4}", "plan",
                                                            "navigator", 0, 1, cands))
    return (reg.export(), reg.sum_values("events"), rec.to_jsonl(), rec.to_chrome_trace(),
            rec.dropped, rec.ring_stats(), rec.decisions(0, "t0")[0].explain())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gossip_plane_matches_reference(seed):
    assert drive_gossip(tcore, seed) == drive_gossip(rcore, seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefetch_plane_matches_reference(seed):
    got, want = drive_prefetch(tcore, seed), drive_prefetch(rcore, seed)
    assert got == want
    assert want[-1][-1]["intents_issued"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_health_plane_matches_reference(seed):
    got, want = drive_health("repro_torch", seed), drive_health("repro", seed)
    assert got == want
    assert want[1]["detectors"] and any(want[1]["detectors"].values())


@pytest.mark.parametrize("seed", [0, 1])
def test_telemetry_matches_reference(seed):
    got, want = drive_telemetry("repro_torch", seed), drive_telemetry("repro", seed)
    assert got == want
    assert want[4] > 0  # the small rings dropped events


def test_wire_rows_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(50):
        kw = dict(ft_estimate_s=float(rng.uniform(0, 100)), cache_bitmap=int(rng.integers(1 << 62)),
                  free_cache_bytes=float(rng.uniform(0, 80e9)), version=int(rng.integers(1 << 31)),
                  intent_bitmap=int(rng.integers(1 << 62)), heartbeat_s=float(rng.uniform(0, 9)),
                  epoch=int(rng.integers(100)), draining=bool(rng.integers(2)),
                  fetch_model_id=int(rng.integers(-1, 60)), fetch_eta_s=float(rng.uniform()),
                  health_queue_depth=int(rng.integers(50)),
                  health_mem_occupancy=float(rng.uniform()),
                  health_fetch_util=float(rng.uniform()),
                  health_p99_latency_s=float(rng.uniform(0, 3)))
        got = tsst.pack_row(tcore.SSTRow(**kw), queue_len=3)
        want = rsst.pack_row(rcore.SSTRow(**kw), queue_len=3)
        np.testing.assert_array_equal(got, want)
        assert rows(tsst.unpack_rows(got[None])) == rows(rsst.unpack_rows(want[None]))
    assert callable(tsst.make_sst_allgather)  # the collective transport (test_torch_distributed.py)


# ---------------------------------------------------------------------------
# the reference's own cases, on both packages
# ---------------------------------------------------------------------------
def run_rounds(plane, t):
    """One synchronous all-worker round at time ``t`` (immediate delivery)."""
    for w in range(plane.n_workers):
        for q, updates, _ in plane.exchange(w, t):
            plane.deliver(q, updates, t)


@both
def test_views_are_per_worker(pkg):
    core = PACKAGES[pkg]["core"]
    plane = core.GossipPlane(4, core.GossipConfig(fanout=3))
    plane.update_load(0, 33.0, now=1.0)
    assert plane.view(0)[0].ft_estimate_s == 33.0
    for w in (1, 2, 3):
        assert plane.view(w)[0].ft_estimate_s == 0.0
    (q, updates, _), = [m for m in plane.exchange(0, 1.1) if m[0] == 1]
    plane.deliver(1, updates, 1.1)
    assert plane.view(1)[0].ft_estimate_s == 33.0


@both
def test_staleness_bound_under_periodic_gossip(pkg):
    core = PACKAGES[pkg]["core"]
    period = 0.2
    plane = core.GossipPlane(5, core.GossipConfig(period_s=period, fanout=4))
    for r in range(1, 11):
        t_round = r * period
        for w in range(5):
            plane.update_load(w, float(r * 10 + w), now=t_round - 0.01)
        run_rounds(plane, t_round)
        assert plane.staleness(t_round) <= 0.01 + 1e-9
        assert plane.staleness(t_round + period) <= period + 0.01 + 1e-9


@both
def test_exchange_is_diff_based(pkg):
    core = PACKAGES[pkg]["core"]
    n, k = 64, 7
    plane = core.GossipPlane(n, core.GossipConfig(fanout=n - 1, seed=5))
    for owner in range(k):
        plane.update_load(owner, 1.0, now=0.1)
        if owner != 0:
            plane.deliver(0, [(owner, plane.local[owner].version, plane.local[owner])], 0.1)
    assert all(len(updates) == k for _, updates, _ in plane.exchange(0, 0.2))
    before = plane.rows_sent
    assert plane.exchange(0, 0.4) == []
    assert plane.rows_sent == before


@both
def test_rejoin_bumps_epoch_and_rebuilds_view(pkg):
    core = PACKAGES[pkg]["core"]
    plane = core.GossipPlane(4, core.GossipConfig(fanout=3), lease=core.LeaseConfig())
    for w in range(4):
        plane.update_load(w, float(w + 1), now=0.1)
    run_rounds(plane, 0.2)
    plane.join(2, now=1.0)
    assert plane.local[2].epoch == 1
    assert plane.view(2, 1.0)[0].ft_estimate_s == 0.0
    run_rounds(plane, 1.2)
    assert [r.ft_estimate_s for r in plane.view(2, 1.2)] == [1.0, 2.0, 0.0, 4.0]


@both
def test_health_digest_gossip_converges(pkg):
    core = PACKAGES[pkg]["core"]
    n = 8
    plane = core.GossipPlane(n, core.GossipConfig(period_s=0.2, fanout=2), seed=3)
    plane.update_health(0, queue_depth=7, mem_occupancy=0.625, fetch_util=0.25,
                        p99_latency_s=1.5, now=0.0)
    for r in range(n):
        run_rounds(plane, 0.2 * (r + 1))
    for reader in range(n):
        row = plane.views[reader][0]
        assert (row.health_queue_depth, row.health_mem_occupancy, row.health_fetch_util,
                row.health_p99_latency_s) == (7, 0.625, 0.25, 1.5)


def _planned_job(core, profiles):
    dfg = next(d for d in dfgs_of(core) if d.name == translation_dfg().name)
    job = core.Job(0, dfg, arrival_time=0.0)
    sst = [core.SSTRow(free_cache_bytes=16 * core.GB, pushed_at=0.0) for _ in range(5)]
    return job, core.NavigatorScheduler(profiles).plan(job, 0.0, 0, sst)


def _profiles(core):
    p = core.ProfileRepository(core.ClusterSpec(n_workers=5), models_of(core))
    for d in dfgs_of(core):
        p.register(d)
    return p


@both
def test_plan_intents_grouped_ordered_and_capped(pkg):
    core = PACKAGES[pkg]["core"]
    profiles = _profiles(core)
    job, adfg = _planned_job(core, profiles)
    for depth in (1, 8):
        plane = core.PrefetchPlane(5, core.PrefetchConfig(lookahead_depth=depth),
                                   fetch_time_fn=profiles.td_model)
        per = plane.plan_intents(job, adfg, profiles, now=0.0)
        assert per
        for w, intents in per.items():
            assert len(intents) <= depth
            assert [i.expected_start_s for i in intents] == \
                sorted(i.expected_start_s for i in intents)
            for i in intents:
                assert adfg[i.task_id] == w
                assert i.model_id == job.dfg.tasks[i.task_id].model_id


@both
def test_admit_bounds_queue_dropping_latest_needed(pkg):
    core = PACKAGES[pkg]["core"]
    profiles = _profiles(core)
    plane = core.PrefetchPlane(5, core.PrefetchConfig(max_queue=2),
                               fetch_time_fn=profiles.td_model)
    dfg = next(d for d in dfgs_of(core) if d.name == translation_dfg().name)
    intents = [plane.make_intent(core.Job(j, dfg, 0.0), "mt5_zh", 0, 0.0,
                                 expected_start_s=float(j)) for j in range(5)]
    plane.admit(0, intents, 0.0)
    assert plane.queue_depth(0) == 2
    assert plane.stats.intents_dropped == 3
    assert sorted(i.expected_start_s for i in plane.queues[0].values()) == [0.0, 1.0]


@both
def test_anti_herd_defers_nonurgent_when_peer_advertises(pkg):
    core = PACKAGES[pkg]["core"]
    profiles = _profiles(core)
    plane = core.PrefetchPlane(5, core.PrefetchConfig(herd_backoff_s=1.0, urgency_slack_s=0.1),
                               fetch_time_fn=profiles.td_model)
    dfg = next(d for d in dfgs_of(core) if d.name == translation_dfg().name)
    peer_bits = 1 << dfg.tasks["mt5_zh"].model_id
    plane.admit(0, [plane.make_intent(core.Job(5, dfg, 0.0), "mt5_zh", 0, 0.0,
                                      expected_start_s=100.0)], 0.0)
    intent, retry_at = plane.next_intent(0, 0.0, lambda m: False, peer_bits)
    assert intent is None and plane.stats.deferrals == 1
    assert retry_at == pytest.approx(1.0)
    plane.admit(0, [plane.make_intent(core.Job(6, dfg, 0.0), "mt5_ja", 0, 0.0,
                                      expected_start_s=0.5)], 0.0)
    intent, _ = plane.next_intent(0, 0.0, lambda m: False, peer_bits)
    assert intent is not None and intent.job_id == 6


@both
def test_sketch_bitwise_deterministic_and_accurate(pkg):
    health = PACKAGES[pkg]["health"]

    def build(seed, n=5000):
        rng = random.Random(seed)
        sk = health.QuantileSketch()
        for _ in range(n):
            sk.add(rng.lognormvariate(0.0, 1.0))
        return sk

    a, b = build(7), build(7)
    assert a.centroids() == b.centroids() and a.as_dict() == b.as_dict()
    rng = random.Random(3)
    data = sorted(rng.lognormvariate(0.0, 1.5) for _ in range(20000))
    sk = health.QuantileSketch()
    for v in data:
        sk.add(v)
    for q in (0.5, 0.9, 0.99):
        exact = data[round(q * (len(data) - 1))]
        assert abs(sk.quantile(q) - exact) / exact < 0.05


def test_sketch_centroids_identical_across_packages():
    def build(health, seed):
        rng = random.Random(seed)
        sk = health.QuantileSketch()
        for _ in range(5000):
            sk.add(rng.lognormvariate(0.0, 1.0))
        return sk

    for seed in (7, 8):
        assert build(thealth, seed).centroids() == build(rhealth, seed).centroids()


@both
def test_windowed_series_and_pipe_utilization(pkg):
    health = PACKAGES[pkg]["health"]
    s = health.WindowedSeries(window_s=1.0, max_windows=4)
    for t, v in [(0.1, 2.0), (0.9, 4.0), (1.5, 1.0), (7.2, 9.0)]:
        s.observe(t, v)
    assert [w.index for w in s.windows] == [0, 1, 7]
    assert (s.windows[0].count, s.windows[0].mean) == (2, 3.0) and s.overall_max() == 9.0
    p = health._PipeUtilization(window_s=1.0, max_windows=8)
    p.update(0.0, True)
    p.update(0.5, False)
    p.update(2.0, True)
    assert abs(p.utilization(4.0) - (0.5 + 1.0 + 1.0) / 3.0) < 1e-9


@both
def test_detectors_fire_at_their_thresholds(pkg):
    health = PACKAGES[pkg]["health"]
    hm = health.HealthMonitor(4, health.HealthConfig(thrash_evictions_per_window=4))
    hm.task_done(0, 1.0, service_s=0.2, expected_s=0.1)
    hm.task_done(0, 2.0, service_s=0.31, expected_s=0.1)
    hm.task_done(0, 3.0, service_s=0.04, expected_s=0.01)
    for t in (1.0, 2.0):
        hm.sample_queue(1, t, 9)
    hm.sample_queue(1, 3.0, 2)
    for t in (4.0, 5.0, 6.0, 7.0):
        hm.sample_queue(1, t, 10)
    hm.sample_memory(2, 0.1, 0.9, evictions_total=2)
    hm.sample_memory(2, 0.5, 0.9, evictions_total=5)
    for i in range(4):
        hm.on_transfer(4.0 + i, "spine.rack0", 1e6, 0.3, cross=True)
    assert hm.counts == {health.STRAGGLER: 1, health.QUEUE_BUILDUP: 1,
                         health.MEMORY_THRASH: 1, health.SPINE_SATURATION: 1}
    summary = hm.summary()
    PACKAGES[pkg]["tel"].validate_schema(summary, load_schema("health.schema.json"))
    assert set(health.DETECTOR_KINDS) == set(hm.counts)


class _Record:
    def __init__(self, job_id, arrival, finish):
        self.job_id, self.arrival, self.finish = job_id, arrival, finish

    @property
    def latency(self):
        return self.finish - self.arrival


class _Result:
    def __init__(self, records, trace):
        self.records, self.trace = records, trace


def _emit_diamond(rec):
    """``tests/test_telemetry.py``'s job 7: a 3-task DAG whose latency
    breakdown has a closed form (JCT 3.3 = queue 0.5 + input 0.2 + ship
    0.3 + fetch 0.8 + compute 1.5)."""
    E = rec.emit
    E(0.0, "job.arrive", job=7)
    E(0.0, "task.input", worker=0, job=7, task="a", gen=0, src="", frm=-1, to=0, arrive=0.0)
    E(0.0, "task.input", worker=1, job=7, task="b", gen=0, src="", frm=-1, to=1, arrive=0.2)
    E(0.2, "fetch.start", worker=1, fetch_kind="demand", model=3, bytes=1e9, dur=0.8, job=7,
      task="b")
    E(0.5, "task.start", worker=0, job=7, task="a", gen=0, model=-1, miss=False)
    E(1.0, "fetch.done", worker=1, model=3, spec=False)
    E(1.0, "task.start", worker=1, job=7, task="b", gen=0, model=3, miss=True)
    E(1.5, "task.done", worker=0, job=7, task="a", gen=0)
    E(1.5, "task.input", worker=0, job=7, task="c", gen=0, src="a", frm=0, to=0, arrive=1.5)
    E(2.0, "task.done", worker=1, job=7, task="b", gen=0)
    E(2.0, "task.input", worker=0, job=7, task="c", gen=0, src="b", frm=1, to=0, arrive=2.3)
    E(2.8, "task.start", worker=0, job=7, task="c", gen=0, model=-1, miss=False)
    E(3.3, "task.done", worker=0, job=7, task="c", gen=0)
    E(3.3, "job.done", job=7, latency=3.3)
    return 3.3


@both
def test_span_stitcher_closed_form(pkg):
    tel = PACKAGES[pkg]["tel"]
    rec = tel.FlightRecorder(2)
    report = tel.SimReport(_Result([_Record(7, 0.0, _emit_diamond(rec))], rec))
    c = report.final_span(7, "c")
    assert (c.t_send, c.input_s, c.queue_s, c.compute_s) == pytest.approx((2.0, 0.3, 0.5, 0.5))
    assert report.critical_path(7) == [("c", 0), ("b", 0)]
    bd = report.latency_breakdown(7)
    assert (bd.queue_s, bd.input_transfer_s, bd.output_ship_s, bd.fetch_wait_s,
            bd.compute_s) == pytest.approx((0.5, 0.2, 0.3, 0.8, 1.5))
    assert bd.components_sum_s == pytest.approx(bd.jct_s, abs=1e-12)
    chrome = json.loads(json.dumps(rec.to_chrome_trace()))
    tel.validate_schema(chrome, load_schema("trace.schema.json"))


def test_span_reports_match_reference():
    out = {}
    for pkg in PACKAGES:
        tel = PACKAGES[pkg]["tel"]
        rec = tel.FlightRecorder(2)
        report = tel.SimReport(_Result([_Record(7, 0.0, _emit_diamond(rec))], rec))
        out[pkg] = ({k: dataclasses.asdict(v) for k, v in report.spans.items()},
                    report.latency_breakdown(7).as_dict(), report.explain("c", 7),
                    rec.to_jsonl(), rec.to_chrome_trace())
    assert out["repro_torch"] == out["repro"]


@both
def test_recorder_drops_fifo_and_report_refuses(pkg):
    tel = PACKAGES[pkg]["tel"]
    with pytest.raises(ValueError):
        tel.SimReport(_Result([], None))
    rec = tel.FlightRecorder(1, tel.TraceConfig(ring_capacity=4))
    for i in range(10):
        rec.emit(float(i), "task.start", worker=0, job=0, task="t", gen=0, model=-1, miss=False)
    assert rec.dropped == 6
    with pytest.raises(ValueError, match="dropped"):
        _ = tel.SimReport(_Result([_Record(0, 0.0, 1.0)], rec)).spans


@both
def test_export_jsonl_gzip_deterministic(pkg, tmp_path):
    import gzip

    tel = PACKAGES[pkg]["tel"]
    rec = tel.FlightRecorder(2)
    _emit_diamond(rec)
    plain, gz_a, gz_b = (tmp_path / n for n in ("t.jsonl", "a.gz", "b.gz"))
    rec.export_jsonl(str(plain))
    rec.export_jsonl(str(gz_a), compress=True)
    rec.export_jsonl(str(gz_b), compress=True)
    assert gz_a.read_bytes() == gz_b.read_bytes()
    with gzip.open(gz_a, "rb") as f:
        assert f.read().decode("utf-8") == rec.to_jsonl() == plain.read_text()


@both
def test_validate_schema_rejects_bad_payloads(pkg):
    tel = PACKAGES[pkg]["tel"]
    schema = load_schema("metrics.schema.json")
    reg = tel.MetricsRegistry()
    reg.counter("jobs").inc(3)
    reg.histogram("lat", bounds=(0.1, 1.0)).observe(0.5)
    tel.validate_schema(reg.export(), schema)
    with pytest.raises(ValueError):
        tel.validate_schema({"metrics": []}, schema)
    with pytest.raises(ValueError):
        tel.validate_schema({"schema_version": 1,
                             "metrics": [{"name": "x", "type": "timer", "labels": {}}]}, schema)
    with pytest.raises(ValueError):
        tel.validate_schema({"schema_version": 1, "metrics": [], "extra": 1}, schema)
