"""The port's simulator (``repro_torch.sim``) and workflows
(``repro_torch.workflows``) against the JAX package's, which they copy.

The first tests run seeded simulations in both packages under the four
schedulers, with gossip, prefetch, churn, a rack topology, the flight
recorder and the health plane on, and require equal results bit for bit:
every job record, every statistic, the event log, the metrics export, the
recorder's JSONL and the health summary.  Trace files and the workflows'
catalogues are held equal across the packages too.

Then come the reference's own simulator cases (``tests/test_sim.py``,
``test_churn.py``, ``test_engine_indexed.py``, ``test_engine_parity.py``,
``test_partition.py``, ``test_metrics_churn.py``, and the simulator cases
of ``test_sst_gossip.py``, ``test_prefetch.py``, ``test_healthplane.py``
and ``test_telemetry.py``, with the ``tests/chaos.py`` harness they use):
each reference file's cases are copied below into one function of the
package they run on, which takes its names from that package, and every
case runs on both packages.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import json
import os
import tracemalloc
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("repro", "repro_torch")
both = pytest.mark.parametrize("pkg", PACKAGES)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Package:
    """One package's core, simulator and workflows by name: ``m("A B")``
    is ``(A, B)`` as ``repro`` or ``repro_torch`` exports them, and
    ``m.A`` is ``A``."""

    MODULES = ("core", "sim", "workflows", "core.healthplane", "core.memory", "core.netmodel",
               "core.packed", "core.prefetch", "core.profiles", "core.scheduler",
               "core.sst_exchange", "core.state", "core.telemetry", "core.types",
               "sim.tracefile", "sim.engine", "workflows.arch_pipelines")
    ALIASES = {"telemetry_mod": "core.telemetry"}

    def __init__(self, pkg: str) -> None:
        self.pkg = pkg

    def module(self, path: str):
        return importlib.import_module(f"{self.pkg}.{path}")

    def __getattr__(self, name: str):
        if name in self.ALIASES:
            return self.module(self.ALIASES[name])
        for path in self.MODULES:
            mod = self.module(path)
            if hasattr(mod, name):
                return getattr(mod, name)
        raise AttributeError(f"{self.pkg} has no {name!r}")

    def __call__(self, names: str) -> tuple:
        return tuple(getattr(self, n) for n in names.split())


# ---------------------------------------------------------------------------
# seeded runs of both packages, compared bit for bit
# ---------------------------------------------------------------------------
def run_everything(pkg, scheduler, seed=0, duration=30.0):
    """A seeded run of ``pkg``'s simulator with every option on: gossip,
    prefetch, a crash/drain/join and a partition, the ``rack2`` topology,
    the flight recorder (provenance on), the health plane and the event
    log; returns everything the run exposes, in plain values."""
    m = Package(pkg)
    cluster = m.fleet("rack2")
    profiles = m.ProfileRepository(cluster, m.MODELS)
    dfgs = m.paper_dfgs()
    for d in dfgs:
        profiles.register(d)
    jobs = m.poisson_workload(dfgs, m.fleet_scaled_rate(cluster, 1.5), duration, seed=seed)
    churn = [m.ChurnEvent(time=6.0, kind="crash", worker=1),
             m.ChurnEvent(time=9.0, kind="partition", groups=((0, 1, 2, 3), (4, 5, 6, 7))),
             m.ChurnEvent(time=11.0, kind="drain", worker=5),
             m.ChurnEvent(time=13.0, kind="heal"),
             m.ChurnEvent(time=16.0, kind="join", worker=1),
             m.ChurnEvent(time=20.0, kind="join", worker=5)]
    sim = m.Simulation(
        cluster, profiles, m.MODELS, scheduler=scheduler,
        gossip=m.GossipConfig(period_s=0.2, fanout=2), prefetch=m.PrefetchConfig(),
        lease=m.LeaseConfig(), churn=churn, record_events=True, trace=True, health=True,
        seed=seed + 1,
    )
    res = sim.run(jobs)
    stats = {name: getattr(res, name) for name, value in vars(type(res)).items()
             if isinstance(value, property)}
    stats.update(mean_latency=res.mean_latency, p50=res.percentile_latency(0.5),
                 p99=res.percentile_latency(0.99), energy=res.energy_joules(cluster))
    return dict(
        jobs=len(jobs),
        records=[dataclasses.astuple(r) for r in res.records],
        stats=stats,
        horizon=res.horizon, busy=res.busy_time, used=sorted(res.workers_used),
        completions=sorted(res.task_completions.items()),
        prefetch=dataclasses.asdict(res.prefetch_stats),
        events=res.event_log,
        metrics=json.dumps(res.metrics.export(), sort_keys=True),
        trace=res.trace.to_jsonl(),
        health=json.dumps(res.health.summary(), sort_keys=True),
        sst=[dataclasses.asdict(r) for r in sim.sst.view(None, res.horizon)],
    )


@pytest.mark.parametrize("scheduler", ["navigator", "jit", "heft", "hash"])
def test_simulation_matches_reference_with_every_option(scheduler):
    want = run_everything("repro", scheduler)
    got = run_everything("repro_torch", scheduler)
    assert want["jobs"] == len(want["records"]) > 20
    assert want["trace"] and want["events"]
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("engine", ["indexed", "reference"])
@pytest.mark.parametrize("options", ["plain", "noise-off", "configs"])
def test_simulation_matches_reference(options, engine):
    """Both event cores, the default options, runtime noise off, and
    the Navigator's and the memory manager's options."""
    out = {}
    for pkg in PACKAGES:
        m = Package(pkg)
        cluster = m.fleet("mixed")
        profiles = m.ProfileRepository(cluster, m.MODELS)
        for d in m.paper_dfgs():
            profiles.register(d)
        jobs = m.bursty_trace_workload(m.paper_dfgs(), 1.0, 40.0, seed=5)
        kw = dict(runtime_noise_sigma=0.0) if options == "noise-off" else {}
        if options == "configs":
            kw = dict(navigator_config=m.NavigatorConfig(use_dynamic_adjustment=False,
                                                         eviction_penalty_s=1.5),
                      eviction_policy="fifo", push_interval_s=1.0)
        res = m.Simulation(cluster, profiles, m.MODELS, seed=2, engine=engine,
                           record_events=True, **kw).run(jobs)
        out[pkg] = ([dataclasses.astuple(r) for r in res.records], res.event_log,
                    json.dumps(res.metrics.export(), sort_keys=True))
    assert out["repro_torch"] == out["repro"]


def test_tracefile_round_trips_across_packages(tmp_path):
    """A trace file written by either package reads back in the other:
    both write the same bytes, and each reads the other's jobs and task
    count as its own."""
    paths = {}
    for pkg in PACKAGES:
        m = Package(pkg)
        paths[pkg] = os.fspath(tmp_path / f"{pkg}.ctrc")
        m.synthesize_poisson_trace(paths[pkg], m.paper_dfgs(), 3.0, 400, seed=9)
    with open(paths["repro"], "rb") as a, open(paths["repro_torch"], "rb") as b:
        assert a.read() == b.read()
    for writer in PACKAGES:
        read = {}
        for reader in PACKAGES:
            m = Package(reader)
            catalogue = {d.name: d for d in m.paper_dfgs()}
            jobs = m.load_jobs(paths[writer], catalogue)
            read[reader] = ([(j.job_id, j.dfg.name, j.arrival_time) for j in jobs],
                            m.trace_task_count(paths[writer], catalogue),
                            m.read_header(paths[writer]))
        assert read["repro"] == read["repro_torch"] and read["repro"][1] >= 400


def test_workflows_match_reference():
    """``MODELS``, ``MODEL_SPECS``, ``DFG_MIX`` and the paper's four DFGs
    equal the reference's field for field; the arch pipelines keep the
    reference's model ids, model sizes and DFG shapes."""
    r, t = Package("repro"), Package("repro_torch")

    def dfg_fields(d):
        return (d.name, [dataclasses.asdict(s) for s in d.tasks.values()], sorted(d.edges))

    assert {k: dataclasses.asdict(v) for k, v in t.MODELS.items()} == \
        {k: dataclasses.asdict(v) for k, v in r.MODELS.items()}
    assert t.MODEL_SPECS == r.MODEL_SPECS and t.DFG_MIX == r.DFG_MIX
    assert [dfg_fields(d) for d in t.paper_dfgs()] == [dfg_fields(d) for d in r.paper_dfgs()]
    ra, ta = r.module("workflows.arch_pipelines"), t.module("workflows.arch_pipelines")
    assert ta.ARCH_MODEL_IDS == ra.ARCH_MODEL_IDS
    assert {k: dataclasses.asdict(v) for k, v in ta.arch_models().items()} == \
        {k: dataclasses.asdict(v) for k, v in ra.arch_models().items()}
    for rd, td in zip(ra.arch_dfgs(), ta.arch_dfgs()):
        assert (td.name, sorted(td.edges), list(td.tasks)) == \
            (rd.name, sorted(rd.edges), list(rd.tasks))
        for tid, spec in td.tasks.items():
            ref = rd.tasks[tid]
            assert (spec.model_id, spec.input_bytes, spec.output_bytes) == \
                (ref.model_id, ref.input_bytes, ref.output_bytes)


def test_arch_runtimes_differ_by_the_ratio_of_rates():
    """Each arch task's R(t) is the reference's times the ratio of the
    two rates (the TPU's against the H100's), but where the 1 ms floor of
    ``_serve_runtime_s`` binds: in both packages (whisper's transcription
    in neither, on the H100 alone: 3.3 ms on the TPU's rate)."""
    ra = Package("repro").module("workflows.arch_pipelines")
    ta = Package("repro_torch").module("workflows.arch_pipelines")
    ratio = ra._UTILIZED_FLOPS / ta._UTILIZED_FLOPS
    assert ratio < 1.0  # the H100's rate is the higher one
    scaled = 0
    for rd, td in zip(ra.arch_dfgs(), ta.arch_dfgs()):
        for tid, spec in td.tasks.items():
            ref = rd.tasks[tid].runtime_s
            if ref == 1e-3:  # floored in the reference, so in the port too
                assert spec.runtime_s == 1e-3, tid
            elif ref * ratio < 1e-3:
                assert spec.runtime_s == 1e-3, tid
            else:
                assert spec.runtime_s == pytest.approx(ref * ratio, rel=1e-12), tid
                scaled += 1
    assert scaled >= 8


def test_h100_cluster_holds_no_tpu_figure():
    """``H100_CLUSTER`` shares no figure with the reference's
    ``TPU_V5E_CLUSTER``."""
    tpu = Package("repro").TPU_V5E_CLUSTER
    h100 = Package("repro_torch").H100_CLUSTER
    assert h100.n_workers == 8 and h100.gpu_capacity_bytes == 80e9
    assert h100.network.bandwidth_bytes_per_s == 450e9
    for a, b in ((h100.network, tpu.network), (h100.link, tpu.link)):
        assert a.bandwidth_bytes_per_s != b.bandwidth_bytes_per_s
        assert a.delta_s != b.delta_s
    assert h100.gpu_power_active_w != tpu.gpu_power_active_w
    assert h100.gpu_power_idle_w != tpu.gpu_power_idle_w
    assert h100.gpu_capacity_bytes != tpu.gpu_capacity_bytes


# ---------------------------------------------------------------------------
# the reference's simulator cases, on each package
# ---------------------------------------------------------------------------
def _chaos(m, chaos):
    """``tests/chaos.py``'s harness on package ``m``."""
    (ALIVE, ChurnEvent, GossipConfig, LeaseConfig, MODELS, PrefetchConfig, ProfileRepository,
        SimResult, Simulation, fleet, fleet_scaled_rate, paper_dfgs, poisson_workload,
        validate_schedule) = m(
        "ALIVE ChurnEvent GossipConfig LeaseConfig MODELS PrefetchConfig "
        "ProfileRepository SimResult Simulation fleet fleet_scaled_rate "
        "paper_dfgs poisson_workload validate_schedule")

    SCRIPTED_SCHEDULE: Tuple[ChurnEvent, ...] = (
        ChurnEvent(time=8.0, kind="crash", worker=1),
        ChurnEvent(time=14.0, kind="drain", worker=3),
        ChurnEvent(time=24.0, kind="join", worker=1),
        ChurnEvent(time=30.0, kind="crash", worker=2),
        ChurnEvent(time=38.0, kind="join", worker=3),
        ChurnEvent(time=46.0, kind="join", worker=2),
    )

    def scripted_partition_schedule(n_workers: int) -> List[ChurnEvent]:
        """Two cuts with heals: an uneven split long enough for cross-cut
        leases to expire (dead_after_s=4 < 6 s outage), then a short blip
        that heals before anyone is declared dead — both sides of the
        detection race.  The split is the rack boundary on even fleets
        (front/back half), which matches the ``rack2`` preset's racks."""
        half = n_workers // 2
        a = tuple(range(half))
        b = tuple(range(half, n_workers))
        return [
            ChurnEvent(time=8.0, kind="partition", groups=(a, b)),
            ChurnEvent(time=14.0, kind="heal"),
            ChurnEvent(time=22.0, kind="partition", groups=(a, b)),
            ChurnEvent(time=24.0, kind="heal"),
        ]

    def run_churn_sim(
        scheduler: str = "navigator",
        fleet_name: str = "uniform",
        schedule: Optional[Sequence[ChurnEvent]] = None,
        rate: float = 1.5,
        duration: float = 60.0,
        seed: int = 3,
        sim_seed: int = 1,
        gossip: Optional[GossipConfig] = GossipConfig(period_s=0.2, fanout=2),
        lease: Optional[LeaseConfig] = LeaseConfig(),
        prefetch: Optional[PrefetchConfig] = None,
        record_events: bool = False,
        return_sim: bool = False,
        trace: bool = False,
        health: bool = False,
        engine: str = "indexed",
    ):
        """Build and run one churn scenario; returns (result, jobs, schedule),
        plus the finished ``Simulation`` when ``return_sim`` is set (the
        partition checker inspects the metadata plane post-run)."""
        cluster = fleet(fleet_name)
        profiles = ProfileRepository(cluster, MODELS)
        dfgs = paper_dfgs()
        for d in dfgs:
            profiles.register(d)
        jobs = poisson_workload(
            dfgs, fleet_scaled_rate(cluster, rate), duration, seed=seed
        )
        schedule = list(
            SCRIPTED_SCHEDULE if schedule is None else schedule
        )
        validate_schedule(schedule, cluster.n_workers)
        sim = Simulation(
            cluster,
            profiles,
            MODELS,
            scheduler=scheduler,
            gossip=gossip,
            lease=lease,
            churn=schedule,
            prefetch=prefetch,
            record_events=record_events,
            seed=sim_seed,
            trace=trace,
            health=health,
            engine=engine,
        )
        res = sim.run(jobs)
        if return_sim:
            return res, jobs, schedule, sim
        return res, jobs, schedule

    def check_invariants(
        res: SimResult, jobs, schedule: Sequence[ChurnEvent] = ()
    ) -> None:
        """Assert the churn-safety invariants on a finished run."""
        # 1. Every job terminates exactly once.
        assert len(res.records) == len(jobs), (
            f"jobs lost: {len(res.records)}/{len(jobs)} records"
        )
        ids = [r.job_id for r in res.records]
        assert len(ids) == len(set(ids)), "job completed more than once"
        for r in res.records:
            assert r.finish >= r.arrival, f"job {r.job_id} finished before arrival"

        # 2. Every task completes; completions balance against re-execution.
        assert res.task_completions is not None
        all_tasks = {
            (job.job_id, tid) for job in jobs for tid in job.dfg.tasks
        }
        missing = all_tasks - set(res.task_completions)
        assert not missing, f"tasks never completed: {sorted(missing)[:5]}"
        extra = set(res.task_completions) - all_tasks
        assert not extra, f"completions for unknown tasks: {sorted(extra)[:5]}"
        assert all(c >= 1 for c in res.task_completions.values())
        total = sum(res.task_completions.values())
        assert total == len(all_tasks) + res.outputs_recovered, (
            f"completion ledger off: {total} != "
            f"{len(all_tasks)} tasks + {res.outputs_recovered} re-executions"
        )

        # 3. Cache accounting balances.
        assert 0.0 <= res.cache_hit_rate <= 1.0
        lhs = res.cache_hits + res.cache_misses
        rhs = (
            res.model_exec_starts
            + res.lost_miss_attempts
            + res.demand_refetches
        )
        assert lhs == rhs, f"hit/miss ledger off: {lhs} != {rhs}"
        assert res.bytes_fetched >= 0.0
        assert res.churn_wasted_bytes >= 0.0
        assert res.prefetch_wasted_bytes >= 0.0

        # 4. Counter sanity.
        assert res.bounces >= 0 and res.tasks_rescued >= 0
        assert res.outputs_recovered >= 0
        applied = (
            res.churn_crashes
            + res.churn_joins
            + res.churn_drains
            + res.churn_partitions
            + res.churn_heals
        )
        assert applied <= len(schedule), "more churn applied than scheduled"
        kinds = [e.kind for e in schedule if e.time <= res.horizon]
        assert res.churn_crashes <= kinds.count("crash")
        assert res.churn_joins <= kinds.count("join")
        assert res.churn_drains <= kinds.count("drain")
        assert res.churn_partitions <= kinds.count("partition")
        assert res.churn_heals <= res.churn_partitions, (
            "more heals than cuts applied"
        )
        assert res.net_local_transfers >= 0
        assert res.net_cross_transfers >= res.net_contended_transfers >= 0

    def check_partition_invariants(
        res: SimResult,
        jobs,
        schedule: Sequence[ChurnEvent],
        sim: Simulation,
        reconverge_s: float = 3.0,
    ) -> None:
        """Family 5: the asymmetric-reachability properties a partition
        schedule must not break (run after ``check_invariants``)."""
        # Every cut that fired before the run ended was healed by then too
        # (a heal scheduled past the last job completion never processes, so
        # only assert balance once the horizon covers the final heal).
        heal_times = [e.time for e in schedule if e.kind == "heal"]
        if heal_times and res.horizon >= max(heal_times):
            assert res.churn_partitions == res.churn_heals, (
                f"run ended with an open cut: {res.churn_partitions} cuts, "
                f"{res.churn_heals} heals"
            )

        # No stale-epoch resurrection: a partitioned worker never died, so its
        # epoch only moved through real crash/drain rejoins — and no reader's
        # replica carries an epoch ahead of the owner's ground truth.
        churned = {
            e.worker for e in schedule if e.kind in ("crash", "drain", "join")
        }
        truth = sim.sst.view(None, res.horizon)
        for w in range(res.n_workers):
            if w not in churned:
                assert truth[w].epoch == 0, (
                    f"worker {w} bumped its epoch to {truth[w].epoch} without "
                    f"ever crashing — partitions must not look like deaths"
                )
        for reader in range(res.n_workers):
            if not sim._up[reader]:
                continue
            for w, row in enumerate(sim.sst.view(reader, res.horizon)):
                assert row.epoch <= truth[w].epoch, (
                    f"reader {reader} holds epoch {row.epoch} for worker {w}, "
                    f"ahead of ground truth {truth[w].epoch}"
                )

        # Reconvergence: once the final heal is ``reconverge_s`` in the past
        # (heartbeat relay across the healed cut needs a few gossip rounds),
        # every live reader classifies every live worker ALIVE again.
        last_heal = max(
            (e.time for e in schedule if e.kind == "heal"), default=0.0
        )
        if res.horizon < last_heal + reconverge_s:
            return  # run ended inside the convergence window; nothing to assert
        live = [w for w in range(res.n_workers) if sim._up[w]]
        for reader in live:
            view = sim.sst.view(reader, res.horizon)
            for w in live:
                assert view[w].liveness == ALIVE, (
                    f"{reconverge_s} s after the last heal, reader {reader} "
                    f"still classifies worker {w} as {view[w].liveness}"
                )

    def check_trace_determinism(**kwargs) -> None:
        """Family 6: same seed + config ⇒ byte-identical JSONL trace.  Runs
        the scenario twice with the flight recorder on and diffs the exports
        (kwargs are forwarded to ``run_churn_sim``).  With ``health=True``
        the health plane joins the oracle: the summary payload and the
        metrics export must also be byte-identical, and the metrics export
        must validate against the committed schema."""
        import json

        kwargs.pop("trace", None)
        kwargs.pop("return_sim", None)
        health = bool(kwargs.pop("health", False))
        a = run_churn_sim(trace=True, health=health, **kwargs)[0]
        b = run_churn_sim(trace=True, health=health, **kwargs)[0]
        if health:
            sa = json.dumps(a.health.summary(), sort_keys=True)
            sb = json.dumps(b.health.summary(), sort_keys=True)
            assert sa == sb, "health summary diverged between identical runs"
            import os

            validate_schema = m.validate_schema

            ea = json.dumps(a.metrics.export(), sort_keys=True)
            eb = json.dumps(b.metrics.export(), sort_keys=True)
            assert ea == eb, "metrics export diverged between identical runs"
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            with open(os.path.join(repo, "schemas", "metrics.schema.json")) as f:
                validate_schema(a.metrics.export(), json.load(f))
        ja, jb = a.trace.to_jsonl(), b.trace.to_jsonl()
        assert ja, "trace is empty"
        assert a.trace.dropped == 0, f"ring dropped {a.trace.dropped} events"
        if ja != jb:
            for i, (la, lb) in enumerate(zip(ja.splitlines(), jb.splitlines())):
                if la != lb:
                    raise AssertionError(
                        f"trace diverged at line {i}:\n  run A: {la}\n"
                        f"  run B: {lb}"
                    )
            raise AssertionError(
                f"trace lengths differ: {ja.count(chr(10))} vs "
                f"{jb.count(chr(10))} lines"
            )

    def check_engine_parity(**kwargs) -> None:
        """Family 7: the indexed event core is bit-exact with the reference
        engine — identical event stream, per-job records, and metrics export
        on the same scenario (kwargs are forwarded to ``run_churn_sim``)."""
        import json

        kwargs.pop("engine", None)
        kwargs.pop("record_events", None)
        kwargs.pop("return_sim", None)
        a = run_churn_sim(engine="indexed", record_events=True, **kwargs)[0]
        b = run_churn_sim(engine="reference", record_events=True, **kwargs)[0]
        ea, eb = a.event_log, b.event_log
        assert ea, "event log is empty"
        if ea != eb:
            for i, (la, lb) in enumerate(zip(ea, eb)):
                if la != lb:
                    raise AssertionError(
                        f"event stream diverged at #{i}: indexed {la!r} "
                        f"vs reference {lb!r}"
                    )
            raise AssertionError(
                f"event counts differ: indexed {len(ea)} vs reference {len(eb)}"
            )
        ra = [(r.job_id, r.arrival, r.finish, r.lower_bound) for r in a.records]
        rb = [(r.job_id, r.arrival, r.finish, r.lower_bound) for r in b.records]
        assert ra == rb, "job records diverged between engines"
        ma = json.dumps(a.metrics.export(), sort_keys=True)
        mb = json.dumps(b.metrics.export(), sort_keys=True)
        assert ma == mb, "metrics export diverged between engines"

    return locals()


def _sim(m, chaos):
    """``tests/test_sim.py``'s simulator cases on package ``m``."""
    (ClusterSpec, Job, MODELS, NavigatorConfig, ProfileRepository, Simulation,
        bursty_trace_workload, paper_dfgs, poisson_workload, translation_dfg) = m(
        "ClusterSpec Job MODELS NavigatorConfig ProfileRepository Simulation "
        "bursty_trace_workload paper_dfgs poisson_workload translation_dfg")

    def make_profiles(cluster):
        p = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            p.register(d)
        return p

    def run_sim(scheduler="navigator", rate=2.0, duration=120.0, seed=3, **kw):
        cluster = kw.pop("cluster", ClusterSpec(n_workers=5))
        profiles = make_profiles(cluster)
        jobs = poisson_workload(paper_dfgs(), rate, duration, seed=seed)
        sim = Simulation(cluster, profiles, MODELS, scheduler=scheduler, seed=1, **kw)
        return sim.run(jobs), jobs

    def test_all_jobs_complete(scheduler):
        res, jobs = run_sim(scheduler=scheduler)
        assert len(res.records) == len(jobs)
        for r in res.records:
            assert r.finish >= r.arrival
            # Lower bound uses *expected* runtimes; lognormal noise draws can
            # beat it slightly, so allow headroom below 1.0.
            assert r.slowdown > 0.5

    def test_single_job_near_lower_bound():
        """One job on an idle, warm cluster should finish close to its lower
        bound (only dispatch/transfer overheads + first fetches)."""
        cluster = ClusterSpec(n_workers=5)
        profiles = make_profiles(cluster)
        job = Job(0, translation_dfg(), arrival_time=0.0)
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator",
            runtime_noise_sigma=0.0, seed=0,
        )
        for mem in sim.memories:
            mem.preload([0, 1, 2])
            sim._publish_cache(sim.memories.index(mem))
        for w in cluster.workers():
            sim.sst.push(w, 0.0)
        res = sim.run([job])
        assert len(res.records) == 1
        assert res.records[0].slowdown < 1.15

    def test_navigator_beats_static_schedulers_high_load():
        """Claim C1 (vs HEFT/Hash): ≥2x mean latency advantage at high load."""
        nav, _ = run_sim("navigator", rate=2.0, duration=200.0)
        heft, _ = run_sim("heft", rate=2.0, duration=200.0)
        hsh, _ = run_sim("hash", rate=2.0, duration=200.0)
        assert heft.mean_latency > 2.0 * nav.mean_latency
        assert hsh.mean_latency > 2.0 * nav.mean_latency

    def test_navigator_not_worse_than_jit():
        """Aggregated over seeds (single-seed comparisons are noise-dominated)."""
        nav = [run_sim("navigator", rate=2.0, duration=200.0, seed=s)[0].mean_slowdown
               for s in (3, 7, 11)]
        jit = [run_sim("jit", rate=2.0, duration=200.0, seed=s)[0].mean_slowdown
               for s in (3, 7, 11)]
        assert sum(nav) <= sum(jit) * 1.05

    def test_navigator_cache_hit_rate_high():
        """Claim C2: ~99% hit rate at the paper's high-load setting."""
        nav, _ = run_sim("navigator", rate=2.0, duration=200.0)
        assert nav.cache_hit_rate > 0.97

    def test_ablation_dynamic_adjustment_helps():
        cfg_off = NavigatorConfig(use_dynamic_adjustment=False)
        on = off = 0.0
        for s in (3, 7, 11):
            r_on, _ = run_sim("navigator", rate=2.0, duration=200.0, seed=s)
            r_off, _ = run_sim(
                "navigator", rate=2.0, duration=200.0, seed=s,
                navigator_config=cfg_off,
            )
            on += r_on.mean_slowdown
            off += r_off.mean_slowdown
            assert r_off.adjustments == 0 and r_on.adjustments > 0
        assert off >= on * 0.95  # adjustment is never much worse, usually better

    def test_ablation_model_locality_matters():
        """Claim C3: disabling locality degrades latency substantially and
        drops the hit rate."""
        cfg_off = NavigatorConfig(use_model_locality=False)
        on, _ = run_sim("navigator", rate=2.0, duration=200.0)
        off, _ = run_sim(
            "navigator", rate=2.0, duration=200.0, navigator_config=cfg_off
        )
        assert off.mean_slowdown > 1.5 * on.mean_slowdown
        assert off.cache_hit_rate < on.cache_hit_rate

    def test_eviction_policy_lookahead_not_worse():
        la, _ = run_sim("navigator", rate=2.0, duration=200.0,
                        eviction_policy="lookahead")
        ff, _ = run_sim("navigator", rate=2.0, duration=200.0,
                        eviction_policy="fifo")
        assert la.cache_evictions <= ff.cache_evictions * 1.25

    def test_staleness_degrades_gracefully():
        """Claim C4: finer dissemination should not be worse; very stale load
        info hurts."""
        fresh, _ = run_sim("navigator", rate=2.0, duration=200.0,
                           push_interval_s=0.1)
        stale, _ = run_sim("navigator", rate=2.0, duration=200.0,
                           push_interval_s=2.0)
        assert stale.mean_slowdown >= fresh.mean_slowdown * 0.9

    def test_energy_and_utilization_metrics():
        res, _ = run_sim("navigator", rate=2.0, duration=120.0)
        cluster = ClusterSpec(n_workers=5)
        assert 0.0 < res.gpu_utilization < 1.0
        assert res.energy_joules(cluster) > 0
        assert res.percentile_latency(0.5) <= res.percentile_latency(0.99)

    def test_bursty_workload_completes():
        cluster = ClusterSpec(n_workers=5)
        profiles = make_profiles(cluster)
        jobs = bursty_trace_workload(paper_dfgs(), 0.5, 120.0, seed=5)
        res = Simulation(cluster, profiles, MODELS, scheduler="navigator", seed=2).run(jobs)
        assert len(res.records) == len(jobs)

    def test_deterministic_given_seed():
        a, _ = run_sim("navigator", rate=1.0, duration=60.0, seed=11)
        b, _ = run_sim("navigator", rate=1.0, duration=60.0, seed=11)
        assert a.mean_latency == b.mean_latency
        assert a.cache_hits == b.cache_hits

    return locals()


def _churn(m, chaos):
    """``tests/test_churn.py``'s simulator cases on package ``m``."""
    (ChurnEvent, ClusterSpec, GossipConfig, Job, LeaseConfig, MODELS, PrefetchConfig,
        ProfileRepository, Simulation, churn_schedule, fleet, paper_dfgs,
        poisson_workload, translation_dfg, validate_schedule) = m(
        "ChurnEvent ClusterSpec GossipConfig Job LeaseConfig MODELS "
        "PrefetchConfig ProfileRepository Simulation churn_schedule fleet "
        "paper_dfgs poisson_workload translation_dfg validate_schedule")
    (check_invariants, run_churn_sim) = chaos(
        "check_invariants run_churn_sim")

    def test_invariants_scripted_schedule(policy, fleet_name):
        res, jobs, schedule = run_churn_sim(
            scheduler=policy, fleet_name=fleet_name, duration=60.0
        )
        check_invariants(res, jobs, schedule)
        assert res.churn_crashes >= 1 and res.churn_drains >= 1
        assert res.churn_joins >= 1

    def test_invariants_generated_schedule_heterogeneous(policy):
        """MTBF-generated churn on the heterogeneous fleet, prefetch plane on
        (the configuration with the most cross-layer interaction)."""
        schedule = churn_schedule(
            5, 60.0, mtbf_s=60.0, repair_s=10.0, seed=7, drain_fraction=0.3
        )
        res, jobs, schedule = run_churn_sim(
            scheduler=policy,
            fleet_name="mixed",
            schedule=schedule,
            duration=60.0,
            prefetch=PrefetchConfig(),
        )
        check_invariants(res, jobs, schedule)
        assert res.tasks_rescued > 0

    def test_invariants_shared_state_table_plane():
        """Churn must also be safe on the centralized-snapshot metadata plane
        (lease ages derive from publication lag instead of gossip lag)."""
        res, jobs, schedule = run_churn_sim(
            scheduler="navigator", gossip=None, duration=60.0
        )
        check_invariants(res, jobs, schedule)
        assert res.churn_crashes >= 1

    def test_navigator_rescues_fewer_tasks_than_blind_hash():
        """Membership-aware placement routes around workers its view marks
        DEAD; hash keeps throwing tasks at corpses, every one of which needs
        a dead-letter rescue."""
        schedule = churn_schedule(
            5, 60.0, mtbf_s=50.0, repair_s=12.0, seed=5, drain_fraction=0.0
        )
        nav, jobs, schedule = run_churn_sim(
            scheduler="navigator", schedule=schedule, duration=60.0
        )
        hsh, _, _ = run_churn_sim(
            scheduler="hash", schedule=schedule, duration=60.0
        )
        assert nav.tasks_rescued < hsh.tasks_rescued

    def test_churn_trace_is_deterministic(gossip):
        """The same seeded churn trace run twice yields identical event logs
        and final metrics — any nondeterministic dict/set iteration in the
        recovery paths would diverge here."""
        kw = dict(
            scheduler="navigator",
            fleet_name="mixed",
            gossip=gossip,
            duration=45.0,
            prefetch=PrefetchConfig(),
            record_events=True,
        )
        a, jobs_a, _ = run_churn_sim(**kw)
        b, jobs_b, _ = run_churn_sim(**kw)
        assert a.event_log == b.event_log  # same events, same order, same times
        assert a.mean_latency == b.mean_latency
        assert a.cache_hits == b.cache_hits
        assert a.tasks_rescued == b.tasks_rescued
        assert a.outputs_recovered == b.outputs_recovered
        assert a.task_completions == b.task_completions
        assert a.churn_wasted_bytes == b.churn_wasted_bytes

    def tiny_sim(n_workers=2, scheduler="navigator", churn=(), **kw):
        cluster = ClusterSpec(n_workers=n_workers)
        profiles = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            profiles.register(d)
        return Simulation(
            cluster,
            profiles,
            MODELS,
            scheduler=scheduler,
            gossip=GossipConfig(period_s=0.1, fanout=n_workers - 1),
            lease=LeaseConfig(),
            churn=list(churn),
            runtime_noise_sigma=0.0,
            seed=0,
            **kw,
        )

    def test_no_ghost_completion_inside_detection_window():
        """A task whose runtime ends after the crash but before detection
        must NOT complete on the corpse: the crash voids the attempt
        immediately even though re-placement waits for the lease."""
        DFG = m.DFG
        TaskSpec = m.TaskSpec

        dfg = DFG(
            "one", tasks=[TaskSpec("t", 0.5, output_bytes=1e4)], edges=[]
        )
        cluster = ClusterSpec(n_workers=2)
        profiles = ProfileRepository(cluster, MODELS)
        profiles.register(dfg)
        job = Job(0, dfg, arrival_time=0.0)
        lease = LeaseConfig()
        crash_t = 0.2
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator",
            gossip=GossipConfig(period_s=0.1, fanout=1),
            lease=lease,
            churn=[
                ChurnEvent(time=crash_t, kind="crash", worker=0),
                ChurnEvent(time=10.0, kind="join", worker=0),
            ],
            runtime_noise_sigma=0.0, seed=0,
        )
        res = sim.run([job])
        assert len(res.records) == 1
        # Origin is worker 0 and the cluster is idle, so the task ran there;
        # the ghost completion would have landed at t = 0.5 < detection.
        # With the fix the job only finishes after detection-time recovery.
        assert res.records[0].finish > crash_t + lease.detection_delay_s
        assert res.tasks_rescued >= 1
        check_invariants(res, [job], sim.churn)

    def test_crash_drops_running_task_and_reexecutes():
        """A worker crash mid-execution voids the attempt; the task re-runs
        elsewhere and the job still completes (completions ledger shows the
        retry)."""
        job = Job(0, translation_dfg(), arrival_time=0.0)
        # Crash both the origin and its neighbour early: whichever worker got
        # the entry task loses it.
        sim = tiny_sim(
            n_workers=3,
            churn=[
                ChurnEvent(time=0.3, kind="crash", worker=0),
                ChurnEvent(time=5.0, kind="join", worker=0),
            ],
        )
        res = sim.run([job])
        assert len(res.records) == 1
        check_invariants(res, [job], sim.churn)
        assert res.tasks_rescued + res.outputs_recovered >= 1

    def test_drain_finishes_running_task_then_departs():
        job = Job(0, translation_dfg(), arrival_time=0.0)
        sim = tiny_sim(
            n_workers=3,
            churn=[ChurnEvent(time=0.3, kind="drain", worker=0)],
        )
        res = sim.run([job])
        assert len(res.records) == 1
        assert res.churn_drains == 1
        # A drain never voids a completion: nothing was double-completed.
        check_invariants(res, [job], sim.churn)

    def test_join_triggers_anti_entropy_full_sync_in_sim():
        schedule = [
            ChurnEvent(time=5.0, kind="crash", worker=1),
            ChurnEvent(time=12.0, kind="join", worker=1),
        ]
        jobs = poisson_workload(paper_dfgs(), 1.0, 30.0, seed=2)
        sim = tiny_sim(n_workers=4, churn=schedule)
        res = sim.run(jobs)
        assert len(res.records) == len(jobs)
        assert sim.sst.full_syncs > 0  # the joiner was rebuilt by full sync

    def test_rejoined_worker_executes_new_work():
        """After rejoin the worker is schedulable again (fresh epoch row
        disseminates and the planner sees it ALIVE)."""
        schedule = [
            ChurnEvent(time=2.0, kind="crash", worker=1),
            ChurnEvent(time=6.0, kind="join", worker=1),
        ]
        jobs = poisson_workload(paper_dfgs(), 2.0, 40.0, seed=4)
        sim = tiny_sim(n_workers=2, churn=schedule)
        res = sim.run(jobs)
        assert len(res.records) == len(jobs)
        post_join = [
            r for r in res.records if r.arrival > 10.0
        ]
        assert post_join  # workload extends past the rejoin
        assert 1 in res.workers_used

    def test_churn_wasted_bytes_accounted_under_prefetch():
        schedule = churn_schedule(
            5, 60.0, mtbf_s=40.0, repair_s=8.0, seed=3, drain_fraction=0.2
        )
        res, jobs, schedule = run_churn_sim(
            scheduler="navigator",
            schedule=schedule,
            duration=60.0,
            prefetch=PrefetchConfig(),
        )
        check_invariants(res, jobs, schedule)
        # Crashes wiped caches: the lost residency shows up in the ledger.
        assert res.churn_wasted_bytes > 0.0

    def test_orphaned_intents_are_rehomed():
        schedule = churn_schedule(
            5, 60.0, mtbf_s=30.0, repair_s=8.0, seed=3, drain_fraction=0.0
        )
        res, jobs, schedule = run_churn_sim(
            scheduler="navigator",
            schedule=schedule,
            duration=60.0,
            prefetch=PrefetchConfig(lookahead_depth=8),
        )
        check_invariants(res, jobs, schedule)
        assert res.prefetch_stats is not None
        assert res.prefetch_stats.intents_orphaned > 0
        # Orphans whose tasks were re-routed were re-issued on the heirs.
        assert res.prefetch_stats.intents_rehomed > 0

    def test_permanent_capability_loss_raises_instead_of_hanging():
        """If the only worker able to host a model leaves forever, the sim
        must fail loudly, not spin retry events for eternity."""
        make_fleet = m.fleet
        GB = m.GB
        PR = m.ProfileRepository

        cluster = make_fleet("edge_heavy")  # big models fit only worker 0
        profiles = PR(cluster, MODELS)
        for d in paper_dfgs():
            profiles.register(d)
        jobs = poisson_workload(paper_dfgs(), 1.0, 20.0, seed=2)
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator",
            gossip=GossipConfig(period_s=0.2, fanout=2), lease=LeaseConfig(),
            churn=[ChurnEvent(time=3.0, kind="crash", worker=0)],  # no rejoin
            seed=1,
        )
        with pytest.raises(ValueError, match="future fleet member"):
            sim.run(jobs)

    def test_join_during_drain_cancels_the_drain():
        """A join landing while a drain is still finishing its running task
        un-drains the worker instead of being silently dropped (a drop would
        remove the worker from the fleet forever)."""
        jobs = poisson_workload(paper_dfgs(), 2.0, 30.0, seed=4)
        sim = tiny_sim(
            n_workers=2,
            churn=[
                # Drain under load: worker 0 almost certainly has a running
                # task at t=5, so the drain lingers; the join lands mid-drain.
                ChurnEvent(time=5.0, kind="drain", worker=0),
                ChurnEvent(time=5.05, kind="join", worker=0),
            ],
        )
        res = sim.run(jobs)
        assert len(res.records) == len(jobs)
        assert sim._up[0] and not sim._draining[0]  # still a fleet member

    def test_drain_flushes_outputs_no_pointless_reexecution():
        """Graceful drain waited for its running task; the output it produced
        must survive the departure (flushed to an heir), so JIT's deferred
        input shipping does not force a re-execution of work a drain
        deliberately completed."""
        job = Job(0, translation_dfg(), arrival_time=0.0)
        sim = tiny_sim(
            n_workers=3,
            scheduler="jit",
            churn=[ChurnEvent(time=0.3, kind="drain", worker=0)],
        )
        res = sim.run([job])
        assert len(res.records) == 1
        check_invariants(res, [job], sim.churn)
        assert res.outputs_recovered == 0  # nothing thrown away

    def test_capacity_bounces_counted_on_heterogeneous_fleet():
        res, jobs, schedule = run_churn_sim(
            scheduler="hash", fleet_name="mixed", duration=60.0
        )
        check_invariants(res, jobs, schedule)
        assert res.bounces > 0  # 8 GB edge GPU rejects the big models

    def profiles():
        cluster = ClusterSpec(n_workers=3)
        p = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            p.register(d)
        return p

    def test_churn_schedule_deterministic_and_valid():
        a = churn_schedule(5, 300.0, mtbf_s=120.0, seed=42)
        b = churn_schedule(5, 300.0, mtbf_s=120.0, seed=42)
        assert a == b
        assert a  # MTBF 120 s over 5 workers × 300 s produces events
        validate_schedule(a, 5)

    def test_validate_schedule_rejects_bad_sequences():
        with pytest.raises(ValueError):
            validate_schedule(
                [ChurnEvent(1.0, "crash", 7)], n_workers=5
            )
        with pytest.raises(ValueError):
            validate_schedule(
                [
                    ChurnEvent(1.0, "crash", 0),
                    ChurnEvent(2.0, "crash", 0),  # already down
                ],
                n_workers=5,
            )
        with pytest.raises(ValueError):
            validate_schedule(
                [ChurnEvent(1.0, "join", 0)], n_workers=5  # join of live worker
            )
        with pytest.raises(ValueError):
            ChurnEvent(1.0, "explode", 0)

    def test_recovery_routes_through_navigator_hook():
        """End to end: every stranded task's new home is chosen by the
        Navigator hook (never the greedy fallback) on a crash schedule."""
        cluster = fleet("mixed")
        p = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            p.register(d)
        jobs = poisson_workload(paper_dfgs(), 2.0, 40.0, seed=3)
        sim = Simulation(
            cluster, p, MODELS, scheduler="navigator", seed=1,
            churn=[
                ChurnEvent(time=6.0, kind="crash", worker=1),
                ChurnEvent(time=20.0, kind="join", worker=1),
            ],
        )
        calls = []
        orig = sim.scheduler.select_recovery_worker

        def spy(*args, **kwargs):
            choice = orig(*args, **kwargs)
            calls.append(choice)
            return choice

        sim.scheduler.select_recovery_worker = spy
        res = sim.run(jobs)
        assert len(res.records) == len(jobs)
        assert calls, "crash stranded no work: hook never consulted"
        assert all(c is not None for c in calls)

    return locals()


def _engine_indexed(m, chaos):
    """``tests/test_engine_indexed.py``'s simulator cases on package ``m``."""
    (ClusterSpec, LeaseConfig, MODELS, ProfileRepository, Simulation, TraceFormatError,
        load_jobs, paper_dfgs, poisson_workload, read_header, synthesize_poisson_trace,
        trace_task_count, write_trace) = m(
        "ClusterSpec LeaseConfig MODELS ProfileRepository Simulation "
        "TraceFormatError load_jobs paper_dfgs poisson_workload read_header "
        "synthesize_poisson_trace trace_task_count write_trace")

    def make_profiles(cluster):
        p = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            p.register(d)
        return p

    def test_full_sim_engine_parity(scheduler, plane):
        """Indexed vs reference engine on a seeded workload: identical event
        stream, job records, and metrics export."""
        import json

        GossipConfig = m.GossipConfig

        cluster = ClusterSpec(n_workers=5)
        dfgs = paper_dfgs()
        jobs = poisson_workload(dfgs, 1.5, 40.0, seed=9)

        def run(engine):
            profiles = make_profiles(cluster)
            sim = Simulation(
                cluster, profiles, MODELS, scheduler=scheduler, seed=1,
                gossip=GossipConfig(period_s=0.2, fanout=2)
                if plane == "gossip" else None,
                lease=LeaseConfig() if plane == "gossip" else None,
                record_events=True, engine=engine,
            )
            return sim.run(jobs)

        a, b = run("indexed"), run("reference")
        assert a.event_log == b.event_log
        assert [
            (r.job_id, r.arrival, r.finish, r.lower_bound) for r in a.records
        ] == [
            (r.job_id, r.arrival, r.finish, r.lower_bound) for r in b.records
        ]
        assert json.dumps(a.metrics.export(), sort_keys=True) == json.dumps(
            b.metrics.export(), sort_keys=True
        )

    def test_engine_rejects_unknown_name():
        cluster = ClusterSpec(n_workers=3)
        with pytest.raises(ValueError):
            Simulation(cluster, make_profiles(cluster), MODELS, engine="turbo")

    def test_tracefile_roundtrip(tmp_path):
        path = os.fspath(tmp_path / "t.ctrc")
        dfgs = paper_dfgs()
        cat = {d.name: d for d in dfgs}
        recs = [(0.5, 0), (1.25, 2), (3.0, 1), (3.0, 3)]
        n = write_trace(path, [d.name for d in dfgs], recs)
        assert n == 4
        version, names, n_jobs = read_header(path)
        assert (version, n_jobs) == (1, 4)
        assert names == [d.name for d in dfgs]
        jobs = load_jobs(path, cat)
        assert [(j.arrival_time, j.dfg.name) for j in jobs] == [
            (t, names[i]) for t, i in recs
        ]
        assert [j.job_id for j in jobs] == [0, 1, 2, 3]
        assert trace_task_count(path, cat) == sum(
            len(cat[names[i]].tasks) for _, i in recs
        )
        # limit= replays a strict prefix (same job ids, same arrivals).
        head = load_jobs(path, cat, limit=2)
        assert [(j.job_id, j.arrival_time) for j in head] == [
            (j.job_id, j.arrival_time) for j in jobs[:2]
        ]

    def test_synthesize_poisson_trace_deterministic(tmp_path):
        dfgs = paper_dfgs()
        pa, pb = os.fspath(tmp_path / "a.ctrc"), os.fspath(tmp_path / "b.ctrc")
        na = synthesize_poisson_trace(pa, dfgs, 20.0, 2000, seed=5)
        nb = synthesize_poisson_trace(pb, dfgs, 20.0, 2000, seed=5)
        assert na == nb
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
        cat = {d.name: d for d in dfgs}
        assert trace_task_count(pa, cat) >= 2000
        jobs = load_jobs(pa, cat)
        assert len(jobs) == na
        arrivals = [j.arrival_time for j in jobs]
        assert arrivals == sorted(arrivals)

    def test_tracefile_format_errors(tmp_path):
        path = os.fspath(tmp_path / "t.ctrc")
        write_trace(path, ["a"], [(1.0, 0)])
        raw = open(path, "rb").read()
        bad_magic = os.fspath(tmp_path / "m.ctrc")
        with open(bad_magic, "wb") as f:
            f.write(b"XXXX" + raw[4:])
        with pytest.raises(TraceFormatError):
            read_header(bad_magic)
        bad_version = os.fspath(tmp_path / "v.ctrc")
        with open(bad_version, "wb") as f:
            f.write(raw[:4] + b"\x63\x00" + raw[6:])
        with pytest.raises(TraceFormatError):
            read_header(bad_version)
        truncated = os.fspath(tmp_path / "s.ctrc")
        with open(truncated, "wb") as f:
            f.write(raw[:-4])
        with pytest.raises(TraceFormatError):
            load_jobs(truncated, {"a": paper_dfgs()[0]})
        with pytest.raises(TraceFormatError):
            load_jobs(path, {"other": paper_dfgs()[0]})
        with pytest.raises(ValueError):
            write_trace(os.fspath(tmp_path / "r.ctrc"), ["a"], [(1.0, 3)])

    return locals()


def _partition(m, chaos):
    """``tests/test_partition.py``'s simulator cases on package ``m``."""
    (ChurnEvent, PrefetchConfig, partition_schedule, validate_schedule) = m(
        "ChurnEvent PrefetchConfig partition_schedule validate_schedule")
    (check_invariants, check_partition_invariants, run_churn_sim, scripted_partition_schedule) = chaos(
        "check_invariants check_partition_invariants run_churn_sim "
        "scripted_partition_schedule")

    def test_partition_schedule_well_formed():
        sched = partition_schedule(8, duration_s=60.0, mtbp_s=20.0, seed=3)
        validate_schedule(sched, 8)
        kinds = [e.kind for e in sched]
        assert kinds.count("partition") == kinds.count("heal") > 0
        # Cuts never overlap and every cut heals.
        open_cut = False
        for e in sched:
            if e.kind == "partition":
                assert not open_cut
                open_cut = True
                assert e.groups is not None and len(e.groups) >= 2
            elif e.kind == "heal":
                assert open_cut
                open_cut = False
        assert not open_cut

    def test_partition_schedule_deterministic():
        a = partition_schedule(8, 60.0, mtbp_s=20.0, seed=5)
        b = partition_schedule(8, 60.0, mtbp_s=20.0, seed=5)
        assert a == b
        c = partition_schedule(8, 60.0, mtbp_s=20.0, seed=6)
        assert a != c

    def test_unhealed_partition_rejected():
        sched = [ChurnEvent(time=5.0, kind="partition", groups=((0, 1), (2, 3)))]
        with pytest.raises(ValueError):
            validate_schedule(sched, 4)

    FLEETS = ("uniform", "rack2")

    POLICIES = ("navigator", "hash")

    def test_scripted_partition_invariants(policy, fleet_name):
        """The scripted rack-boundary cut scenario upholds every churn and
        partition invariant: no job or task lost, no double commit across a
        heal, no stale-epoch resurrection, bounded reconvergence."""
        fleet = m.fleet

        n = fleet(fleet_name).n_workers
        schedule = scripted_partition_schedule(n)
        res, jobs, schedule, sim = run_churn_sim(
            scheduler=policy,
            fleet_name=fleet_name,
            schedule=schedule,
            duration=30.0,
            prefetch=PrefetchConfig(),
            return_sim=True,
        )
        check_invariants(res, jobs, schedule)
        check_partition_invariants(res, jobs, schedule, sim)
        assert res.churn_partitions == 2 and res.churn_heals == 2

    def test_generated_partition_invariants():
        """Seeded generated cut schedules (not just the scripted one) uphold
        the same family, including cuts interleaved with gossip."""
        fleet = m.fleet

        n = fleet("rack2").n_workers
        for seed in (0, 7):
            schedule = partition_schedule(
                n, duration_s=40.0, mtbp_s=15.0, outage_s=5.0, seed=seed
            )
            res, jobs, schedule, sim = run_churn_sim(
                scheduler="navigator",
                fleet_name="rack2",
                schedule=schedule,
                duration=40.0,
                seed=seed + 1,
                return_sim=True,
            )
            check_invariants(res, jobs, schedule)
            check_partition_invariants(res, jobs, schedule, sim)

    def test_partition_with_crash_overlap():
        """A worker that crashes *while partitioned away* must recover through
        the normal epoch-bump path; peers that merely presumed it dead across
        the cut must not have committed its tasks twice."""
        schedule = [
            ChurnEvent(time=6.0, kind="partition",
                       groups=((0, 1, 2, 3), (4, 5, 6, 7))),
            ChurnEvent(time=8.0, kind="crash", worker=6),
            ChurnEvent(time=13.0, kind="heal"),
            ChurnEvent(time=18.0, kind="join", worker=6),
        ]
        res, jobs, schedule, sim = run_churn_sim(
            scheduler="navigator",
            fleet_name="rack2",
            schedule=schedule,
            duration=30.0,
            return_sim=True,
        )
        check_invariants(res, jobs, schedule)
        check_partition_invariants(res, jobs, schedule, sim)
        truth = sim.sst.view(None, res.horizon)
        assert truth[6].epoch == 1  # exactly the one real rejoin

    def test_partition_bit_exact_determinism():
        """Same seeds, same schedule → byte-identical event logs, on the rack
        fleet with cuts, heals, gossip, and prefetch all active."""
        logs = []
        for _ in range(2):
            n = 8
            res, jobs, schedule = run_churn_sim(
                scheduler="navigator",
                fleet_name="rack2",
                schedule=scripted_partition_schedule(n),
                duration=30.0,
                prefetch=PrefetchConfig(),
                record_events=True,
            )
            logs.append((res.event_log, res.mean_latency, res.tasks_rescued))
        assert logs[0] == logs[1]

    def test_partition_forces_failover_work():
        """The long scripted cut actually exercises the failover machinery —
        the invariants above must not be vacuously true.  Hash placement
        ignores racks, so it keeps shipping across the spine into the cut and
        must rescue or re-execute; the topology-aware navigator, by contrast,
        mostly rides it out rack-locally."""
        res, jobs, schedule = run_churn_sim(
            scheduler="hash",
            fleet_name="rack2",
            schedule=scripted_partition_schedule(8),
            duration=30.0,
            prefetch=PrefetchConfig(),
        )
        assert res.churn_partitions == 2
        assert (res.tasks_rescued + res.outputs_recovered + res.bounces) > 0

    return locals()


def _metrics_churn(m, chaos):
    """``tests/test_metrics_churn.py``'s simulator cases on package ``m``."""
    (GossipConfig, validate_schema) = m(
        "GossipConfig validate_schema")
    (SCRIPTED_SCHEDULE, check_invariants, run_churn_sim, scripted_partition_schedule) = chaos(
        "SCRIPTED_SCHEDULE check_invariants run_churn_sim "
        "scripted_partition_schedule")

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def load_schema(name):
        with open(os.path.join(REPO, "schemas", name)) as f:
            return json.load(f)

    def _export(**kwargs):
        res, jobs, schedule = run_churn_sim(**kwargs)
        return res, jobs, schedule, res.metrics.export()

    def test_export_schema_valid_under_churn_all_planes():
        schema = load_schema("metrics.schema.json")
        for plane_kwargs in (
            {},                                     # gossip plane (default)
            {"gossip": None},                       # shared-table plane
            {"gossip": GossipConfig(period_s=0.2, fanout=2), "health": True,
             "trace": True},                        # full observability stack
        ):
            res, jobs, schedule, exp = _export(
                duration=20.0, **plane_kwargs
            )
            validate_schema(exp, schema)
            check_invariants(res, jobs, schedule)
            assert int(res.metrics.value("sim.jobs_completed")) == len(
                res.records
            ) == len(jobs)

    def test_export_schema_valid_under_partition():
        schema = load_schema("metrics.schema.json")
        res, jobs, schedule, exp = _export(
            schedule=scripted_partition_schedule(5), duration=20.0,
            health=True, trace=True,
        )
        validate_schema(exp, schema)
        assert int(res.metrics.value("churn.events", kind="partition")) >= 1
        assert int(res.metrics.value("churn.events", kind="heal")) >= 1

    def test_churn_counters_monotone_in_schedule_prefix():
        """Running progressively longer prefixes of the scripted schedule
        must never decrease any churn.events counter — each injected event
        is either applied (counted once) or past the horizon."""
        prev = {}
        for cut in range(len(SCRIPTED_SCHEDULE) + 1):
            res, jobs, schedule, exp = _export(
                schedule=list(SCRIPTED_SCHEDULE[:cut]), duration=60.0
            )
            counts = {
                kind: int(res.metrics.value("churn.events", kind=kind))
                for kind in ("crash", "join", "drain")
            }
            for kind, c in counts.items():
                assert c >= prev.get(kind, 0), (
                    f"churn.events[{kind}] shrank from {prev.get(kind)} to "
                    f"{c} with a longer schedule prefix"
                )
            scheduled = [e.kind for e in SCRIPTED_SCHEDULE[:cut]]
            for kind, c in counts.items():
                assert c <= scheduled.count(kind)
            prev = counts
        # The full schedule applies completely on the 60 s horizon.
        assert prev == {"crash": 2, "join": 3, "drain": 1}

    def test_export_deterministic_across_reruns():
        kwargs = dict(duration=20.0, health=True, trace=True)
        _res_a, _j, _s, a = _export(**kwargs)
        _res_b, _j, _s, b = _export(**kwargs)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)

    def test_trace_ring_counters_mirror_recorder_under_churn():
        res, jobs, schedule, exp = _export(duration=20.0, trace=True)
        stats = res.trace.ring_stats()
        for ring, (emitted, dropped) in stats.items():
            assert int(res.metrics.value("trace.emitted", ring=ring)) == emitted
            assert int(res.metrics.value("trace.dropped", ring=ring)) == dropped
        assert sum(d for _, d in stats.values()) == res.trace.dropped

    def test_health_counters_in_export_under_churn():
        res, jobs, schedule, exp = _export(duration=30.0, health=True)
        rows = {
            (m["name"], m["labels"].get("kind")): m
            for m in exp["metrics"] if m["name"] == "health.events"
        }
        assert len(rows) == 4, "one health.events row per detector kind"
        for (_name, kind), m in rows.items():
            assert m["value"] == res.health.counts[kind] >= 0

    return locals()


def _sst_gossip(m, chaos):
    """``tests/test_sst_gossip.py``'s simulator cases on package ``m``."""
    (ClusterSpec, GossipConfig, MODELS, ProfileRepository, Simulation, fleet,
        fleet_scaled_rate, paper_dfgs, poisson_workload) = m(
        "ClusterSpec GossipConfig MODELS ProfileRepository Simulation fleet "
        "fleet_scaled_rate paper_dfgs poisson_workload")

    def sim_with_gossip(gossip, cluster=None, rate=2.0, duration=100.0, seed=3):
        cluster = cluster or ClusterSpec(n_workers=5)
        p = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            p.register(d)
        jobs = poisson_workload(paper_dfgs(), rate, duration, seed=seed)
        sim = Simulation(
            cluster, p, MODELS, scheduler="navigator", gossip=gossip, seed=1
        )
        return sim.run(jobs), jobs

    def test_gossip_sim_completes_all_jobs():
        res, jobs = sim_with_gossip(GossipConfig(period_s=0.2, fanout=2))
        assert len(res.records) == len(jobs)
        assert res.sst_pushes > 0

    def test_gossip_staleness_degrades_gracefully():
        """Navigator JCT should degrade, not cliff, as the gossip period grows
        two orders of magnitude."""
        fresh, _ = sim_with_gossip(GossipConfig(period_s=0.05, fanout=4))
        stale, _ = sim_with_gossip(GossipConfig(period_s=4.0, fanout=4))
        assert stale.mean_slowdown >= fresh.mean_slowdown * 0.9
        assert stale.mean_slowdown <= fresh.mean_slowdown * 4.0

    def test_gossip_sim_deterministic():
        a, _ = sim_with_gossip(GossipConfig(period_s=0.2, fanout=2))
        b, _ = sim_with_gossip(GossipConfig(period_s=0.2, fanout=2))
        assert a.mean_latency == b.mean_latency
        assert a.sst_pushes == b.sst_pushes

    def test_fleet_scaled_rate_holds_load_constant():
        uniform = fleet("uniform")
        mixed = fleet("mixed")
        base = 2.0
        assert fleet_scaled_rate(uniform, base) == pytest.approx(base)
        assert fleet_scaled_rate(mixed, base) == pytest.approx(
            base * mixed.total_speed / mixed.n_workers
        )

    def test_heterogeneous_fleet_sim_completes_and_uses_fast_workers():
        cluster = fleet("mixed")
        rate = fleet_scaled_rate(cluster, 2.0)
        res, jobs = sim_with_gossip(
            GossipConfig(period_s=0.2, fanout=2), cluster=cluster, rate=rate
        )
        assert len(res.records) == len(jobs)
        # The fastest worker (A10, w=0) should carry more executed work than
        # the slowest (edge, w=4): Navigator sees shorter queues there.
        fast = res.busy_time[0] * cluster.speed(0)
        slow = res.busy_time[4] * cluster.speed(4)
        assert fast > slow

    return locals()


def _prefetch(m, chaos):
    """``tests/test_prefetch.py``'s simulator cases on package ``m``."""
    (ClusterSpec, DFG, GossipConfig, Job, MB, MODELS, PrefetchConfig, ProfileRepository,
        Simulation, TaskSpec, bursty_trace_workload, paper_dfgs, poisson_workload,
        translation_dfg) = m(
        "ClusterSpec DFG GossipConfig Job MB MODELS PrefetchConfig "
        "ProfileRepository Simulation TaskSpec bursty_trace_workload paper_dfgs "
        "poisson_workload translation_dfg")

    def make_profiles(cluster=None):
        cluster = cluster or ClusterSpec(n_workers=5)
        p = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            p.register(d)
        return p

    def _sim(cluster, prefetch=None, scheduler="navigator", **kw):
        profiles = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            profiles.register(d)
        return Simulation(
            cluster, profiles, MODELS, scheduler=scheduler,
            prefetch=prefetch, **kw,
        )

    def test_sim_prefetch_completes_all_jobs_and_populates_stats():
        cluster = ClusterSpec(n_workers=5)
        jobs = bursty_trace_workload(paper_dfgs(), 0.8, 120.0, seed=3)
        res = _sim(cluster, prefetch=PrefetchConfig(), seed=1).run(jobs)
        assert len(res.records) == len(jobs)
        s = res.prefetch_stats
        assert s is not None and s.intents_issued > 0
        assert s.prefetches_started > 0
        assert res.prefetch_bytes > 0

    def test_sim_prefetch_deterministic_given_seed():
        cluster = ClusterSpec(n_workers=5)
        jobs = poisson_workload(paper_dfgs(), 1.0, 60.0, seed=11)
        a = _sim(cluster, prefetch=PrefetchConfig(), seed=1).run(jobs)
        b = _sim(cluster, prefetch=PrefetchConfig(), seed=1).run(jobs)
        assert a.mean_latency == b.mean_latency
        assert a.prefetch_bytes == b.prefetch_bytes

    def test_sim_prefetch_improves_demand_hit_rate():
        cluster = ClusterSpec(n_workers=5)
        jobs = bursty_trace_workload(paper_dfgs(), 0.8, 200.0, seed=7)
        off = _sim(cluster, prefetch=None, seed=1).run(jobs)
        on = _sim(cluster, prefetch=PrefetchConfig(), seed=1).run(jobs)
        assert on.cache_hit_rate >= off.cache_hit_rate
        assert len(on.records) == len(off.records) == len(jobs)

    def test_demand_preempts_speculative_prefetch():
        """One worker: job A's downstream model is being speculatively
        fetched when job B's demand fetch arrives → the prefetch is aborted
        (and the queued task later re-fetches its model)."""
        chain = DFG(
            "chain",
            tasks=[
                TaskSpec("a", 1.0, model_id=1, output_bytes=0.1 * MB),
                TaskSpec("b", 0.5, model_id=2, output_bytes=0.1 * MB),
            ],
            edges=[("a", "b")],
        )
        solo = DFG("solo", [TaskSpec("c", 0.5, model_id=3)], [])
        cluster = ClusterSpec(n_workers=1)
        profiles = ProfileRepository(cluster, MODELS)
        profiles.register(chain)
        profiles.register(solo)
        # Job A at t=0; job B lands while A's model-2 prefetch is in flight
        # (A's model-1 demand fetch takes ~1.2 s, then "a" runs ~1 s while
        # model 2 prefetches).
        jobs = [Job(0, chain, 0.0), Job(1, solo, 1.6)]
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator",
            prefetch=PrefetchConfig(herd_backoff_s=0.0),
            runtime_noise_sigma=0.0, seed=0,
        )
        res = sim.run(jobs)
        assert len(res.records) == 2
        s = res.prefetch_stats
        assert s.prefetches_started >= 1
        assert s.prefetches_preempted >= 1
        assert res.prefetch_wasted_bytes > 0  # the aborted partial transfer

    def test_prefetch_promotion_on_demand_of_inflight_model():
        """The entry task's own model is speculatively fetched the moment the
        plan lands — when the task itself arrives an instant later, the
        transfer is promoted to a demand fetch, not restarted."""
        solo = DFG("solo_p", [TaskSpec("c", 0.5, model_id=3)], [])
        cluster = ClusterSpec(n_workers=1)
        profiles = ProfileRepository(cluster, MODELS)
        profiles.register(solo)
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator",
            prefetch=PrefetchConfig(), runtime_noise_sigma=0.0, seed=0,
        )
        res = sim.run([Job(0, solo, 0.0)])
        assert len(res.records) == 1
        assert res.prefetch_stats.prefetches_promoted >= 1
        # Promotion means no duplicate transfer: exactly one model-3 fetch.
        assert res.bytes_fetched == pytest.approx(
            MODELS[3].size_bytes * cluster.compression_ratio
        )

    def test_adjustment_migrates_intent():
        cluster = ClusterSpec(n_workers=5)
        jobs = poisson_workload(paper_dfgs(), 2.0, 120.0, seed=3)
        res = _sim(cluster, prefetch=PrefetchConfig(), seed=1).run(jobs)
        assert len(res.records) == len(jobs)
        if res.adjustments > 0:
            assert res.prefetch_stats.intents_migrated > 0

    def test_capacity_blind_scheduler_bounces_on_small_gpu():
        """Hash can place a 6.5 GB-model task on an 8 GB edge GPU that can
        never host it (cached+decompressed 10.4 GB); the dispatcher must
        re-route instead of crashing."""
        import zlib

        fleet = m.fleet

        cluster = fleet("mixed")  # worker 4 is an 8 GB EDGE GPU
        dfg = translation_dfg()
        jid = next(
            j for j in range(200)
            if zlib.crc32(f"opt_ingest:{j}".encode()) % 5 == 4
        )
        profiles = ProfileRepository(cluster, MODELS)
        profiles.register(dfg)
        res = Simulation(
            cluster, profiles, MODELS, scheduler="hash", seed=1
        ).run([Job(jid, dfg, 0.0)])
        assert len(res.records) == 1  # completed despite the infeasible GPU

    def test_gossip_plus_prefetch_sim_completes():
        cluster = ClusterSpec(n_workers=5)
        jobs = poisson_workload(paper_dfgs(), 1.5, 90.0, seed=5)
        res = _sim(
            cluster,
            prefetch=PrefetchConfig(),
            gossip=GossipConfig(period_s=0.2, fanout=2),
            seed=2,
        ).run(jobs)
        assert len(res.records) == len(jobs)
        assert res.prefetch_stats.intents_issued > 0

    def test_sim_advertises_fetch_eta_while_pipe_busy():
        """The engine's cache publication carries the in-flight fetch id and
        its expected completion on the wire whenever the pipe is busy."""
        cluster = ClusterSpec(n_workers=3)
        profiles = make_profiles(cluster)
        jobs = poisson_workload(paper_dfgs(), 1.0, 20.0, seed=2)
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator",
            prefetch=PrefetchConfig(), seed=1,
        )
        seen = []
        orig = sim.sst.update_cache

        def spy(worker, bitmap, free, now=0.0, fetch_model_id=-1,
                fetch_eta_s=0.0):
            if fetch_model_id >= 0:
                seen.append((worker, fetch_model_id, fetch_eta_s, now))
            return orig(worker, bitmap, free, now, fetch_model_id, fetch_eta_s)

        sim.sst.update_cache = spy
        res = sim.run(jobs)
        assert len(res.records) == len(jobs)
        assert seen, "no fetch-ETA advertisement ever published"
        for _, mid, eta, now in seen:
            assert 0 <= mid < 64
            assert eta >= now  # expected completion lies in the future

    return locals()


def _healthplane(m, chaos):
    """``tests/test_healthplane.py``'s simulator cases on package ``m``."""
    (CALIBRATION_COMPONENTS, DFG, Job, MB, MODELS, ProfileRepository, SPINE_SATURATION,
        STRAGGLER, SimReport, Simulation, TaskSpec, calibrate, fleet, fleet_scaled_rate,
        paper_dfgs, poisson_workload, validate_schema) = m(
        "CALIBRATION_COMPONENTS DFG Job MB MODELS ProfileRepository "
        "SPINE_SATURATION STRAGGLER SimReport Simulation TaskSpec calibrate "
        "fleet fleet_scaled_rate paper_dfgs poisson_workload validate_schema")
    (run_churn_sim,) = chaos(
        "run_churn_sim")

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def load_schema(name):
        with open(os.path.join(REPO, "schemas", name)) as f:
            return json.load(f)

    def _base(fleet_name="uniform"):
        cluster = fleet(fleet_name)
        profiles = ProfileRepository(cluster, MODELS)
        dfgs = paper_dfgs()
        for d in dfgs:
            profiles.register(d)
        return cluster, profiles, dfgs

    def test_injected_straggler_flagged():
        """Heavy runtime noise (lognormal sigma 1.2) injects real stragglers;
        the nominal-noise control run flags none."""
        cluster, profiles, dfgs = _base()
        jobs = poisson_workload(
            dfgs, fleet_scaled_rate(cluster, 1.5), 30.0, seed=7
        )
        noisy = Simulation(
            cluster, profiles, MODELS, scheduler="navigator", seed=1,
            runtime_noise_sigma=1.2, health=True,
        ).run(jobs)
        assert noisy.health.counts[STRAGGLER] > 0
        for e in noisy.health.events:
            if e.kind == STRAGGLER:
                assert e.value >= e.threshold > 0.0

        control = Simulation(
            cluster, profiles, MODELS, scheduler="navigator", seed=1,
            runtime_noise_sigma=0.25, health=True,
        ).run(jobs)
        assert control.health.counts[STRAGGLER] == 0

    def test_injected_spine_saturation_flagged():
        """A 16-way fan-out burst across the rack2 spine drives >= 3
        concurrent flows onto one uplink (share <= 1/3) and must trip the
        fleet-scoped spine-saturation detector."""
        cluster = fleet("rack2")
        tasks = [TaskSpec("src", 0.05, model_id=None, output_bytes=8 * MB)]
        edges = []
        for i in range(16):
            tasks.append(TaskSpec(f"c{i}", 0.05, model_id=None,
                                  output_bytes=0.01 * MB))
            edges.append(("src", f"c{i}"))
        dfg = DFG("fan", tasks=tasks, edges=edges)
        profiles = ProfileRepository(cluster, MODELS)
        profiles.register(dfg)
        res = Simulation(
            cluster, profiles, MODELS, scheduler="hash", seed=1, health=True
        ).run([Job(job_id=0, dfg=dfg, arrival_time=0.0)])
        assert res.health.counts[SPINE_SATURATION] >= 1
        (e, *_rest) = [
            e for e in res.health.events if e.kind == SPINE_SATURATION
        ]
        assert e.worker == -1 and e.value <= e.threshold
        assert e.detail.startswith("uplink spine.")

    def test_sim_publishes_digests_to_sst():
        """End to end: after a health-enabled run, live readers' SST replicas
        carry non-trivial digests for the busy workers."""
        res, jobs, schedule, sim = run_churn_sim(
            "navigator", schedule=[], duration=30.0, health=True,
            return_sim=True,
        )
        rows = sim.sst.view(0, res.horizon)
        assert any(r.health_p99_latency_s > 0.0 for r in rows), (
            "no worker's gossiped digest ever carried a task-latency p99"
        )

    def test_health_summary_validates_and_counts():
        res, jobs, schedule = run_churn_sim("navigator", health=True, trace=True)
        s = res.health.summary()
        validate_schema(s, load_schema("health.schema.json"))
        assert s["schema_version"] == 1
        assert len(s["workers"]) == res.n_workers
        assert s["fleet_job_latency"]["count"] == len(res.records)
        total_tasks = sum(w["task_latency"]["count"] for w in s["workers"])
        assert s["fleet_task_latency"]["count"] == total_tasks
        # Detector counts mirror the metrics export and the event ledger.
        for kind, count in s["detectors"].items():
            assert count == int(res.metrics.value("health.events", kind=kind))
        assert len(s["events"]) <= res.health.config.max_events
        # Health events also land in the flight recorder's stream.
        kinds = {json.loads(line)["kind"]
                 for line in res.trace.to_jsonl().splitlines()}
        for kind, count in s["detectors"].items():
            if count:
                assert kind in kinds

    def test_health_summary_raises_when_off():
        res, jobs, schedule = run_churn_sim("navigator", duration=10.0,
                                            trace=True)
        assert res.health is None
        with pytest.raises(ValueError, match="health=True"):
            SimReport(res).health_summary()

    def _traced_report(noise=0.25, scheduler="navigator"):
        cluster, profiles, dfgs = _base()
        jobs = poisson_workload(
            dfgs, fleet_scaled_rate(cluster, 1.5), 30.0, seed=7
        )
        res = Simulation(
            cluster, profiles, MODELS, scheduler=scheduler, seed=1,
            runtime_noise_sigma=noise, trace=True,
        ).run(jobs)
        return SimReport(res)

    def test_calibration_joins_all_spans():
        report = _traced_report()
        cal = report.calibration()
        assert cal.joined > 0 and cal.unmatched == 0
        for name in CALIBRATION_COMPONENTS:
            assert cal.components[name].count == cal.joined
        assert cal.worst_component() in CALIBRATION_COMPONENTS
        table = cal.format_table()
        assert "queue" in table and "runtime" in table

    def test_calibration_runtime_exact_when_noise_off():
        """With runtime noise disabled, measured compute equals the profile
        prediction — the runtime component's residual must collapse to ~0
        while the join machinery still sees every span."""
        cal = _traced_report(noise=0.0).calibration()
        assert cal.joined > 0
        rt = cal.components["runtime"].as_dict()
        assert abs(rt["residual_abs_mean_s"]) < 1e-6, (
            f"noise-free runtime residual should vanish: {rt}"
        )

    def test_calibration_deterministic_and_exported():
        a, b = _traced_report(), _traced_report()
        ca, cb = calibrate(a), calibrate(b)
        assert json.dumps(ca.as_dict(), sort_keys=True) == json.dumps(
            cb.as_dict(), sort_keys=True
        )
        reg = a.result.metrics
        ca.to_metrics(reg)
        validate_schema(reg.export(), load_schema("metrics.schema.json"))
        assert int(reg.value("calibration.joined",
                             scheduler="navigator")) == ca.joined

    def test_calibration_requires_trace():
        res, jobs, schedule = run_churn_sim("navigator", duration=10.0)
        with pytest.raises(ValueError, match="trace"):
            SimReport(res)

    return locals()


def _telemetry(m, chaos):
    """``tests/test_telemetry.py``'s simulator cases on package ``m``."""
    (ClusterSpec, MODELS, ProfileRepository, SimReport, Simulation, bursty_trace_workload,
        paper_dfgs, telemetry_mod, validate_schema) = m(
        "ClusterSpec MODELS ProfileRepository SimReport Simulation "
        "bursty_trace_workload paper_dfgs telemetry_mod validate_schema")
    (SCRIPTED_SCHEDULE, check_trace_determinism, scripted_partition_schedule) = chaos(
        "SCRIPTED_SCHEDULE check_trace_determinism scripted_partition_schedule")

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def make_profiles(cluster):
        p = ProfileRepository(cluster, MODELS)
        for d in paper_dfgs():
            p.register(d)
        return p

    def load_schema(name):
        with open(os.path.join(REPO, "schemas", name)) as f:
            return json.load(f)

    def traced():
        """One traced 30 s navigator run shared by the read-only tests."""
        cluster = ClusterSpec(n_workers=5)
        profiles = make_profiles(cluster)
        jobs = bursty_trace_workload(
            paper_dfgs(), base_rate_per_s=0.8, duration_s=30.0, seed=3
        )
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator", seed=1, trace=True
        )
        res = sim.run(jobs)
        return res, SimReport(res)

    def test_sim_breakdown_sums_to_jct(traced):
        res, report = traced
        assert res.trace is not None and res.trace.dropped == 0
        assert len(res.records) > 5
        for r in res.records:
            bd = report.latency_breakdown(r.job_id)
            assert abs(bd.components_sum_s - bd.jct_s) < 1e-6
            assert abs(bd.jct_s - r.latency) < 1e-9
        agg = report.latency_breakdown()
        assert agg["jobs"] == len(res.records)
        assert sum(agg["shares"].values()) == pytest.approx(1.0)

    def test_provenance_eq2_recomposition(traced):
        """Every recorded candidate vector re-composes to its total (Eq. 2:
        max(queue, input) + model + runtime + liveness) and, absent an
        override note, the chosen worker is the candidate argmin."""
        res, _ = traced
        placements = res.trace.placements
        assert placements
        assert {"plan", "adjust"} <= {d.phase for d in placements}
        n_place_events = sum(
            1 for e in res.trace.events() if e[2] == "sched.place"
        )
        assert n_place_events == len(placements)
        for d in placements:
            chosen = d.candidate(d.chosen)
            assert chosen is not None, f"{d.task_id}: chosen worker not recorded"
            feasible = [c for c in d.candidates if c.total_s != float("inf")]
            assert feasible
            if not d.note:  # herd-sticky / hysteresis overrides carry a note
                best = min(c.total_s for c in feasible)
                assert chosen.total_s <= best + 1e-6
            if d.phase in ("plan", "jit", "recovery"):
                for c in feasible:
                    recomposed = (max(c.queue_s, c.input_s) + c.model_s
                                  + c.runtime_s + c.liveness_s)
                    assert abs(recomposed - c.total_s) < 1e-6, (
                        f"{d.phase}/{d.task_id} w{c.worker}: "
                        f"{recomposed} != {c.total_s}"
                    )

    def test_explain_renders_decision_table(traced):
        res, report = traced
        d = res.trace.placements[0]
        text = report.explain(d.task_id, d.job_id)
        assert f"job {d.job_id}" in text and d.task_id in text
        assert "total" in text           # cost-vector table header
        assert f"w{d.chosen}" in text

    def test_exports_validate_against_schemas(traced):
        res, _ = traced
        chrome = json.loads(json.dumps(res.trace.to_chrome_trace()))
        validate_schema(chrome, load_schema("trace.schema.json"))
        assert any(e["ph"] == "X" for e in chrome["traceEvents"])
        validate_schema(res.metrics.export(), load_schema("metrics.schema.json"))

    def test_export_jsonl_gzip_deterministic(traced, tmp_path):
        """``export_jsonl(path, compress=True)`` writes a gzip archive whose
        raw bytes are deterministic (mtime pinned to 0) and whose payload
        round-trips to the exact uncompressed JSONL stream; the plain export
        path is untouched by the option."""
        import gzip

        res, _ = traced
        plain, gz_a, gz_b = (tmp_path / n for n in ("t.jsonl", "a.gz", "b.gz"))
        res.trace.export_jsonl(str(plain))
        res.trace.export_jsonl(str(gz_a), compress=True)
        res.trace.export_jsonl(str(gz_b), compress=True)
        assert gz_a.read_bytes() == gz_b.read_bytes(), (
            "gzip archive is not byte-deterministic across reruns"
        )
        with gzip.open(gz_a, "rb") as f:
            inflated = f.read().decode("utf-8")
        assert inflated == res.trace.to_jsonl() == plain.read_text()
        assert len(gz_a.read_bytes()) < len(plain.read_bytes())

    def test_trace_determinism_gossip_churn():
        check_trace_determinism(
            schedule=[e for e in SCRIPTED_SCHEDULE if e.time < 20.0],
            duration=20.0, rate=1.0,
        )

    def test_trace_determinism_shared_table_churn():
        check_trace_determinism(
            schedule=[e for e in SCRIPTED_SCHEDULE if e.time < 20.0],
            duration=20.0, rate=1.0, gossip=None,
        )

    def test_trace_determinism_partition():
        check_trace_determinism(
            schedule=scripted_partition_schedule(5), duration=20.0, rate=1.0,
        )

    def test_tracing_off_zero_telemetry_allocations():
        """The tracing-off event loop must perform zero allocations
        attributable to core/telemetry.py (the zero-overhead-when-off
        contract, also enforced by tools/trace_smoke.py in CI)."""
        cluster = ClusterSpec(n_workers=5)
        profiles = make_profiles(cluster)
        jobs = bursty_trace_workload(
            paper_dfgs(), base_rate_per_s=0.8, duration_s=10.0, seed=3
        )
        sim = Simulation(
            cluster, profiles, MODELS, scheduler="navigator", seed=1, trace=False
        )
        sim._schedule_initial(jobs)
        tracemalloc.start(25)
        try:
            before = tracemalloc.take_snapshot()
            sim._event_loop()
            after = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        flt = [tracemalloc.Filter(True, telemetry_mod.__file__)]
        stats = after.filter_traces(flt).compare_to(
            before.filter_traces(flt), "lineno"
        )
        leaked = [s for s in stats if s.size_diff > 0 or s.count_diff > 0]
        assert not leaked, "\n".join(str(s) for s in leaked)
        res = sim._assemble_result()
        assert res.trace is None and res.records

    return locals()

def _engine_parity(m, chaos):
    """``tests/test_engine_parity.py``'s simulator cases on package ``m``:
    the serving engine's trace (each package's own engine on the CPU, over
    two reduced models) against the simulator's."""
    (ClusterSpec, DFG, GB, Job, MB, MODELS, ProfileRepository, Simulation, TaskSpec,
        DETECTOR_KINDS) = m(
        "ClusterSpec DFG GB Job MB MODELS ProfileRepository Simulation TaskSpec "
        "DETECTOR_KINDS")

    def _pipeline_dfg():
        return DFG(
            "p",
            tasks=[
                TaskSpec("a", 0.05, model_id=1, output_bytes=0.01 * MB,
                         input_bytes=0.01 * MB),
                TaskSpec("b", 0.1, model_id=0, output_bytes=0.01 * MB),
            ],
            edges=[("a", "b")],
        )

    def _taxonomy(jsonl):
        """kind -> (key set, worker ids seen) over a JSONL stream."""
        tax, workers = {}, {}
        for line in jsonl.splitlines():
            d = json.loads(line)
            tax.setdefault(d["kind"], set()).update(d.keys())
            workers.setdefault(d["kind"], set()).add(d["worker"])
        return tax, workers

    def _hosted():
        archs = importlib.import_module(f"{m.pkg}.configs").ARCHS
        models = importlib.import_module(f"{m.pkg}.models")
        HostedModel = importlib.import_module(f"{m.pkg}.serving").HostedModel
        out = []
        for mid, arch in enumerate(["mistral-nemo-12b", "mamba2-780m"]):
            cfg = archs[arch].reduced(dtype="float32")
            if m.pkg == "repro":
                import jax

                out.append(HostedModel(mid, cfg, models.init_params(cfg, jax.random.key(mid))))
            else:
                import torch

                params = models.init_params(cfg, torch.Generator().manual_seed(mid), "cpu")
                out.append(HostedModel(mid, cfg, params, "cpu"))
        return out

    def serving_trace():
        ServingCluster = importlib.import_module(f"{m.pkg}.serving").ServingCluster
        kw = {} if m.pkg == "repro" else dict(device="cpu")
        sc = ServingCluster(ClusterSpec(n_workers=2, gpu_capacity_bytes=1 * GB), _hosted(),
                            scheduler="navigator", decode_tokens=4, trace=True, health=True,
                            **kw)
        dfg = _pipeline_dfg()
        sc.register_pipeline(dfg)
        prompt = np.array([[3, 4, 5]], np.int32)
        for origin in (0, 1, 0):
            sc.submit(dfg, {"a": prompt}, origin=origin)
        return sc

    def sim_trace():
        cluster = ClusterSpec(n_workers=2)
        dfg = _pipeline_dfg()
        profiles = ProfileRepository(cluster, MODELS)
        profiles.register(dfg)
        jobs = [Job(job_id=i, dfg=dfg, arrival_time=0.4 * i) for i in range(3)]
        return Simulation(
            cluster, profiles, MODELS, scheduler="navigator", seed=1,
            trace=True, health=True,
        ).run(jobs)

    HEALTH_EVENT_KEYS = {"t", "kind", "seq", "worker", "value", "threshold",
                         "detail"}

    def test_serving_taxonomy_subset_of_sim(serving_trace, sim_trace):
        srv_tax, _ = _taxonomy(serving_trace.recorder.to_jsonl())
        sim_tax, _ = _taxonomy(sim_trace.trace.to_jsonl())
        assert srv_tax, "serving engine emitted no events"
        for kind, keys in sorted(srv_tax.items()):
            if kind in DETECTOR_KINDS:
                assert keys == HEALTH_EVENT_KEYS, (
                    f"{kind!r} keys {sorted(keys)} != canonical health shape"
                )
                continue
            assert kind in sim_tax, (
                f"serving emits {kind!r}, unknown to the simulator — "
                f"analysis tooling would not recognize it"
            )
            assert keys == sim_tax[kind], (
                f"{kind!r} key sets diverge: serving {sorted(keys)} vs "
                f"sim {sorted(sim_tax[kind])}"
            )
        for kind in set(sim_tax) & set(DETECTOR_KINDS):
            assert sim_tax[kind] == HEALTH_EVENT_KEYS

    def test_core_lifecycle_kinds_present_in_both(serving_trace, sim_trace):
        core = {"job.arrive", "job.done", "sched.place", "task.start",
                "task.input", "task.done", "fetch.start", "fetch.done"}
        srv_tax, _ = _taxonomy(serving_trace.recorder.to_jsonl())
        sim_tax, _ = _taxonomy(sim_trace.trace.to_jsonl())
        assert core <= set(srv_tax), f"serving missing {core - set(srv_tax)}"
        assert core <= set(sim_tax), f"sim missing {core - set(sim_tax)}"

    def test_job_lifecycle_on_global_ring(serving_trace, sim_trace):
        """job.arrive / job.done ride the cluster-global ring (worker -1) in
        both engines."""
        _, srv_workers = _taxonomy(serving_trace.recorder.to_jsonl())
        _, sim_workers = _taxonomy(sim_trace.trace.to_jsonl())
        for kind in ("job.arrive", "job.done"):
            assert srv_workers[kind] == {-1}, (
                f"serving {kind} on rings {srv_workers[kind]}, expected global"
            )
            assert sim_workers[kind] == {-1}, (
                f"sim {kind} on rings {sim_workers[kind]}, expected global"
            )

    return locals()


# ---------------------------------------------------------------------------
# running the reference's cases on each package
# ---------------------------------------------------------------------------
SECTIONS = {"sim": _sim, "churn": _churn, "engine_indexed": _engine_indexed,
            "partition": _partition, "metrics_churn": _metrics_churn,
            "engine_parity": _engine_parity, "sst_gossip": _sst_gossip, "prefetch": _prefetch,
            "healthplane": _healthplane, "telemetry": _telemetry}
#: The arguments of the cases the reference parametrises, as it does.
PARAMS = {
    ("sim", "test_all_jobs_complete"): [
        dict(scheduler=s) for s in ("navigator", "jit", "heft", "hash")],
    ("churn", "test_invariants_scripted_schedule"): [
        dict(policy=p, fleet_name=f) for f in ("uniform", "mixed")
        for p in ("navigator", "hash", "heft", "jit")],
    ("churn", "test_invariants_generated_schedule_heterogeneous"): [
        dict(policy=p) for p in ("navigator", "hash", "heft")],
    ("churn", "test_churn_trace_is_deterministic"): [dict(gossip="gossip"), dict(gossip=None)],
    ("engine_indexed", "test_full_sim_engine_parity"): [
        dict(scheduler=s, plane=p) for p in ("sst", "gossip") for s in ("navigator", "jit")],
    ("partition", "test_scripted_partition_invariants"): [
        dict(policy=p, fleet_name=f) for p in ("navigator", "hash") for f in ("uniform", "rack2")],
}
#: Fixtures the reference shares across a module: built once per package.
MODULE_FIXTURES = {("telemetry", "traced"), ("engine_parity", "serving_trace"),
                   ("engine_parity", "sim_trace")}


@functools.lru_cache(maxsize=None)
def sections(pkg):
    """Every section's names (helpers, fixtures, cases) on ``pkg``."""
    m = Package(pkg)
    harness = _chaos(m, None)

    def chaos(names):
        return tuple(harness[n] for n in names.split())

    return {name: make(m, chaos) for name, make in SECTIONS.items()}


def reference_cases():
    for section, names in sections("repro").items():
        for name in names:
            if name.startswith("test_"):
                for params in PARAMS.get((section, name), [{}]):
                    label = ",".join(f"{k}={v}" for k, v in params.items())
                    yield pytest.param(section, name, params,
                                       id=f"{section}::{name}" + (f"[{label}]" if label else ""))


@functools.lru_cache(maxsize=None)
def module_fixture(pkg, section, name):
    return sections(pkg)[section][name]()


@both
@pytest.mark.parametrize("section,name,params", list(reference_cases()))
def test_reference_case(pkg, section, name, params, tmp_path):
    """One of the reference's simulator cases, on ``pkg``."""
    names = sections(pkg)[section]
    case = names[name]
    kwargs = dict(params)
    if kwargs.get("gossip") == "gossip":
        kwargs["gossip"] = Package(pkg).GossipConfig(period_s=0.2, fanout=2)
    for arg in inspect.signature(case).parameters:
        if arg in kwargs:
            continue
        if arg == "tmp_path":
            kwargs[arg] = tmp_path
        elif (section, arg) in MODULE_FIXTURES:
            kwargs[arg] = module_fixture(pkg, section, arg)
        else:
            kwargs[arg] = names[arg]()
    case(**kwargs)
