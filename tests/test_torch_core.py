"""The port's copy of the Navigator core gives the reference's decisions:
the four schedulers over seeded job streams of the paper's DFGs, driven
through the shared state table and the GPU memory managers."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as rcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.workflows import MODELS, paper_dfgs  # noqa: E402


def port_dfg(d):
    tasks = [tcore.TaskSpec(**dataclasses.asdict(t)) for t in d.tasks.values()]
    return tcore.DFG(d.name, tasks, d.edges)


def port_models(models):
    return {mid: tcore.MLModel(m.model_id, m.name, m.size_bytes) for mid, m in models.items()}


def drive(core, dfgs, models, scheduler, *, seed, n_jobs=60, n_workers=4,
          capacity_gb=12.0):
    """A synchronous serving loop on the virtual clock (the serving engine's,
    with profiled runtimes): plan at arrival (or per ready task for JIT),
    Alg. 2 adjustment where the scheduler asks for it, demand fetches
    through each worker's memory manager, SST publication after each task.
    Returns every job's assignment and finish times, and the cache stats."""
    cluster = core.ClusterSpec(n_workers=n_workers,
                               gpu_capacity_bytes=capacity_gb * core.GB)
    profiles = core.ProfileRepository(cluster, models)
    for d in dfgs:
        profiles.register(d)
    sched = core.make_scheduler(scheduler, profiles)
    sst = core.SharedStateTable(n_workers)
    mems = [core.GpuMemoryManager(cluster.gpu_capacity(w), models, cluster.link,
                                  compression_ratio=cluster.compression_ratio)
            for w in cluster.workers()]
    for w in cluster.workers():
        sst.update_cache(w, 0, cluster.gpu_capacity(w), 0.0)
        sst.push(w, 0.0)
    clock = [0.0] * n_workers
    rng = np.random.default_rng(seed)
    now, log = 0.0, []
    for j in range(n_jobs):
        now += float(rng.exponential(0.4))
        dfg = dfgs[int(rng.integers(len(dfgs)))]
        origin = int(rng.integers(n_workers))
        job = core.Job(j, dfg, arrival_time=now)
        adfg = sched.plan(job, now, origin, sst.view(origin))
        if adfg is None:
            adfg = core.ADFG(job)
        finish = {}
        for tid in dfg.topo_order:
            task, preds = dfg.tasks[tid], dfg.preds[tid]
            ready = max((finish[p] for p in preds), default=now)
            if tid not in adfg:  # JIT: place at readiness
                adfg[tid] = sched.select_worker_at_ready(
                    job, tid, ready, sst.view(origin),
                    {p: adfg[p] for p in preds},
                    {p: dfg.tasks[p].output_bytes for p in preds},
                )
            elif sched.needs_adjustment and len(preds) == 1:
                src = adfg[preds[0]]
                adfg[tid] = sched.adjust(job, adfg, tid, ready, sst.view(src),
                                         src, dfg.tasks[preds[0]].output_bytes)
            w = adfg[tid]
            start = max(clock[w], ready)
            for p in preds:
                if adfg[p] != w:
                    start += cluster.network.transfer_time(dfg.tasks[p].output_bytes)
            if task.model_id is not None:
                res = mems[w].ensure(task.model_id, [task.model_id])
                if res is not None:
                    start += res[0]
                sst.update_cache(w, mems[w].bitmap, mems[w].free_bytes, start)
            finish[tid] = start + profiles.runtime(task, w)
            clock[w] = finish[tid]
            sst.update_load(w, clock[w], finish[tid])
            sst.push(w, finish[tid])
        log.append((dict(adfg.assignment), finish))
    stats = [(m.stats.hits, m.stats.misses, m.stats.evictions) for m in mems]
    return log, stats


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scheduler", ["navigator", "hash", "heft", "jit"])
def test_scheduler_decisions_match_reference(scheduler, seed):
    ref_dfgs = paper_dfgs()
    want = drive(rcore, ref_dfgs, MODELS, scheduler, seed=seed)
    got = drive(tcore, [port_dfg(d) for d in ref_dfgs], port_models(MODELS),
                scheduler, seed=seed)
    assert got == want
    # the stream exercises the cache: hits, misses and evictions all occur
    hits, misses, evictions = map(sum, zip(*want[1]))
    assert hits and misses
    if scheduler != "hash":
        assert len({w for a, _ in want[0] for w in a.values()}) > 1


def test_hash_placement_uses_crc32():
    """Hash placement is a pure function of (job, task): no process salt."""
    profiles = tcore.ProfileRepository(tcore.ClusterSpec(n_workers=5), port_models(MODELS))
    dfg = port_dfg(paper_dfgs()[0])
    profiles.register(dfg)
    a, b = (tcore.make_scheduler("hash", profiles).plan(
        tcore.Job(3, dfg, 0.0), 0.0, 0, []) for _ in range(2))
    assert a.assignment == b.assignment


def test_unknown_scheduler_rejected():
    profiles = tcore.ProfileRepository(tcore.ClusterSpec(n_workers=2), {})
    with pytest.raises(ValueError):
        tcore.make_scheduler("fifo", profiles)


def test_no_tpu_cluster_spec_in_the_port():
    assert hasattr(rcore, "TPU_V5E_CLUSTER")
    assert not hasattr(tcore, "TPU_V5E_CLUSTER")
    import repro_torch.core.netmodel as net
    assert not hasattr(net, "TPU_V5E_CLUSTER")
