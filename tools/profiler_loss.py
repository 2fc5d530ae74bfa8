#!/usr/bin/env python3
"""Which device records of a graphed task does the PyTorch profiler lose,
and does work launched ahead of the task take the loss?

    python3 tools/profiler_loss.py

Serves mamba2-780m at full width through the engine's CUDA graph (one
task: 8 prompt tokens and 6 decoded, 14 replays), waits two minutes, then
every ~15 s profiles the task three ways: plain, after 3,000 tiny kernels,
and after one extra replay of the graph. For each it prints the replays
listed and the records of each (every replay of one graph runs the same
kernels), the replays short of the most and by how many, where the first
replay first differs from the last, how many of the leading tiny kernels
were left, and any records without a host call. ``chip_smoke.py``'s
``profile_task`` opens each profile with such a ballast on what this
shows. Needs PyTorch with CUDA, nvcc and a card.
"""
import collections, sys, time
sys.path[:0] = ["src", "."]
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import _build
_build.build("decode_attention")
from repro_torch.serving import ExecutionEngine, HostedModel
from repro_torch.configs import ARCHS
from repro_torch.models import init_params
dev = torch.device("cuda")
CUDA = torch.autograd.DeviceType.CUDA
cfg = ARCHS["mamba2-780m"]
params = init_params(cfg, torch.Generator(device=dev).manual_seed(13), dev)
engine = ExecutionEngine({0: HostedModel(0, cfg, params, dev)}, decode_tokens=6, device=dev)
prompt = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)[:, :8]
engine.run_task(0, prompt)
g = next(iter(engine.graphs.values()))
x = torch.ones(1024, device=dev)
sessions = 1

def empty_sessions(n):
    global sessions
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            x.add_(1)
            torch.cuda.synchronize()
        sessions += 1

def one(variant):
    global sessions
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if variant == "kernels first":
            for _ in range(3000): x.add_(1)
        if variant == "replay first":
            g.replay()
        torch.cuda.synchronize()
        t_task = time.perf_counter_ns()
        engine.run_task(0, prompt)
        torch.cuda.synchronize()
    sessions += 1
    ev = prof.profiler.kineto_results.events()
    host = collections.defaultdict(list)
    for e in ev:
        if e.device_type() != CUDA:
            host[e.correlation_id()].append(e.name())
    launch = sorted(c for c, l in host.items() if any(n.startswith("cudaGraphLaunch") for n in l))
    by = collections.defaultdict(list)
    for e in ev:
        if e.device_type() == CUDA:
            by[e.correlation_id()].append(e)
    counts = [len(by[c]) for c in launch]
    adds = sum(1 for e in ev if e.device_type() == CUDA and "vectorized_elementwise" in e.name()
               and e.correlation_id() not in launch)
    orphans = collections.Counter(e.name()[:40] for e in ev if e.device_type() == CUDA
                                  and e.correlation_id() not in host)
    zero = sum(1 for e in ev if e.device_type() == CUDA and e.correlation_id() == 0)
    full = max(counts)
    first = sorted(by[launch[0]], key=lambda e: e.start_ns())
    ref = sorted(by[launch[-1]], key=lambda e: e.start_ns())
    j = 0
    while j < len(first) and first[j].name() == ref[j].name(): j += 1
    print(f"session {sessions} {variant:13s}: replays {len(launch)}, records {counts[:3]}... max {full}; "
          f"short {[(i, full - n) for i, n in enumerate(counts) if n != full]}; first diff at "
          f"record {j}; elementwise kernels outside replays {adds}; orphans {dict(orphans)}; "
          f"correlation 0: {zero}", flush=True)

T0 = time.time()
time.sleep(120)
while time.time() - T0 < 330:
    for v in ("plain", "kernels first", "replay first"):
        print(f"t={time.time() - T0:.0f}", end=" ")
        one(v)
    time.sleep(15)
