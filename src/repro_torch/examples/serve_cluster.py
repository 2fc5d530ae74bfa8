"""End-to-end serving driver: batched pipeline requests through real
PyTorch models placed by the Navigator scheduler, mirroring the JAX
package's ``examples/serve_cluster.py``.

Three reduced-config zoo architectures (a dense GQA model, an MQA code
model, and an attention-free Mamba2) are hosted on a 3-worker cluster and
chained into a draft → verify → refine pipeline; a second
perceive → describe pipeline shares the verify model (cross-pipeline model
reuse, §3.3).  The placements and the model-cache hit rate are reported,
and Navigator is compared with Hash placement on total virtual latency.

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import ClusterSpec, GB
from repro_torch.core.types import DFG, MB, TaskSpec
from repro_torch.device import Device, resolve_device
from repro_torch.models import init_params
from repro_torch.serving import HostedModel, ServingCluster

DRAFT, VERIFY, REFINE = 0, 1, 2
#: (model id, architecture) of the hosted trio.
HOSTED_ARCHS = [
    (DRAFT, "mamba2-780m"),
    (VERIFY, "mistral-nemo-12b"),
    (REFINE, "granite-20b"),
]

Request = Tuple[int, np.ndarray]


def build_pipelines() -> Tuple[DFG, DFG]:
    speculative = DFG(
        "speculative_serving",
        tasks=[
            TaskSpec("draft", 0.08, model_id=DRAFT, output_bytes=0.01 * MB,
                     input_bytes=0.01 * MB),
            TaskSpec("verify", 0.20, model_id=VERIFY, output_bytes=0.01 * MB),
            TaskSpec("refine", 0.15, model_id=REFINE, output_bytes=0.01 * MB),
        ],
        edges=[("draft", "verify"), ("verify", "refine")],
    )
    summarize = DFG(
        "describe",
        tasks=[
            TaskSpec("perceive", 0.1, model_id=REFINE, output_bytes=0.01 * MB,
                     input_bytes=0.02 * MB),
            TaskSpec("describe", 0.2, model_id=VERIFY, output_bytes=0.01 * MB),
        ],
        edges=[("perceive", "describe")],
    )
    return speculative, summarize


def make_requests(n: int = 10, prompt_len: int = 12) -> List[Request]:
    """(pipeline kind, prompt (2, prompt_len) int32) pairs from seed 0; the
    defaults give the reference example's ten requests."""
    rng = np.random.default_rng(0)
    return [
        (int(rng.integers(0, 2)),
         rng.integers(1, 64, size=(2, prompt_len)).astype(np.int32))
        for _ in range(n)
    ]


def reduced_hosted(device: Device) -> List[HostedModel]:
    """The trio at reduced size in fp32, with weights from a generator
    seeded by each model id."""
    device = resolve_device(device)
    out = []
    for mid, arch in HOSTED_ARCHS:
        cfg = ARCHS[arch].reduced(dtype="float32")
        gen = torch.Generator(device=device).manual_seed(mid)
        out.append(HostedModel(mid, cfg, init_params(cfg, gen, device), device))
    return out


def run(
    scheduler: str,
    requests: Sequence[Request],
    hosted_factory: Callable[[], List[HostedModel]],
    *,
    device: Device = "cuda",
    impl: str = "auto",
):
    """Serve ``requests``; returns (cluster, total virtual latency, makespan)."""
    cluster = ClusterSpec(n_workers=3, gpu_capacity_bytes=1 * GB)
    sc = ServingCluster(cluster, hosted_factory(), scheduler=scheduler,
                        decode_tokens=6, device=device, impl=impl)
    spec, summ = build_pipelines()
    sc.register_pipeline(spec)
    sc.register_pipeline(summ)
    for i, (kind, prompt) in enumerate(requests):
        dfg, entry = (spec, "draft") if kind == 0 else (summ, "perceive")
        sc.submit(dfg, {entry: prompt}, origin=i % 3)
    makespan = max(r.virtual_latency_s for r in sc.results)
    total_virtual = sum(r.virtual_latency_s for r in sc.results)
    return sc, total_virtual, makespan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    requests = make_requests()
    for sched in ["navigator", "hash"]:
        sc, total, makespan = run(
            sched, requests, lambda: reduced_hosted(args.device), device=args.device
        )
        print(f"\n=== scheduler: {sched} ===")
        for r in sc.results[:3]:
            print(f"  {r.dfg_name:22s} virt={r.virtual_latency_s:6.3f}s "
                  f"assign={r.assignment}")
        print(f"  … {len(sc.results)} requests")
        print(f"  total virtual latency : {total:7.3f}s")
        print(f"  cache hit rate        : {sc.cache_hit_rate()*100:5.1f}%")
        print(f"  workers used          : {sc.workers_used()}")


if __name__ == "__main__":
    main()
