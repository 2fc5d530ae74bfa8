"""Serving cluster engine: Navigator-scheduled ML pipelines over real
PyTorch models, mirroring ``repro.serving.engine``.

Each *worker* hosts a GPU model cache (``GpuMemoryManager``) and an
execution queue; the Navigator scheduler places pipeline tasks from the
shared state table; the execution engine runs each task as a
teacher-forced prefill through ``decode_step`` followed by greedy decode.

All workers share one physical device, so transfer and fetch *costs*
advance a virtual clock from the profiled cost model (exactly the
simulator's), while the model compute itself is real and its wall time is
measured.  The gossip plane, prefetch plane, flight recorder and health
plane of the reference come with a later slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (
    ClusterSpec,
    GpuMemoryManager,
    Job,
    NavigatorConfig,
    ProfileRepository,
    SharedStateTable,
)
from repro_torch.core.scheduler import Scheduler, make_scheduler
from repro_torch.core.types import DFG, MLModel
from repro_torch.device import Device, resolve_device
from repro_torch.models import ModelConfig, ParamTree, decode_step, init_cache


@dataclasses.dataclass
class HostedModel:
    """A zoo model registered with the serving cluster; its params are
    moved to ``device`` if they lie elsewhere."""

    model_id: int
    cfg: ModelConfig
    params: ParamTree
    device: Device = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device)

    @property
    def size_bytes(self) -> float:
        """Bytes of all parameter tensors: the reference's per-leaf sum, so
        fetch costs and placements match it."""
        return float(sum(p.nbytes for p in self.params.parameters()))


class ExecutionEngine:
    """Per-framework plug-in layer (§3): here, one plug-in — PyTorch."""

    def __init__(
        self,
        models: Dict[int, HostedModel],
        decode_tokens: int = 8,
        *,
        device: Device = "cuda",
        impl: str = "auto",
    ) -> None:
        self.device = resolve_device(device)
        for mid, h in models.items():
            if h.device != self.device:
                raise ValueError(
                    f"model {mid} is hosted on {h.device}, the engine runs on {self.device}"
                )
        if self.device.type == "cuda":
            # fp32 matmuls in full precision (no TF32), so fp32 tokens match
            # the reference's.  This is PyTorch's default; it is set here so
            # that nothing else in the process can change it unseen.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.models = models
        self.decode_tokens = decode_tokens
        self.impl = impl

    @torch.inference_mode()
    def run_task(self, mid: int, prompt: np.ndarray) -> Tuple[np.ndarray, float]:
        """Prefill ``prompt`` then greedily decode a few tokens.  Returns
        (generated token ids (B, decode_tokens) int32, wall seconds)."""
        hosted = self.models[mid]
        cfg = hosted.cfg
        t0 = time.perf_counter()
        b, s = prompt.shape
        cache = init_cache(
            cfg, b, capacity=s + self.decode_tokens + 1, device=self.device
        )
        toks = torch.as_tensor(prompt, device=self.device)
        out = []
        # teacher-forced prefill through the decode path (seeds the cache)
        for i in range(s):
            logits, cache = decode_step(
                hosted.params, cache, toks[:, i], cfg, impl=self.impl
            )
        nxt = torch.argmax(logits, dim=-1)
        for _ in range(self.decode_tokens):
            out.append(nxt)
            logits, cache = decode_step(hosted.params, cache, nxt, cfg, impl=self.impl)
            nxt = torch.argmax(logits, dim=-1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tokens = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return tokens, time.perf_counter() - t0


@dataclasses.dataclass
class RequestResult:
    job_id: int
    dfg_name: str
    latency_s: float
    virtual_latency_s: float
    outputs: Dict[str, np.ndarray]
    assignment: Dict[str, int]


class ServingCluster:
    """N Navigator workers serving pipeline requests over hosted models."""

    def __init__(
        self,
        cluster: ClusterSpec,
        hosted: Sequence[HostedModel],
        scheduler: str = "navigator",
        navigator_config: Optional[NavigatorConfig] = None,
        decode_tokens: int = 8,
        *,
        device: Device = "cuda",
        impl: str = "auto",
    ) -> None:
        dev = resolve_device(device)
        self.cluster = cluster
        self.hosted = {h.model_id: h for h in hosted}
        self.catalog = {
            mid: MLModel(mid, h.cfg.name, h.size_bytes)
            for mid, h in self.hosted.items()
        }
        self.profiles = ProfileRepository(cluster, self.catalog)
        self.scheduler: Scheduler = make_scheduler(
            scheduler, self.profiles, navigator_config
        )
        self.sst = SharedStateTable(cluster.n_workers)
        self.memories = [
            GpuMemoryManager(
                cluster.gpu_capacity(w),
                self.catalog,
                cluster.link,
                compression_ratio=cluster.compression_ratio,
            )
            for w in cluster.workers()
        ]
        self.engine = ExecutionEngine(
            self.hosted, decode_tokens, device=dev, impl=impl
        )
        self._vclock = [0.0] * cluster.n_workers  # per-worker virtual time
        self._jobid = 0
        for w in cluster.workers():
            self.sst.update_cache(w, 0, cluster.gpu_capacity(w), 0.0)
            self.sst.push(w, 0.0)
        self.results: List[RequestResult] = []

    # -- pipeline registration --------------------------------------------------
    def register_pipeline(self, dfg: DFG) -> None:
        self.profiles.register(dfg)

    # -- request handling ----------------------------------------------------------
    def submit(
        self, dfg: DFG, inputs: Dict[str, np.ndarray], origin: int = 0
    ) -> RequestResult:
        """Schedule + execute one pipeline request synchronously.

        ``inputs`` maps entry-task ids → prompt token arrays (B, S)."""
        now = max(self._vclock)
        job = Job(self._jobid, dfg, arrival_time=now)
        self._jobid += 1
        adfg = self.scheduler.plan(job, now, origin, self.sst.view(origin))
        if adfg is None:
            raise NotImplementedError("serving engine drives planned schedulers")

        wall0 = time.perf_counter()
        outputs: Dict[str, np.ndarray] = {}
        finish: Dict[str, float] = {}
        for tid in dfg.topo_order:
            task = dfg.tasks[tid]
            w = adfg[tid]
            mem = self.memories[w]
            start = max(
                self._vclock[w],
                max((finish[p] for p in dfg.preds[tid]), default=now),
            )
            # transfer delay for remote inputs
            for p in dfg.preds[tid]:
                if adfg[p] != w:
                    start += self.cluster.network.transfer_time(
                        dfg.tasks[p].output_bytes
                    )
            if task.model_id is not None:
                res = mem.ensure(task.model_id, [task.model_id])
                if res is not None:
                    start += res[0]  # demand fetch seconds (0 on a hit)
                self.sst.update_cache(w, mem.bitmap, mem.free_bytes, start)
                prompt = self._task_input(tid, dfg, inputs, outputs)
                out, wall = self.engine.run_task(task.model_id, prompt)
                outputs[tid] = out
                runtime = wall
            else:
                # host-side aggregation vertex
                preds = dfg.preds[tid]
                outputs[tid] = np.concatenate(
                    [outputs[p] for p in preds], axis=-1
                ) if preds else np.zeros((1, 0), np.int32)
                runtime = 1e-4
            finish[tid] = start + runtime
            self._vclock[w] = finish[tid]
            self.sst.update_load(w, self._vclock[w], finish[tid])
            self.sst.push(w, finish[tid])
        result = RequestResult(
            job_id=job.job_id,
            dfg_name=dfg.name,
            latency_s=time.perf_counter() - wall0,
            virtual_latency_s=max(finish.values()) - now,
            outputs=outputs,
            assignment=dict(adfg.assignment),
        )
        self.results.append(result)
        return result

    def _task_input(self, tid, dfg, inputs, outputs) -> np.ndarray:
        if not dfg.preds[tid]:
            return inputs[tid]
        parts = [outputs[p] for p in dfg.preds[tid]]
        return np.concatenate(parts, axis=1)

    # -- metrics ---------------------------------------------------------------------
    def cache_hit_rate(self) -> float:
        hits = sum(m.stats.hits for m in self.memories)
        total = hits + sum(m.stats.misses for m in self.memories)
        return hits / total if total else 1.0

    def workers_used(self) -> List[int]:
        return [
            w
            for w in self.cluster.workers()
            if self.memories[w].stats.hits + self.memories[w].stats.misses > 0
        ]
