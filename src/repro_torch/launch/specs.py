"""Fake-tensor stand-ins for every model input, mirroring
``repro.launch.specs``: shapes, dtypes and devices, no memory (the
dry-run's contract).

``build_case(cfg, shape)`` returns everything the dry-run needs:
  kind       : "train" | "prefill" | "decode"
  cfg        : possibly adjusted ModelConfig (sliding window for long_500k)
  params     : abstract param tree (:func:`repro_torch.models.abstract_params`)
  extras     : kind-specific abstract inputs (opt state / cache / tokens)
  accum_steps: microbatching for the train shape (memory lever)

Where the reference hands ``jax.ShapeDtypeStruct``s to XLA's lowering,
these are ``FakeTensor``s that the port's own steps run on, eagerly, under
``FakeTensorMode``.  Every tensor of a case belongs to one fake mode: the
active one (:func:`abstract_world` opens one), else one opened for the
case.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import LONG_CONTEXT_WINDOW
from repro_torch.device import Device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import abstract_params, init_cache
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.model import fake_mode
from repro_torch.training import optimizer as opt


def _fake(shape, dtype: torch.dtype, device: Device) -> torch.Tensor:
    with fake_mode():
        return torch.empty(shape, dtype=dtype, device=device)


def _tokens(batch: int, seq: int, device: Device) -> torch.Tensor:
    return _fake((batch, seq), torch.int32, device)


def batch_specs(cfg: ModelConfig, batch: int, seq: int,
                device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """Abstract train/prefill inputs, including the modality-stub tensors
    (patch/frame embeddings) for vlm/audio."""
    dt = getattr(torch, cfg.dtype)
    out: Dict[str, torch.Tensor] = {"tokens": _tokens(batch, seq, device)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = _fake((batch, cfg.n_vision_tokens, cfg.d_model), dt, device)
    if cfg.arch_type == "audio":
        out["audio_frames"] = _fake((batch, cfg.n_audio_frames, cfg.d_model), dt, device)
    return out


def abstract_cache(cfg: ModelConfig, batch: int, capacity: int,
                   device: Device = "cpu") -> Dict[str, torch.Tensor]:
    with fake_mode():
        return init_cache(cfg, batch, capacity, device=device)


def abstract_opt_state(params, moment_dtype: torch.dtype = torch.bfloat16) -> opt.AdamWState:
    with fake_mode():
        return opt.init(params, moment_dtype=moment_dtype)


# Microbatch counts for train_4k: chosen so the per-microbatch activation
# working set stays ≈ pod-friendly (batch 256 → micro of 256/accum).
TRAIN_ACCUM = {
    "llama3-405b": 16,
    "mistral-large-123b": 8,
    "deepseek-v2-236b": 8,
    "qwen2-vl-72b": 8,
    "granite-20b": 4,
    "qwen3-moe-30b-a3b": 4,
    "mistral-nemo-12b": 4,
    "zamba2-7b": 2,
    "mamba2-780m": 1,
    "whisper-medium": 1,
}


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str:
    """Non-empty string → this (arch × shape) pair is skipped by design."""
    if shape.name == "long_500k" and cfg.arch_type == "audio":
        return (
            "whisper decoder is architecturally bounded to ~448-token "
            "contexts against a 1500-frame encoder; a 524k decode is "
            "meaningless (DESIGN.md §4)"
        )
    return ""


def decode_capacity(cfg: ModelConfig, shape: InputShape) -> tuple:
    """(serving config, cache capacity) of a decode shape: ONE new token
    against a cache of ``shape.seq_len``; at ``long_500k`` SSM/hybrid keep
    their O(1) state and the attention archs decode against a sliding
    window ring of ``LONG_CONTEXT_WINDOW`` slots."""
    if shape.name != "long_500k":
        return cfg, shape.seq_len
    if cfg.arch_type in ("ssm",):
        return cfg, 1  # state caches ignore capacity
    if cfg.arch_type == "hybrid":
        return cfg, cfg.sliding_window or LONG_CONTEXT_WINDOW
    return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW), LONG_CONTEXT_WINDOW


def build_case(cfg: ModelConfig, shape: InputShape, device: Device = "cpu") -> Dict[str, Any]:
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(f"skipped by design: {reason}")

    with fake_mode():
        if shape.kind == "train":
            params = abstract_params(cfg, device)
            return {
                "kind": "train",
                "cfg": cfg,
                "params": params,
                "opt_state": abstract_opt_state(params),
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len, device),
                "accum_steps": TRAIN_ACCUM.get(cfg.name, 1),
            }

        if shape.kind == "prefill":
            return {
                "kind": "prefill",
                "cfg": cfg,
                "params": abstract_params(cfg, device),
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len, device),
            }

        serve_cfg, capacity = decode_capacity(cfg, shape)
        return {
            "kind": "decode",
            "cfg": serve_cfg,
            "params": abstract_params(serve_cfg, device),
            "cache": abstract_cache(serve_cfg, shape.global_batch, capacity, device),
            "tokens": _fake((shape.global_batch,), torch.int32, device),
        }


@contextlib.contextmanager
def abstract_world(shape: Sequence[int], names: Sequence[str],
                   device: Device = "cpu") -> Iterator[Any]:
    """A ``DeviceMesh`` of ``shape`` (dims named ``names``) over a *fake*
    process group of ``prod(shape)`` ranks, with a ``FakeTensorMode``
    entered: this process is rank 0, every collective returns at once and
    moves nothing, and the tensors made inside are fake.  The counterpart
    of the reference's 512 forced host devices: a mesh step runs eagerly
    on it as rank 0 would run it, allocating nothing.

    This is the one place that imports ``FakeStore``, from PyTorch's
    testing internals (``torch.testing._internal.distributed.fake_pg``),
    as ``torch.distributed``'s own tests do.  Raises where a process group
    is already running (one process holds one default group); the fake
    group is destroyed on exit."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group is running: a fake world "
                           "needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        mesh = make_mesh(shape, names, device)
        with FakeTensorMode():
            yield mesh
    finally:
        dist.destroy_process_group()
