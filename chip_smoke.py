#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (or any sm_90a card).

    python3 chip_smoke.py [--out DIR]

It needs the checkout around it (``src/repro_torch``), PyTorch with CUDA,
``nvcc`` and one card, and exits non-zero when any of them is missing or
any phase fails.  Phases:

1. the card (name and power limit) and the build of every kernel under
   ``src/repro_torch/csrc`` for sm_90a, one nvcc per source, all at once,
   with ptxas's registers and spills of the wgmma, split, cluster,
   chunked and fused bodies (the flash backward's wgmma kernels too) and
   the shared memory of the forward wgmma bodies;
2. each kernel against its plain PyTorch version on the card, at the zoo's
   shapes and the reference tolerances (decode attention's bf16 absolute
   tolerance scaled to each output row's largest value where that is
   below 1), through the body each wrapper
   picks, with its time beside the plain version's, one PyTorch library
   call's and the least time the card could take (its bound): decode
   attention (2), flash attention (2b), the SSD scan (2c; mamba2's and
   zamba2's heads) and the MoE
   grouped matmul (2d, group sizes from a seeded router's top-k at
   Qwen3-MoE's and DeepSeek-V2's prefill and decode).  At the main shapes
   the new body and the body it replaced are timed in turns (new, old,
   old, new) in the same run: decode's split against single (2), flash's
   and the grouped matmul's wgmma against mma.sync (2b, 2d; at Qwen3's
   served decode, B = 4, its decode body against wgmma), the SSD
   scan's chunked against serial (2c); then (2e) the flash backward
   kernel against ``flash_attention_bwd_plain`` at the training shapes
   (NeMo's B = 2, S = 2048; granite's MQA; whisper's 1,500-frame encoder;
   zamba2's window at D = 112; NeMo's in fp32), on the forward kernel's
   output and LSE, held as phase 2 holds decode (bf16 errors scaled to
   each row), the wgmma body and the mma body it replaced (timed in turns
   where both take the shape; the split count, the dK/dV pass's CTAs and
   each pass's time by the profiler printed), with its time, its bound
   (10·H·D flops a visible pair),
   the plain version's and the backward of
   ``scaled_dot_product_attention``, and the forward with and without
   its LSE store, in turns; then (2f) the SSD scan's backward kernel
   against ``ssd_scan_bwd_plain`` on the states the forward kernel keeps
   (mamba2's B = 2, T = 2048, H = 48, P = 64, N = 128 and zamba2's H =
   112, N = 64 in bf16, mamba2's in fp32, a ragged T from an initial state
   with a nonzero dstate; each gradient within 5e-5 of its largest value
   plus 5e-4 of itself, bf16 outputs within 2e-2 of the largest; bf16 on
   the mma body and on the fp32 body, timed in turns) and the grouped
   matmul's dx (the forward kernel reading w transposed; wgmma against
   mma in turns) and dw (wgmma against mma in turns) against their plain
   twins at Qwen3-MoE's 32,768 routed rows over 128 experts, 2048 <-> 768
   in bf16 and 2048 -> 768 in fp32, over empty groups (whose dw must be
   zero), and dw with every row in one expert, each with its time, bound,
   the plain backward's time and ``torch._grouped_mm``'s for dx and dw
   where it takes the layout;
3. the decode path at full width in bf16: a 3-worker ServingCluster on one
   card serving 10 pipeline requests (prompts (2, 64)) over
   mistral-nemo-12b (full depth), mamba2-780m (full) and granite-20b (full
   width, depth cut to fit beside NeMo), every decode step a replay of the
   engine's CUDA graph of that model, batch and capacity (each graph's
   capture time and pool printed), with kernel launch counts (every decode
   launch on the split body) read around the run: the replays' and the
   warm-up step's before each capture; the same requests on a fresh
   cluster whose engine runs each task eagerly (equal assignments, hit
   rate and tokens); each model's decode step, graph against eager in
   turns, with the device's busy share of each under the profiler and the
   graphed task's decode kernels counted on the card against the
   engine's count; then NeMo's
   logits, kernel path against plain path; then four NeMo decode steps at
   B = 2 from a 32,768-slot cache of seeded K/V (long-context decode),
   kernel path against plain path, every attention call of one more pass
   held to phase 2's check on its own inputs, with a profile;
3b. the prefill path at full width in bf16, on phase 3's weights:
   ``make_prefill_step`` over B = 2, S = 2048 seeded tokens for each model,
   with the flash and SSD launch counts (and by body: every flash launch on
   wgmma, every SSD launch on chunked) read around the runs, finite logits
   and loss, and the last position's logits, kernel path against plain
   path; mamba2's short one-card prefill (B = 1, S = 256: every SSD call
   one wave) on ``fused``, logits bit for bit those with every call on
   ``chunked``; then NeMo's forward over phase 3's prompt against its
   decode path, within ``LOGIT_BOUND`` with equal argmax;
3h. phase 3's requests on phase 3's models once more, with the cluster's
   four options on (gossip, prefetch, the flight recorder, the health
   plane): the health summary and the recorder's Chrome trace held to
   their schemas, one completed span per task, the decode launches held
   as in phase 3;
3c. once phase 3's models are released: Qwen3-MoE at full width and depth
   in bf16: ``make_prefill_step`` over B = 2, S = 2048 twice with the flash
   and grouped-matmul launch counts (every one on the wgmma bodies), the
   loss, one MoE layer and the whole
   model held kernel path against plain path (with the tokens whose expert
   set differs between the two counted per layer), one serving task
   (``ExecutionEngine.run_task``, the sorted dispatch a card serves with,
   the grouped matmul on its decode body, through a graph; then graph
   against eager in turns, tokens equal) and sorted against scan decode
   from one cache;
3d. the same for DeepSeek-V2 (MLA, shared experts) at full width with its
   depth cut to 4 layers;
3e. zamba2-7b (hybrid) at full width and depth: ``make_prefill_step`` at
   B = 2, S = 2048 and at B = 1, S = 8192 (the shared block's 4,096-key
   window cuts into the band), each twice with its launches by body (flash
   on mma, as D = 112 is no wgmma head dim; the SSD scan on chunked), the
   loss, the logits kernel path against plain path (the last position's
   within ``LOGIT_BOUND``, the argmax equal at ``ARGMAX_SHARE`` of all
   positions), and the device's busy share; one serving task; 16 decode steps from a shared
   block ring seeded with random K/V at a ``pos`` past the window, kernel
   path against plain path, with every attention call held to phase 2's
   check; a decode profile;
3f. whisper-medium (audio) at full width and depth: the same prefill over
   1,500 stub frames and a 448-token text context (every flash launch, the
   encoder's included, on wgmma), decode from a cross-attention cache
   seeded from the encoder (every self- and cross-attention call held to
   phase 2's check), one serving task, a decode profile;
3g. qwen2-vl-72b (VLM, M-RoPE) at full width with its depth cut to 32
   layers: the same prefill over 1,024 vision embeddings and 2,048 tokens,
   decode steps, one serving task, a decode profile (every serving task of
   3e-3g through a graph, then graph against eager in turns);
4. the reduced fp32 serve example, kernel path against plain path: equal
   assignments and tokens; then with all four options on and each task's
   wall time pinned: equal assignments, tokens, SST rows, prefetch stats,
   health summaries and flight-recorder JSONL.
5. Compass on the card: (5a) in a fresh process, the vectorized
   Navigator planner on ``H100_CLUSTER`` at W = 5, 250 and 1,000 (four
   racks, 80 and 94 GB cards) plans seeded jobs of the four paper and four
   arch DFGs with every lane on, through its CUDA graphs and eagerly on
   the card and on the CPU: assignments equal the Python Navigator's,
   planned finish times within rel 1e-5, graph and eager bit for bit, the
   recorder's provenance for one DFG; the median plan time of each way;
   (5b) the card's pinned host->device rate, small-copy latencies
   (``repro_torch.probe``, a fresh process), idle power.draw (read before
   phase 1) and power limit, and NeMo's bf16 prefill rate (phase 3b),
   each within 25 % of the constant of ``H100_CLUSTER`` or the arch
   pipelines that it set; (5c) the port's quickstart comparison, and the
   arch pipelines under Navigator and Hash (every job completes,
   Navigator's hit rate above Hash's).
6. training at full width: mistral-nemo-12b at its full width and 8 of
   its 40 layers (3.52 B parameters; 6 where 8 pass 70 GB at their peak,
   printed as a cut), bf16 params and fp32 AdamW moments, through
   ``make_train_step`` (remat) over the synthetic pipeline at B = 2,
   S = 2048: one warm-up and five timed steps with the counts set to 0
   just before them (every flash forward on wgmma, layers × 2 a step
   with remat's recomputation; every backward on wgmma, layers × 1),
   finite losses, moved params, the step time, tokens/s, 6·N·tokens over
   the step time, the peak memory, the busy share and the top kernels of
   one more step under the profiler; then one step at 2 layers, kernel
   path against plain path (``impl="ref"``): loss, grad norm and every
   leaf's gradient (cosine, and max error against the leaf's largest).
6b. the SSM, hybrid and MoE families training through their kernels,
   after phase 6's models are released: mamba2-780m whole, zamba2-7b at
   12 of its 81 layers (its shared attention block twice) and Qwen3-MoE
   at 4 of its 48 (the sorted dispatch), at full width in bf16 with fp32
   AdamW moments, B = 2, S = 2048: one warm-up and five timed steps each,
   every kernel's launches by body against what the layers and remat
   predict (mamba2: 96 forward and 48 backward scans a step, the backward
   on mma; Qwen3: 24 grouped matmuls, 12 dx and 12 dw a step, dw on
   wgmma), finite losses, moved params, the step time, tokens/s and peak
   memory; one more step of mamba2 and of Qwen3-MoE under the profiler,
   with the device time of the SSD backward's or dw's launches in it; then
   each family at 2 layers, kernel path against plain path as phase 6
   holds NeMo (the MoE router's choices recorded on the kernel path and
   replayed on the plain one).
7. the mesh, in a fresh process: a one-rank NCCL group and
   ``make_debug_mesh``'s (1, 1) ``("data", "model")`` mesh; (7a)
   ``repro_torch.launch.serve``'s step on mistral-nemo-12b at full width
   in bf16 over DTensor params (B = 4, capacity 256, 64 tokens; every
   decode launch on split), then beside the mesh-less ``make_serve_step``
   on the same params: logits bit for bit, tokens equal; (7b) Qwen3-MoE at
   full width and depth, prefill B = 2, S = 2048 with the ``ep`` dispatch
   (nothing dropped at |model| = 1), ``moe_gmm`` counted by body and by the
   profiler, held against the ``sorted`` dispatch; (7c) three mesh train
   steps on NeMo at full width, 2 layers, against three mesh-less ones
   (loss, grad norm and params within 1e-6 relative), the flash forward
   and backward launches by body; (7d) the SST all-gather over NCCL, bit
   for bit, with the time of one exchange; (7e) decode attention over
   NeMo's and granite's 32,768-slot bf16 caches cut along T into 2, 4
   and 16 slices, as a (1, n) mesh's ranks hold them:
   ``decode_attention_partials`` on each slice (its fp32 record of acc, m
   and l), the records stacked, then ``combine_partials``, on the new
   bodies (``cluster``, the ``warp`` combine) and the old (``split``, the
   ``block`` combine), against the whole kernel and the plain path (phase
   2's check; an all-empty slice's record is (-inf, 0, 0) with zero pads),
   the launches of one rank's ``t_split_decode_attention`` in a layer (one
   partials, one combine), and one rank's work at n = 16 timed in turns,
   new bodies against old, by launch, beside the whole kernel, the plain
   path, the bound and the efficient SDPA's (output, LSE) as the library
   yardstick; (7f) mamba2-780m at full width
   and depth over the mesh, its Mamba-2 layers on the head-split path
   (every head at one ``model`` rank): 16 serve steps at B = 4 and a
   prefill at B = 2, S = 2048, logits bit for bit the mesh-less steps',
   every SSD launch on chunked; (7g) the SSD scan of mamba2's and
   zamba2's heads (phase 2c's bf16 inputs) cut into 2, 4 and 16 slices
   of heads, as a (1, n) mesh's ranks compute them, on the ``fused`` and
   the ``chunked`` body, side by side against the whole call and the plain
   path (phase 2c's check) and bit for bit the whole chunked call (fused
   only where a slice's grid fits one wave, n = 16; refused at n = 2 and
   4), and one rank's call at n = 16, fused against chunked in turns,
   each body by launch ((a), (b), (c) for chunked), beside the plain path
   and the bound, and the whole call on chunked once.
8. the analysis tooling: (8a) ``python -m repro_torch.launch.dryrun``
   over a fake 16x16 mesh of 256 ranks, one process a call
   (``DRYRUN_CALLS``: every arch's prefill and decode shapes but the SSM
   ones' 32k prefill, and NeMo's train shape, by the extrapolation
   from shallow variants), every record ok and whisper x long_500k the one skip;
   one direct full-depth count (NeMo's prefill_32k) equal to its
   extrapolation; the roofline (``repro_torch.launch.roofline.main``, in
   this process) over the records, its H100 table and the cases whose
   state does not fit 80 GB; (8b) NeMo at full width and 2 layers on the
   plain path, prefill at B = 2, S = 2048 and one train step, counted on
   the card by ``StepCounter`` and on fake tensors: FLOPs, bytes,
   collectives and ops equal, the state bytes equal to the real
   tensors', the counted peak within ``PEAK_TOL`` of
   ``max_memory_allocated``; the same two steps
   over the (1, 1) NCCL mesh (a fresh process) against a fake (1, 1)
   mesh; (8c) from the earlier phases' readings: the roofline of NeMo's
   graphed decode step (phase 3), its prefill (3b) and NeMo@8's train
   step (6), each step's compute and memory terms counted on the ``ref``
   path, the bound's share of the measured time and 2·N or 6·N·tokens
   over the measured time at 989 TFLOP/s, beside the card's name and
   power limit.

Every profile (``profiled``: phases 3, 3b-3g and 6) opens with
``BALLAST`` tiny kernels, counts only the records after them, and is taken
again where the ballast was lost whole.

It prints, in order: the card line, per-phase results, one JSON line with
every kernel's numbers (with the shapes phases 3e-3g gave it and its
launches there), and last ``{"ok": true, "device": {...}}``.
``--out DIR`` also writes every measurement and nvcc's ptxas report there.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
GMM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # tests/test_kernels.py's GMM tolerance
# SSD: tests/test_kernels.py's 5e-5 / 5e-4 in fp32 (y and the state); y is
# rounded to bf16 in bf16
SSD_TOL = {"float32": dict(atol=5e-5, rtol=5e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock: covers the host's enqueue
# NeMo's bf16 logits, kernel path against the plain fp32 path, as a share of
# the largest logit.  The two plain paths differ from each other by 6e-2 to
# 9e-2 there: 40 bf16 layers of random weights amplify one-ulp differences
# in an attention output that much (PERF.md), so 2e-2 cannot hold.
LOGIT_BOUND = 0.1
# Phases 3e-3g hold the argmax over every position (prefill) or every
# decoded row, not at the last position alone: over random bf16 weights
# 5-15 % of positions pick another token on the kernel path than on the
# plain path, about as many as the plain path against an fp32 evaluation of
# the same weights, and zamba2's last position flips by two bf16 ulps
# (tools/logit_agreement.py; PERF.md §6).  The share of positions that
# agree must reach ARGMAX_SHARE, the midpoint of the lowest share of the
# sound kernel path (qwen2-vl's decode, 0.8125) and the highest share below
# it of the faults that ``tools/logit_agreement.py --plant`` plants in flash
# and decode attention (whisper's flash fault, 0.7969), on an H100.  A
# decode fault that drops one slot of thousands reads above it; phase 2's
# check on every attention call (``checked_attention``) catches that.
ARGMAX_SHARE = 0.8
# decode steps of phases 3e-3g held kernel path against plain path
DECODE_STEPS = 16
MAIN_SHAPE = dict(model="mistral-nemo-12b", b=2, h=32, kh=8, d=128, t=13, dtype="bfloat16")
# the serving run's other decode shape: granite's MQA (48 query heads on one KV head)
GRANITE_SHAPE = dict(model="granite-20b", b=2, h=48, kh=1, d=128, t=13, dtype="bfloat16")
# the prefill phase's shapes: B = 2, S = 2048, bf16
PREFILL_B, PREFILL_S = 2, 2048
FLASH_MAIN = dict(model="mistral-nemo-12b", b=PREFILL_B, s=PREFILL_S, case="causal", dtype="bfloat16")
SSD_MAIN = dict(model="mamba2-780m", b=PREFILL_B, t=PREFILL_S, dtype="bfloat16")
# the hybrid, VLM and audio prefills (phases 3e-3g): whisper's decoder over
# its whole 448-token text context beside 1,500 encoder frames; qwen2-vl
# over 1,024 vision embeddings (a 32 x 32 grid) and 2,048 tokens; zamba2 at
# PREFILL_B x PREFILL_S and at one 8,192-token sequence, where its shared
# block's 4,096-key window cuts into the band
WHISPER_S = 448
VLM_VISION = 1024
ZAMBA_LONG_S = 8192
# Qwen3-MoE's prefill: B·S·top_k = 32768 rows over 128 experts, 2048 -> 768
GMM_MAIN = dict(model="qwen3 prefill", d_in=2048, d_out=768, dtype="bfloat16")
# what phase 3 hands to phases 3b and 3h: the hosted models, NeMo's prompt
# and logits, the serving run's requests, launches and wall time
SHARED = {}
# every execution engine a phase builds: release_models drops their graphs
# and caches with the models
ENGINES = []
#: The task wall time of phase 4's runs with all four options on.
PINNED_WALL_S = 0.05
#: Prompt tokens of the tasks timed graph against eager, and of the
#: tasks profiled: with 6 decoded tokens, tasks of 22 and 14 steps.
TURN_PROMPT, PROFILE_PROMPT = 16, 8


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


class Phases:
    """Runs each phase, keeps going after a failure, remembers it."""

    def __init__(self) -> None:
        self.failed = []
        self.tracebacks = {}

    def run(self, name, fn, *args):
        print(f"\n== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # report, then go on to the next phase
            self.tracebacks[name] = traceback.format_exc()
            print(self.tracebacks[name], file=sys.stderr)
            print(f"== {name}: FAILED", flush=True)
            self.failed.append(name)
            return None
        print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        return out


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------
def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi failed"


def build_kernels():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    wall = time.perf_counter() - t0
    for name in libs:
        print(f"built {name}: {_build.build_seconds[name]:.1f} s")
    print(f"kernel build wall time: {wall:.1f} s")
    report = wgmma_report(_build.build_logs)
    report["new_bodies"] = ptxas_rows(_build.build_logs, {
        "decode_attention": ("decode_split", "decode_combine"),
        "decode_partials": ("decode_split", "decode_combine_warp"),
        "ssd_scan": ("ssd_chunk", "ssd_state_pass", "ssd_fused"),
        "flash_attention_bwd": ("bwd_dkdv_wgmma", "bwd_dq_wgmma", "bwd_split_sum"),
        "ssd_scan_bwd": ("ssd_chunk_state_mma", "ssd_bwd_rows_mma", "ssd_bwd_cols_mma")})
    return {"build_wall_s": wall, "build_s": dict(_build.build_seconds),
            "ptxas": dict(_build.build_logs), "wgmma_bodies": report}


def ptxas_rows(logs, wanted):
    """ptxas's registers and spills for each kernel of ``wanted`` (library ->
    substrings of the kernels' mangled names)."""
    import re

    rows = []
    for lib, keys in wanted.items():
        entry = None
        for line in logs.get(lib, "").splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None or not any(k in entry for k in keys):
                continue
            if "spill" in line or "Used" in line:
                rows.append(dict(lib=lib, kernel=entry, ptxas=line.strip()))
                print(f"ptxas {lib} {entry[-48:]}: {line.strip()}")
    return rows


def wgmma_report(logs):
    """ptxas's registers and spills for each wgmma kernel, with the dynamic
    shared memory its launch asks for (ptxas counts static memory only)."""
    import ctypes
    import re
    from repro_torch.kernels import _build

    fa_lib, gmm_lib = _build.load("flash_attention"), _build.load("moe_gmm")
    fa_lib.flash_attention_wgmma_smem_bytes.restype = ctypes.c_int
    gmm_lib.moe_gmm_wgmma_smem_bytes.restype = ctypes.c_size_t
    smem = {f"flash_attention D={d}": fa_lib.flash_attention_wgmma_smem_bytes(d)
            for d in (64, 128, 192, 256)}
    gmm_lib.moe_gmm_wgrad_wgmma_smem_bytes.restype = ctypes.c_size_t
    smem.update({f"moe_gmm E={e}": gmm_lib.moe_gmm_wgmma_smem_bytes(e) for e in (128, 160)})
    smem.update({f"moe_gmm dw E={e}": gmm_lib.moe_gmm_wgrad_wgmma_smem_bytes(e)
                 for e in (128, 160)})
    rows = []
    for lib in ("flash_attention", "moe_gmm"):
        entry = None
        for line in logs.get(lib, "").splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None or "wgmma" not in entry:
                continue
            if "spill" in line or "Used" in line:
                rows.append(dict(lib=lib, kernel=entry, ptxas=line.strip()))
                print(f"ptxas {lib} {entry[-48:]}: {line.strip()}")
        if not logs.get(lib):
            print(f"ptxas {lib}: no report (an up-to-date library was found on disk)")
    for what, n in smem.items():
        print(f"wgmma body dynamic shared memory, {what}: {n} bytes")
    return dict(ptxas=rows, dynamic_smem=smem)


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------
def cuda_time_ms(fn, flush, reps=25, warmup=3):
    """Median device time of ``fn`` over ``reps`` calls, between CUDA events.

    Each call follows an L2 flush (the real caller finds the cache cold:
    the layer's weights stream through L2 between two attention calls) and
    a spin kernel that holds the card while the host enqueues the start
    event, ``fn``'s launches and the end event, so that the time between
    the events is device time and not the host's launch path."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def in_turns(new, old, flush, reps):
    """Median device times of ``new`` and ``old`` in turns (new, old, old,
    new); returns each one's mean over its two turns, and every reading."""
    turns = {"new": [], "old": []}
    for which in ("new", "old", "old", "new"):
        turns[which].append(cuda_time_ms(new if which == "new" else old, flush, reps=reps))
    return statistics.mean(turns["new"]), statistics.mean(turns["old"]), turns


def kernel_split(fn, names, calls=5, rest=None):
    """Device time (ms per call) of ``fn``'s kernels by name: the profiler's
    device events over ``calls`` calls, summed by which of ``names`` each
    kernel's name holds; with ``rest``, the device time of every other
    kernel under that key."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in names + ((rest,) if rest else ())}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        hit = [k for k in names if k in e.key]
        for k in hit or ([rest] if rest else []):
            out[k] += us / 1e3 / calls
    return out


def decode_bound(b, h, kh, d, lens, dtype, itemsize):
    """Least time (ms) for the work these inputs need: q and lens read once,
    the valid K/V rows read once, the output written once; 4·H·D flops per
    valid row.  Returns (ms, bytes, flops, 'bytes' or 'operations')."""
    rows = sum(lens)
    nbytes = 2 * b * h * d * itemsize + 4 * b + 2 * rows * kh * d * itemsize
    flops = 4 * h * d * rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def library_call(q, k, v, lens):
    """One PyTorch call computing the same function (timed only)."""
    import torch
    import torch.nn.functional as F

    t = k.shape[1]
    qs = q[:, :, None, :]
    ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(t, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)


# phase 2's decode shapes: (model, B, H, KH, D) at each T, then the zoo's
# other head dims: whisper 64, zamba2 112, MLA 192 (hd + rope); then the
# hybrid, VLM and audio paths' long shapes: whisper's cross-attention over
# 1,500 encoder frames, zamba2's full 4,096-slot ring, qwen2-vl after a
# 3,072-token prefill
DECODE_MODELS = {"mistral-nemo-12b": (2, 32, 8, 128), "granite-20b": (2, 48, 1, 128)}
DECODE_SHAPES = ([(m, *s, t) for m, s in DECODE_MODELS.items() for t in (13, 300, 4096, 32768)]
                 + [("whisper-medium", 2, 16, 16, 64, 300), ("zamba2-7b", 2, 32, 32, 112, 300),
                    ("deepseek-v2-236b", 2, 128, 128, 192, 300),
                    ("whisper-medium", 2, 16, 16, 64, 1500), ("zamba2-7b", 2, 32, 32, 112, 4096),
                    ("qwen2-vl-72b", 2, 64, 8, 128, 3072)])


def decode_inputs(gen, dev):
    """Phase 2's inputs from ``gen``, in order: (model, B, H, KH, D, T,
    dtype, q, k, v, ragged length) for each shape in both dtypes."""
    import torch

    for model, b, h, kh, d, t in DECODE_SHAPES:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q = torch.randn(b, h, d, generator=gen, device=dev, dtype=tdt)
            k = torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=tdt)
            v = torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=tdt)
            ragged = int(torch.randint(1, t + 1, (1,), generator=gen, device=dev))
            yield model, b, h, kh, d, t, dtype, q, k, v, ragged


def decode_lengths(t, ragged):
    """Phase 2's three length cases of a shape: every slot, an empty row
    beside a ragged one, one slot beside a ragged one."""
    return (("full", [t, t]), ("0+ragged", [0, ragged]), ("1+ragged", [1, ragged]))


def decode_close(got, want, dtype):
    """Phase 2's check of a decode-attention output against the plain
    version's: |got - want| <= atol + TOL·|want| with atol = TOL, where in
    bf16 atol is scaled to each output row's largest |want| when that is
    below 1.  Over a long cache of random data a row averages to about
    sqrt(e/T) (0.009 at T = 32768), so an unscaled 2e-2 would pass a split
    that was dropped or combined without its rescale."""
    tol = TOL[dtype]
    atol = tol
    if dtype == "bfloat16":
        atol = tol * want.abs().amax(dim=-1, keepdim=True).clamp(max=1.0)
    return bool(((got - want).abs() <= atol + tol * want.abs()).all())


def kernel_vs_plain():
    import torch
    from repro_torch.kernels import decode_attention as da

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # where the split body is timed against the single body, in turns
    in_turn = {(m, t) for m in DECODE_MODELS for t in (13, 4096, 32768)} | {("deepseek-v2-236b", 300)}
    rows = []
    for model, b, h, kh, d, t, dtype, q, k, v, ragged in decode_inputs(gen, dev):
        tdt = getattr(torch, dtype)
        splits = da.splits_for(b, kh, t, da.sm_count(dev))
        body = da.body_for(tdt, d, h // kh, splits)
        splits = splits if body == "split" else 1
        errs = {}
        for case, lens in decode_lengths(t, ragged):
            n = torch.tensor(lens[:b], dtype=torch.int32, device=dev)
            got = da.decode_attention(q, k, v, n).float()
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q, k, v, n).float()
            errs[case] = float((got - want).abs().max())
            if not decode_close(got, want, dtype):
                raise AssertionError(f"{model} {dtype} T={t} lens={lens}: max err "
                                     f"{errs[case]} outside {TOL[dtype]} (scaled in bf16)")
            if lens[0] == 0 and bool(got[0].ne(0).any()):
                raise AssertionError(f"{model} {dtype} T={t}: empty row is not 0")
        n = torch.full((b,), t, dtype=torch.int32, device=dev)
        old_body_ms = split_ms = turns = None
        if (model, t) in in_turn:
            split_ms, old_body_ms, turns = in_turns(
                lambda: da.decode_attention(q, k, v, n, body="split"),
                lambda: da.decode_attention(q, k, v, n, body="single"), flush, 25)
            kernel_ms = split_ms if body == "split" else old_body_ms
        else:
            kernel_ms = cuda_time_ms(lambda: da.decode_attention(q, k, v, n), flush)
        plain_ms = cuda_time_ms(lambda: da.decode_attention_plain(q, k, v, n), flush)
        lib = library_call(q, k, v, n)
        library_ms = cuda_time_ms(lib, flush)
        lib_err = float((lib()[:, :, 0].float() - da.decode_attention_plain(q, k, v, n).float()).abs().max())
        bound_ms, nbytes, flops, bound_by = decode_bound(b, h, kh, d, [t] * b, dtype, q.element_size())
        ctas = b * kh * (splits if body == "split" else -(-(h // kh) // 32))
        by_kernel = None
        if dtype == "bfloat16" and t == 32768:  # the split body's two launches
            by_kernel = kernel_split(lambda: da.decode_attention(q, k, v, n),
                                     ("decode_split", "decode_combine"))
            print(f"  profile, ms per call: {by_kernel}")
        row = dict(model=model, b=b, h=h, kh=kh, d=d, t=t, dtype=dtype, body=body,
                   splits=splits, max_abs_err=max(errs.values()), errs=errs,
                   kernel_ms=kernel_ms, old_body_ms=old_body_ms, split_ms=split_ms,
                   turns_ms=turns, plain_ms=plain_ms, library_ms=library_ms, library_err=lib_err,
                   bound_ms=bound_ms, bound_us_bytes=nbytes / HBM_BYTES_PER_S * 1e6,
                   bytes=nbytes, flops=flops, bound_by=bound_by, ctas=ctas,
                   by_kernel=by_kernel)
        rows.append(row)
        old_txt = (f" (split {split_ms * 1e3:.1f} us, single {old_body_ms * 1e3:.1f} us in turns)"
                   if old_body_ms is not None else "")
        print(f"{model:18s} {dtype:8s} B={b} H={h:3d} KH={kh:3d} D={d:3d} T={t:5d} "
              f"err={row['max_abs_err']:.2e} {body} kernel={kernel_ms * 1e3:.1f} us{old_txt} "
              f"plain={plain_ms * 1e3:.1f} us library={library_ms * 1e3:.1f} us "
              f"bound={bound_ms * 1e3:.2f} us ({bound_by}) splits={splits} ctas={ctas}",
              flush=True)
        del q, k, v
    return rows


def visible_pairs(sq, sk, causal, window, q_offset):
    """(query, key) pairs the mask lets through, for one (batch row, head)."""
    import numpy as np

    i = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(sk - 1, i) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound(b, sq, sk, h, kh, d, causal, window, q_offset, dtype, itemsize):
    """Least time (ms): q, k, v read once and out written once, against
    4·H·D flops per visible pair.  Returns (ms, bytes, flops, bound_by)."""
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kh * d) * itemsize
    flops = 4 * b * h * d * visible_pairs(sq, sk, causal, window, q_offset)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def flash_library_call(q, k, v, causal, window, q_offset):
    """``scaled_dot_product_attention`` on the same inputs (timed only): the
    causal flag where it means the same mask, an explicit mask otherwise."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import _visible

    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = {"enable_gqa": True}
    if q.dtype == torch.float32:
        # no fused fp32 backend takes enable_gqa, and the unfused one holds
        # the whole (Sq x Sk) matrix: hand it K/V already repeated to H heads
        g = q.shape[2] // k.shape[2]
        ks, vs = ks.repeat_interleave(g, dim=1), vs.repeat_interleave(g, dim=1)
        gqa = {}
    if causal and window is None and q_offset == 0 and q.shape[1] == k.shape[1]:
        return lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, **gqa)
    mask = _visible(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, **gqa)


def flash_vs_plain():
    import torch
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = []  # (model, b, sq, sk, h, kh, d, case, causal, window, q_offset)
    for model, h, kh in (("mistral-nemo-12b", 32, 8), ("granite-20b", 48, 1)):
        for s in (512, 2048, 8192):
            shapes.append((model, 2, s, s, h, kh, 128, "causal", True, None, 0))
    shapes += [
        ("mistral-nemo-12b", 2, 2048, 2048, 32, 8, 128, "window 512", True, 512, 0),
        ("mistral-nemo-12b", 2, 256, 2048, 32, 8, 128, "q_offset 1792", True, None, 1792),
        ("mistral-nemo-12b", 2, 512, 512, 32, 8, 128, "q_offset -64", True, None, -64),
        # the zoo's other head dims: whisper 64, zamba2 112, MLA 192 (hd + rope)
        ("whisper-medium", 2, 1024, 1024, 16, 16, 64, "causal", True, None, 0),
        ("zamba2-7b", 2, 1024, 1024, 32, 32, 112, "causal", True, None, 0),
        ("deepseek-v2-236b", 2, 1024, 1024, 128, 128, 192, "causal", True, None, 0),
        # the hybrid, VLM and audio prefills: whisper's encoder and its
        # decoder's cross-attention over 1,500 frames (bidirectional),
        # zamba2's shared block (D = 112 on the mma body) with its 4,096-key
        # window, at S = 2048 and where the window cuts into the band, and
        # qwen2-vl over 1,024 vision embeddings and 2,048 tokens
        ("whisper-medium", 2, 1500, 1500, 16, 16, 64, "encoder", False, None, 0),
        ("whisper-medium", 2, WHISPER_S, 1500, 16, 16, 64, "cross", False, None, 0),
        # the decoder's own text: 448 = 3.5 tiles, its causal diagonal tile ends part-way
        ("whisper-medium", 2, WHISPER_S, WHISPER_S, 16, 16, 64, "causal", True, None, 0),
        ("zamba2-7b", 2, 2048, 2048, 32, 32, 112, "window 4096", True, 4096, 0),
        ("zamba2-7b", 1, 8192, 8192, 32, 32, 112, "window 4096", True, 4096, 0),
        ("qwen2-vl-72b", 2, 3072, 3072, 64, 8, 128, "causal", True, None, 0),
    ]
    # the main shapes, where the wgmma body is timed against the mma body
    main = {(FLASH_MAIN["model"], FLASH_MAIN["s"], FLASH_MAIN["case"]),
            ("deepseek-v2-236b", 1024, "causal")}
    rows = []
    for model, b, sq, sk, h, kh, d, case, causal, window, q_offset in shapes:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q = torch.randn(b, sq, h, d, generator=gen, device=dev, dtype=tdt)
            k = torch.randn(b, sk, kh, d, generator=gen, device=dev, dtype=tdt)
            v = torch.randn(b, sk, kh, d, generator=gen, device=dev, dtype=tdt)
            body = fa.body_for(tdt, d)
            got = fa.flash_attention(q, k, v, **kw).float()
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, **kw).float()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype]):
                raise AssertionError(f"flash {model} {dtype} S={sq}x{sk} {case}: "
                                     f"max err {err} outside {TOL[dtype]}")
            unseen = max(0, min(sq, -q_offset)) if causal else 0
            if unseen and bool(got[:, :unseen].ne(0).any()):
                raise AssertionError(f"flash {model} {dtype} {case}: rows that see no key are not 0")
            del got, want
            reps = 25 if sq * sk <= 2048 * 2048 else 7
            old_body_ms = turns = None
            if dtype == "bfloat16" and (model, sq, case) in main:
                kernel_ms, old_body_ms, turns = in_turns(
                    lambda: fa.flash_attention(q, k, v, **kw),
                    lambda: fa.flash_attention(q, k, v, body="mma", **kw), flush, reps)
            else:
                kernel_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush,
                                         reps=reps)
            plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), flush, reps=reps)
            library_ms = lib_err = None
            if not unseen:  # SDPA gives NaN for a row that sees no key
                lib = flash_library_call(q, k, v, causal, window, q_offset)
                library_ms = cuda_time_ms(lib, flush, reps=reps)
                lib_err = float((lib().transpose(1, 2).float()
                                 - fa.flash_attention_plain(q, k, v, **kw).float()).abs().max())
                del lib
            bound_ms, nbytes, flops, bound_by = flash_bound(b, sq, sk, h, kh, d, causal, window,
                                                            q_offset, dtype, q.element_size())
            row = dict(model=model, b=b, s=sq, sk=sk, h=h, kh=kh, d=d, case=case, dtype=dtype,
                       body=body, max_abs_err=err, kernel_ms=kernel_ms,
                       old_body_ms=old_body_ms, turns_ms=turns, plain_ms=plain_ms,
                       library_ms=library_ms, library_err=lib_err, bound_ms=bound_ms,
                       bytes=nbytes, flops=flops, bound_by=bound_by,
                       kernel_tflops=flops / kernel_ms / 1e9,
                       ctas=-(-sq // (128 if body == "wgmma" else 64)) * h * b)
            rows.append(row)
            lib_txt = f"{library_ms:.4f} ms" if library_ms is not None else "-"
            old_txt = (f" mma body={old_body_ms:.4f} ms ({flops / old_body_ms / 1e9:.1f} TFLOP/s)"
                       if old_body_ms is not None else "")
            print(f"{model:18s} {dtype:8s} B={b} S={sq:5d}x{sk:5d} H={h:3d} KH={kh:3d} D={d:3d} "
                  f"{case:14s} err={err:.2e} {body} kernel={kernel_ms:.4f} ms{old_txt} "
                  f"plain={plain_ms:.4f} ms library={lib_txt} bound={bound_ms:.4f} ms "
                  f"({bound_by}) {row['kernel_tflops']:.1f} TFLOP/s ctas={row['ctas']}",
                  flush=True)
            del q, k, v
    return rows


def ssd_bound(b, t, h, p, n, chunk, dtype, itemsize):
    """Least time (ms): x, dt, b, c read once, y and the state written
    once, against the flops the function needs per chunk of l steps and
    head: l(l+1)(N + P) for the causal pairs j ≤ i of C Bᵀ and of its
    product with X, and 4lPN for C S_inᵀ and the state update.  Returns
    (ms, bytes, flops, bound_by)."""
    nbytes = b * t * h * ((2 * p + 2 * n) * itemsize + 4) + 4 * h + 4 * b * h * p * n
    lengths = [chunk] * (t // chunk) + ([t % chunk] if t % chunk else [])
    flops = b * h * sum(l * (l + 1) * (n + p) + 4 * l * p * n for l in lengths)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def ssd_vs_plain():
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    both = ("float32", "bfloat16")
    # mamba2-780m at B = 1, 3 and 4 in fp32: the serial body's B·H CTAs fill
    # 36 %, 55 % and 73 % of the SM waves they take, against B = 2's 73 %:
    # both sides of fp32's choice (bf16's does not depend on B); then
    # zamba2's heads (H = 112, P = N = 64) at its two prefill shapes
    rows = []
    for model, b, t, dtypes in (("mamba2-780m", 2, 2048, both), ("mamba2-780m", 2, 8192, both),
                                ("mamba2-780m", 2, 2000, both),
                                *(("mamba2-780m", b, 8192, ("float32",)) for b in (1, 3, 4)),
                                ("zamba2-7b", 2, 2048, both), ("zamba2-7b", 1, 8192, both)):
        cfg = ARCHS[model]
        h, p, n, chunk = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        for dtype in dtypes:
            tdt = getattr(torch, dtype)
            x = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(tdt)
            dt = F.softplus(torch.randn(b, t, h, generator=gen, device=dev))
            a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
            bb = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(tdt)
            cc = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(tdt)
            body = ssd.body_for(tdt, p, n, min(chunk, t), b * h, sms)
            y, fs = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
            torch.cuda.synchronize()
            ye, fse = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk)
            err = float((y.float() - ye.float()).abs().max())
            state_err = float((fs - fse).abs().max())
            if not (torch.allclose(y.float(), ye.float(), **SSD_TOL[dtype])
                    and torch.allclose(fs, fse, **SSD_TOL["float32"])):
                raise AssertionError(f"ssd {model} {dtype} B={b} T={t}: max err y {err}, "
                                     f"state {state_err} "
                                     f"outside {SSD_TOL[dtype]}")
            bound_ms, nbytes, flops, bound_by = ssd_bound(b, t, h, p, n, chunk, dtype,
                                                          x.element_size())
            ctas = b * h * -(-t // chunk) if body == "chunked" else b * h
            row = dict(model=model, b=b, t=t, h=h, p=p, n=n, chunk=chunk, dtype=dtype,
                       body=body, max_abs_err=err, state_err=state_err, bound_ms=bound_ms,
                       bytes=nbytes, flops=flops, bound_by=bound_by, library_ms=None, ctas=ctas,
                       old_body_ms=None)
            if t % chunk == 0:  # the ragged row checks the edge and is not timed
                row["chunked_ms"], row["old_body_ms"], row["turns_ms"] = in_turns(
                    lambda: ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, body="chunked"),
                    lambda: ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, body="serial"), flush, 10)
                row["kernel_ms"] = row["chunked_ms"] if body == "chunked" else row["old_body_ms"]
                row["plain_ms"] = cuda_time_ms(
                    lambda: ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk), flush, reps=10)
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
                # the chunked body's three launches
                row["by_kernel"] = kernel_split(
                    lambda: ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, body="chunked"),
                    ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out"))
                print(f"  profile of the chunked body, ms per call: {row['by_kernel']}")
            rows.append(row)
            times = (f"kernel={row['kernel_ms']:.4f} ms (chunked {row['chunked_ms']:.4f} ms, "
                     f"serial {row['old_body_ms']:.4f} ms in turns) "
                     f"plain={row['plain_ms']:.4f} ms {row['kernel_tflops']:.2f} TFLOP/s"
                     if "kernel_ms" in row else "not timed")
            print(f"{model:18s} {dtype:8s} B={b} T={t:5d} H={h} P={p} N={n} L={chunk} "
                  f"{body} err y={err:.2e} state={state_err:.2e} {times} library=- "
                  f"bound={bound_ms:.4f} ms ({bound_by}) ctas={ctas}", flush=True)
            del x, dt, bb, cc, y, fs, ye, fse
    return rows


def gmm_bound(t, d_in, d_out, sizes, dtype, itemsize):
    """Least time (ms): x read once, the non-empty experts' weights read
    once, the output written once (and the sizes read), against
    2·T·d_in·d_out flops.  Returns (ms, bytes, flops, bound_by)."""
    nonempty = sum(1 for n in sizes if n > 0)
    nbytes = (t * d_in + nonempty * d_in * d_out + t * d_out) * itemsize + 4 * len(sizes)
    flops = 2 * t * d_in * d_out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def routed_sizes(gen, tokens, d_model, n_experts, top_k):
    """Group sizes from a seeded router's real top-k over random tokens (as
    ``_moe_sorted`` counts them): uneven, as a model's are."""
    import torch
    from repro_torch.models import moe as moe_mod

    x = torch.randn(tokens, d_model, generator=gen, device=gen.device, dtype=torch.bfloat16)
    router = torch.randn(d_model, n_experts, generator=gen, device=gen.device) * 0.02
    _, idx, _ = moe_mod.route(x, router, top_k)
    return torch.bincount(idx.reshape(-1), minlength=n_experts).to(torch.int32)


def grouped_mm_call(x, w, sizes):
    """``torch._grouped_mm`` on the same inputs (timed only; the port never
    calls it), or the reason there is none."""
    import torch

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "this PyTorch has no torch._grouped_mm"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    errors = []
    # as the port lays w out (row-major d_in x d_out), then column-major
    for wl in (w, w.transpose(1, 2).contiguous().transpose(1, 2)):
        try:
            fn(x, wl, offs=offs)
            torch.cuda.synchronize()
            return (lambda: fn(x, wl, offs=offs)), None
        except (RuntimeError, TypeError, ValueError) as e:
            errors.append(str(e).splitlines()[0][:160])
    return None, "torch._grouped_mm refused these inputs: " + " | ".join(errors)


def gmm_vs_plain():
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels.ref import moe_gmm_ref

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    qwen, ds = ARCHS["qwen3-moe-30b-a3b"], ARCHS["deepseek-v2-236b"]
    cases = []  # (name, rows, d_in, d_out, sizes, timed)
    for model, cfg, b, s in (("qwen3 prefill", qwen, PREFILL_B, PREFILL_S),
                             ("qwen3 sorted decode", qwen, 4, 1),
                             ("deepseek prefill", ds, PREFILL_B, PREFILL_S)):
        sizes = routed_sizes(gen, b * s, cfg.d_model, cfg.n_experts, cfg.top_k)
        d, f = cfg.d_model, cfg.d_ff_expert
        cases += [(model, d, f, sizes, True), (model, f, d, sizes, True)]
    ragged = torch.tensor([1000, 0, 7, 2048, 1, 513, 0, 530], dtype=torch.int32, device=dev)
    empty = torch.zeros(128, dtype=torch.int32, device=dev)
    empty[[3, 40, 41, 99, 127]] = torch.tensor([1000, 1, 2000, 95, 1000], dtype=torch.int32,
                                               device=dev)
    # d_in 1000 and d_out 776: whole 16-byte vectors, partial depth and
    # column tiles; 999 -> 777: no whole vectors (the element-wise loads)
    cases += [("ragged tiles", 1000, 776, ragged, False),
              ("ragged widths", 999, 777, ragged, False),
              ("empty groups", qwen.d_model, qwen.d_ff_expert, empty, False),
              ("single expert", qwen.d_model, qwen.d_ff_expert,
               torch.tensor([4096], dtype=torch.int32, device=dev), False)]
    rows = []
    for model, d_in, d_out, sizes, timed in cases:
        t, e = int(sizes.sum()), sizes.numel()
        host_sizes = sizes.tolist()
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            x = torch.randn(t, d_in, generator=gen, device=dev, dtype=tdt)
            w = (torch.randn(e, d_in, d_out, generator=gen, device=dev) * 0.02).to(tdt)
            body = gmm.body_for(tdt, d_in, d_out, n_experts=e, rows=t)
            got = gmm.moe_gmm(x, w, sizes).float()
            torch.cuda.synchronize()
            want = gmm.moe_gmm_plain(x, w, sizes).float()
            err = float((got - want).abs().max())
            # the oracle multiplies in the working dtype (cuBLAS for each group)
            oracle_err = float((got - moe_gmm_ref(x, w, sizes).float()).abs().max())
            tol = GMM_TOL[dtype]
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(f"gmm {model} {dtype} T={t} {d_in}->{d_out} E={e}: "
                                     f"max err {err} outside {tol}")
            del got, want
            bound_ms, nbytes, flops, bound_by = gmm_bound(t, d_in, d_out, host_sizes, dtype,
                                                          x.element_size())
            row = dict(model=model, t=t, e=e, d_in=d_in, d_out=d_out, dtype=dtype, body=body,
                       old_body_ms=None, nonempty=sum(1 for n in host_sizes if n > 0),
                       max_rows=max(host_sizes), max_abs_err=err, oracle_err=oracle_err,
                       bound_ms=bound_ms,
                       bytes=nbytes, flops=flops, bound_by=bound_by, library_ms=None)
            if timed:
                reps = 25 if t * d_in * d_out < 2**34 else 10
                if dtype == "bfloat16":  # against the body it replaced, in turns
                    row["old_body"] = "wgmma" if body == "decode" else "mma"
                    row["kernel_ms"], row["old_body_ms"], row["turns_ms"] = in_turns(
                        lambda: gmm.moe_gmm(x, w, sizes),
                        lambda: gmm.moe_gmm(x, w, sizes, body=row["old_body"]), flush, reps)
                else:
                    row["kernel_ms"] = cuda_time_ms(lambda: gmm.moe_gmm(x, w, sizes), flush,
                                                    reps=reps)
                row["plain_ms"] = cuda_time_ms(lambda: gmm.moe_gmm_plain(x, w, sizes), flush,
                                               reps=reps)
                lib, why = grouped_mm_call(x, w, sizes)
                row["library_note"] = why
                if lib is not None:
                    row["library_ms"] = cuda_time_ms(lib, flush, reps=reps)
                    row["library_err"] = float((lib().float() - gmm.moe_gmm_plain(x, w, sizes)
                                                .float()).abs().max())
                    del lib
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
                row["kernel_tb_per_s"] = nbytes / row["kernel_ms"] / 1e9
            rows.append(row)
            if timed:
                lib_txt = (f"{row['library_ms']:.4f} ms" if row["library_ms"] is not None
                           else f"- ({row['library_note']})")
                old = row["old_body_ms"]
                old_txt = (f" {row['old_body']} body={old:.4f} ms ({flops / old / 1e9:.1f} "
                           f"TFLOP/s)" if old is not None else "")
                times = (f"kernel={row['kernel_ms']:.4f} ms{old_txt} plain={row['plain_ms']:.4f} ms "
                         f"library={lib_txt} {row['kernel_tflops']:.1f} TFLOP/s "
                         f"{row['kernel_tb_per_s']:.2f} TB/s")
            else:
                times = "not timed"
            print(f"{model:20s} {dtype:8s} {body:8s} T={t:5d} E={e:3d} ({row['nonempty']} non-empty, "
                  f"largest {row['max_rows']}) {d_in:4d}->{d_out:4d} err={err:.2e} "
                  f"(oracle {oracle_err:.2e}) {times} "
                  f"bound={bound_ms:.4f} ms ({bound_by})", flush=True)
            del x, w
    return rows


# ---------------------------------------------------------------------------
# phase 2e: the flash backward kernel against its plain twin
# ---------------------------------------------------------------------------
# (model, B, Sq, Sk, H, KH, D, case, causal, window, q_offset, dtype): the
# training shapes of the zoo's attention: NeMo's (phase 6's), granite's
# MQA, whisper's bidirectional encoder, zamba2's windowed shared block,
# and NeMo's in fp32
BWD_SHAPES = [
    ("mistral-nemo-12b", 2, 2048, 2048, 32, 8, 128, "causal", True, None, 0, "bfloat16"),
    ("granite-20b", 2, 2048, 2048, 48, 1, 128, "causal", True, None, 0, "bfloat16"),
    ("whisper-medium", 2, 1500, 1500, 16, 16, 64, "encoder", False, None, 0, "bfloat16"),
    ("zamba2-7b", 2, 2048, 2048, 32, 32, 112, "window 4096", True, 4096, 0, "bfloat16"),
    ("mistral-nemo-12b", 2, 2048, 2048, 32, 8, 128, "causal", True, None, 0, "float32"),
]
BWD_MAIN = dict(model="mistral-nemo-12b", case="causal", dtype="bfloat16")
#: The wgmma body's kernels by name: δ, dK/dV, the split's sum, dQ
BWD_PASSES = ("bwd_delta", "bwd_dkdv", "bwd_split_sum", "bwd_dq")
#: The backward's operations per visible (query, key) pair and head, against
#: the forward's 4·D: S and dP (recomputed), dV, dK and dQ, about 2.5 times
#: the forward's (the second S and dP of the dQ pass are the price of no
#: atomics and are not counted in the least work).
BWD_FLOPS_PER_PAIR_D = 10


def grad_close(got, want, dtype):
    """Phase 2e's check of a gradient, scaled to each row (over the head
    dim) as phase 2 scales decode's.  bf16: the error within 2e-2 of the
    row's largest |want|, floored at 1e-3 of the tensor's largest (a row
    whose gradient cancels to ~0, such as a causal query's first, is held
    to the tensor's scale).  fp32: the reference's atol = rtol = 2e-5, the
    atol times the row's largest |want| where that passes 1 (dk and dv sum
    G·Sq terms, and fp32 rounds the sum to its own scale).  Returns (ok,
    max error, max error over its row's scale)."""
    tol = TOL[dtype]
    got, want = got.float(), want.float()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    row = rowmax.clamp(min=1e-3 * float(want.abs().max()))
    err = (got - want).abs()
    if dtype == "float32":
        ok = bool((err <= tol * rowmax.clamp(min=1.0) + tol * want.abs()).all())
    else:
        ok = bool((err <= tol * row).all())
    return ok, float(err.max()), float((err / row).max())


def flash_bwd_bound(b, sq, sk, h, kh, d, causal, window, q_offset, dtype, itemsize):
    """Least time (ms) of the backward: q, k, v, o, dO and lse read once,
    dq, dk, dv written once, against 10·H·D flops per visible pair."""
    nbytes = (4 * b * sq * h * d + 4 * b * sk * kh * d) * itemsize + 4 * b * h * sq
    flops = BWD_FLOPS_PER_PAIR_D * b * h * d * visible_pairs(sq, sk, causal, window, q_offset)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def sdpa_backward_ms(q, k, v, do, causal, window, q_offset, flush, reps):
    """The backward of ``scaled_dot_product_attention`` on the same inputs
    (timed only): ``torch.autograd.grad`` through SDPA, less SDPA's forward."""
    import torch

    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    lib = flash_library_call(*leaves, causal, window, q_offset)
    dos = do.transpose(1, 2).contiguous()

    def both():
        out = lib()
        torch.autograd.grad(out, leaves, dos)

    def forward_only():
        with torch.no_grad():
            lib()

    return cuda_time_ms(both, flush, reps=reps) - cuda_time_ms(forward_only, flush, reps=reps)


def flash_bwd_vs_plain():
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for model, b, sq, sk, h, kh, d, case, causal, window, q_offset, dtype in BWD_SHAPES:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        tdt = getattr(torch, dtype)
        q = torch.randn(b, sq, h, d, generator=gen, device=dev, dtype=tdt)
        k = torch.randn(b, sk, kh, d, generator=gen, device=dev, dtype=tdt)
        v = torch.randn(b, sk, kh, d, generator=gen, device=dev, dtype=tdt)
        do = torch.randn(b, sq, h, d, generator=gen, device=dev, dtype=tdt)
        # the training path's inputs: the forward kernel's output and LSE
        out, lse = fa._launch(q, k, v, causal, window, q_offset, None, True)
        _, plain_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        lse_err = float((lse - plain_lse).abs().nan_to_num(0.0).max())
        if lse_err > 1e-3 or not torch.equal(torch.isneginf(lse), torch.isneginf(plain_lse)):
            raise AssertionError(f"flash forward LSE {model} {dtype}: max err {lse_err}")
        body = fb.body_for(tdt, d)
        old_body = "mma" if body == "wgmma" and "mma" in fb.bodies_for(tdt, d) else None
        splits = fb.splits_for(b, sk, kh, h // kh, fb.sm_count(dev)) if body == "wgmma" else 1
        # the dK/dV pass's CTAs: the wgmma body's (key tile, KV head, split,
        # batch row), the older bodies' (key tile, KV head, batch row)
        ctas = (fb.dkdv_ctas(b, sk, kh, splits) if body == "wgmma"
                else -(-sk // (64 if dtype == "bfloat16" else 32)) * kh * b)
        want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
        errs = {}
        for which in (body, old_body) if old_body else (body,):
            got = fb.flash_attention_bwd(q, k, v, out, do, lse, body=which, **kw)
            torch.cuda.synchronize()
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                ok, err, rel = grad_close(x, w, dtype)
                if which == body:
                    errs[name] = dict(max_abs_err=err, max_row_rel_err=rel)
                if not ok:
                    raise AssertionError(f"flash backward ({which}) {model} {dtype} {case} "
                                         f"{name}: max err {err} ({rel:.3e} of its row) outside "
                                         f"{TOL[dtype]}")
            del got
        del want
        reps = 10 if sq * sk <= 2048 * 2048 else 5
        turns = old_body_ms = None
        if old_body:  # the new body against the one it replaces, in turns
            kernel_ms, old_body_ms, turns = in_turns(
                lambda: fb.flash_attention_bwd(q, k, v, out, do, lse, body=body, **kw),
                lambda: fb.flash_attention_bwd(q, k, v, out, do, lse, body=old_body, **kw),
                flush, reps)
        else:
            kernel_ms = cuda_time_ms(lambda: fb.flash_attention_bwd(q, k, v, out, do, lse, **kw),
                                     flush, reps=reps)
        passes = kernel_split(lambda: fb.flash_attention_bwd(q, k, v, out, do, lse, **kw),
                              BWD_PASSES) if body == "wgmma" else None
        plain_ms = cuda_time_ms(lambda: fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw),
                                flush, reps=3, warmup=1)
        library_ms = sdpa_backward_ms(q, k, v, do, causal, window, q_offset, flush, reps)
        # the forward with and without its LSE store, in turns
        with_lse_ms, without_lse_ms, lse_turns = in_turns(
            lambda: fa._launch(q, k, v, causal, window, q_offset, None, True),
            lambda: fa._launch(q, k, v, causal, window, q_offset, None, False), flush, reps)
        bound_ms, nbytes, flops, bound_by = flash_bwd_bound(b, sq, sk, h, kh, d, causal, window,
                                                            q_offset, dtype, q.element_size())
        row = dict(model=model, b=b, s=sq, sk=sk, h=h, kh=kh, d=d, case=case, dtype=dtype,
                   body=body, splits=splits, dkdv_ctas=ctas,
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   errors=errs, lse_err=lse_err, kernel_ms=kernel_ms, old_body=old_body,
                   old_body_ms=old_body_ms, turns_ms=turns, passes_ms=passes, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes, flops=flops,
                   bound_by=bound_by, kernel_tflops=flops / kernel_ms / 1e9,
                   forward_body=fa.body_for(tdt, d), forward_with_lse_ms=with_lse_ms,
                   forward_without_lse_ms=without_lse_ms, forward_lse_turns_ms=lse_turns)
        rows.append(row)
        err_txt = "/".join(f"{e['max_abs_err']:.2e}" for e in errs.values())
        old_txt = (f" ({old_body} {old_body_ms:.4f} ms in turns, "
                   f"{old_body_ms / kernel_ms:.2f}x; turns {turns})" if old_body else "")
        pass_txt = (" passes " + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()) + " ms;"
                    if passes else "")
        print(f"{model:18s} {dtype:8s} B={b} S={sq:5d}x{sk:5d} H={h:3d} KH={kh:3d} D={d:3d} "
              f"{case:12s} {body} splits={splits} dK/dV CTAs={ctas} err dq/dk/dv={err_txt} "
              f"kernel={kernel_ms:.4f} ms{old_txt}{pass_txt} plain={plain_ms:.4f} ms library "
              f"(SDPA backward)={library_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}) "
              f"{row['kernel_tflops']:.1f} TFLOP/s by 10·H·D a pair; forward "
              f"({row['forward_body']}) with LSE {with_lse_ms:.4f} ms, without "
              f"{without_lse_ms:.4f} ms; LSE err {lse_err:.1e}", flush=True)
        del q, k, v, do, out, lse, plain_lse
    return rows


# ---------------------------------------------------------------------------
# phase 2f: the SSD scan's and the grouped matmul's backward kernels
# ---------------------------------------------------------------------------
# (model, B, T, dtype, initial_state and dstate, timed): mamba2's and
# zamba2's training shapes in bf16 (B = 2, T = 2048), mamba2's in fp32, and
# a ragged T from a given initial state with a nonzero dstate; each on the
# body ``body_for`` picks, and bf16 on the fp32 body too (checked, and
# timed against the mma body in turns)
SSD_BWD_SHAPES = [
    ("mamba2-780m", PREFILL_B, PREFILL_S, "bfloat16", False, True),
    ("zamba2-7b", PREFILL_B, PREFILL_S, "bfloat16", False, True),
    ("mamba2-780m", PREFILL_B, PREFILL_S, "float32", False, True),
    ("mamba2-780m", PREFILL_B, 2000, "bfloat16", True, False),
]
SSD_BWD_MAIN = dict(model="mamba2-780m", t=PREFILL_S, dtype="bfloat16")
SSD_BWD_NAMES = ("dx", "ddt", "da", "db", "dc", "d_init")
# the kernels of each SSD backward body, as the profiler names them ((a'),
# (b'), (c'1), (c'2); the mma body's (a') is the forward's mma chunk-state
# kernel with OWN set)
SSD_BWD_KERNELS = {"fp32": ("ssd_bwd_chunk_state", "ssd_bwd_state_pass", "ssd_bwd_rows_kernel",
                            "ssd_bwd_cols_kernel"),
                   "mma": ("ssd_chunk_state_mma_kernel<true>", "ssd_bwd_state_pass",
                           "ssd_bwd_rows_mma", "ssd_bwd_cols_mma")}
# the grouped matmul's gradient at Qwen3-MoE's prefill rows (B·S·top_k =
# 32768 over 128 experts, both directions of its expert FFN)
GMM_BWD_MAIN = dict(model="qwen3 prefill", d_in=2048, d_out=768, dtype="bfloat16")
# dw with every row in one expert of 128: one tile's loop over all 32768
# rows (the sums are not split over rows), timed once
GMM_DW_SKEW = dict(model="one expert", expert=5)


def ssd_bwd_bound(b, t, h, p, n, chunk, dtype, itemsize, with_state):
    """Least time (ms) of the SSD gradient: x, b, c, dy and dt read once and
    the fp32 states entering each chunk but the first, which is zero unless
    an initial state is given (and then dstate read and the initial state's
    gradient written), dx, db, dc and d(dt) written once; against the
    flops of the distinct products per chunk of l steps and head:
    l(l+1)(3N + 2P) for C Bᵀ and dY Xᵀ on the pairs j ≤ i and the three
    products of the masked tiles (dc, dx, db), and 8lPN for the chunk's own
    S̄ term, C·S_inᵀ in dc, and the state terms of dx and db.  Returns (ms,
    bytes, flops, bound_by)."""
    nc = -(-t // chunk)
    nbytes = (b * t * h * ((3 * p + 4 * n) * itemsize + 8)
              + 4 * b * (nc - 1 + with_state) * h * p * n
              + 4 * h + (2 if with_state else 0) * 4 * b * h * p * n)
    lengths = [chunk] * (t // chunk) + ([t % chunk] if t % chunk else [])
    flops = b * h * sum(l * (l + 1) * (3 * n + 2 * p) + 8 * l * p * n for l in lengths)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def ssd_grad_close(got, want, dtype):
    """Phase 2f's check of an SSD gradient against the plain backward's
    (tests/test_torch_cuda.py's): tests/test_kernels.py's 5e-5 absolute
    and 5e-4 relative, the absolute part scaled to the tensor's largest
    |want|; a gradient the kernel writes in bf16 (dx, db, dc from bf16
    inputs) within 2e-2 of that largest value.  Returns (ok, max error)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    if dtype == "bfloat16":
        ok = bool((err <= 2e-2 * scale).all())
    else:
        ok = bool((err <= 5e-5 * scale + 5e-4 * want.abs()).all())
    return ok, float(err.max())


def gmm_dw_bound(t, d_in, d_out, e, dtype, itemsize):
    """Least time (ms) of the weight gradient: x and dy read once, every
    expert's dw written once (zeros for an empty group), the sizes read;
    2·T·d_in·d_out flops.  Returns (ms, bytes, flops, bound_by)."""
    nbytes = (t * d_in + t * d_out + e * d_in * d_out) * itemsize + 4 * e
    flops = 2 * t * d_in * d_out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def grouped_mm_grad_calls(x, w, dy, sizes):
    """``torch._grouped_mm`` computing dx = dy·w[e]ᵀ and dw[e] = x_eᵀ·dy_e on
    the same inputs (timed only; the port never calls it), each with the
    first layout it takes, or the reason there is none."""
    import torch

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return {k: (None, "this PyTorch has no torch._grouped_mm") for k in ("dx", "dw")}
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    wt = w.transpose(1, 2)
    tries = {"dx": [(dy, wt), (dy, wt.contiguous())],
             "dw": [(x.t(), dy), (x.t().contiguous(), dy), (x.t(), dy.t().contiguous().t())]}
    out = {}
    for what, pairs in tries.items():
        errors = []
        for a, b in pairs:
            try:
                fn(a, b, offs=offs)
                torch.cuda.synchronize()
                out[what] = ((lambda a=a, b=b: fn(a, b, offs=offs)), None)
                break
            except (RuntimeError, TypeError, ValueError) as e:
                errors.append(str(e).splitlines()[0][:160])
        else:
            out[what] = (None, "torch._grouped_mm refused these inputs: " + " | ".join(errors))
    return out


def ssd_bwd_vs_plain(flush, gen):
    """Phase 2f's SSD rows: the backward kernel against
    ``ssd_scan_bwd_plain`` on the forward kernel's saved states."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssd_scan_bwd as sb

    dev = flush.device
    rows = []
    for model, b, t, dtype, with_state, timed in SSD_BWD_SHAPES:
        cfg = ARCHS[model]
        h, p, n, chunk = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        tdt = getattr(torch, dtype)
        x = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(tdt)
        dt = F.softplus(torch.randn(b, t, h, generator=gen, device=dev))
        a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
        bb = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(tdt)
        cc = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(tdt)
        dy = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(tdt)
        init = torch.randn(b, h, p, n, generator=gen, device=dev) if with_state else None
        dstate = torch.randn(b, h, p, n, generator=gen, device=dev) if with_state else None
        # the training path's input: the states the forward kernel leaves
        _, _, states = ssd._launch(x, dt, a, bb, cc, chunk, init, None, True)
        args = (x, dt, a, bb, cc, init, states, dy, dstate)
        body = sb.body_for(tdt)
        old_body = "fp32" if body != "fp32" else None
        want = sb.ssd_scan_bwd_plain(*args, chunk=chunk)
        errs, old_errs = {}, {}
        for which, errors in ((body, errs), (old_body, old_errs)):
            if which is None:
                continue
            got = sb.ssd_scan_bwd(*args, chunk=chunk, body=which)
            torch.cuda.synchronize()
            for name, g, w in zip(SSD_BWD_NAMES, got, want):
                if w is None:
                    continue
                ok, err = ssd_grad_close(g, w, dtype if name in ("dx", "db", "dc") else "float32")
                errors[name] = err
                if not ok:
                    raise AssertionError(f"ssd backward ({which}) {model} {dtype} B={b} T={t} "
                                         f"{name}: max err {err} of {float(w.abs().max())}")
            del got
        del want
        bound_ms, nbytes, flops, bound_by = ssd_bwd_bound(b, t, h, p, n, chunk, dtype,
                                                          x.element_size(), with_state)
        row = dict(model=model, b=b, t=t, h=h, p=p, n=n, chunk=chunk, dtype=dtype,
                   body=body, old_body=old_body, old_body_ms=None, old_body_errors=old_errs,
                   initial_state=with_state, max_abs_err=max(errs.values()),
                   errors=errs, bound_ms=bound_ms, bytes=nbytes, flops=flops,
                   bound_by=bound_by, library_ms=None, ctas=b * h * -(-t // chunk))
        if timed:
            run = lambda: sb.ssd_scan_bwd(*args, chunk=chunk, body=body)  # noqa: E731
            if old_body:  # the mma body against the fp32 body, in turns
                row["kernel_ms"], row["old_body_ms"], row["turns_ms"] = in_turns(
                    run, lambda: sb.ssd_scan_bwd(*args, chunk=chunk, body=old_body), flush, 25)
            else:
                row["kernel_ms"] = cuda_time_ms(run, flush)
            row["plain_ms"] = cuda_time_ms(lambda: sb.ssd_scan_bwd_plain(*args, chunk=chunk),
                                           flush, reps=10, warmup=1)
            row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
            # the kernel's four launches: (a'), (b'), (c'1), (c'2)
            row["by_kernel"] = kernel_split(run, SSD_BWD_KERNELS[body])
        rows.append(row)
        err_txt = " ".join(f"{k}={v:.2e}" for k, v in errs.items())
        old_txt = (f" ({old_body} {row['old_body_ms']:.4f} ms in turns)"
                   if row["old_body_ms"] is not None else "")
        times = (f"kernel={row['kernel_ms']:.4f} ms{old_txt} plain={row['plain_ms']:.4f} ms "
                 f"{row['kernel_tflops']:.2f} TFLOP/s; by launch {row['by_kernel']}"
                 if timed else "not timed")
        print(f"{model:18s} {dtype:8s} {body:4s} B={b} T={t:5d} H={h} P={p} N={n} L={chunk}"
              f"{' from a given state, dstate' if with_state else ''} err {err_txt} {times} "
              f"library=- bound={bound_ms:.4f} ms ({bound_by})", flush=True)
        del x, dt, bb, cc, dy, states, args
    return rows


def gmm_bwd_vs_plain(flush, gen):
    """Phase 2f's grouped-matmul rows: dx (the forward kernel, w read as its
    transpose) and dw against their plain twins at Qwen3-MoE's prefill in
    both directions (bf16; 2048 -> 768 in fp32 once), over empty groups, and
    dw with every row in one expert (timed once); the bodies ``body_for``
    and ``dw_bodies_for`` pick, each timed against the mma body in turns."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_bwd as gb

    dev = flush.device
    qwen = ARCHS["qwen3-moe-30b-a3b"]
    sizes = routed_sizes(gen, PREFILL_B * PREFILL_S, qwen.d_model, qwen.n_experts, qwen.top_k)
    empty = torch.zeros(128, dtype=torch.int32, device=dev)
    empty[[3, 40, 41, 99, 127]] = torch.tensor([1000, 1, 2000, 95, 1000], dtype=torch.int32,
                                               device=dev)
    skew = torch.zeros(qwen.n_experts, dtype=torch.int32, device=dev)
    skew[GMM_DW_SKEW["expert"]] = PREFILL_B * PREFILL_S * qwen.top_k
    d, f = qwen.d_model, qwen.d_ff_expert
    both = ("dx", "dw")
    # (model, d_in, d_out, sizes, dtype, what is checked, what is timed)
    cases = [("qwen3 prefill", d, f, sizes, "bfloat16", both, both),
             ("qwen3 prefill", f, d, sizes, "bfloat16", both, both),
             ("qwen3 prefill", d, f, sizes, "float32", both, both),
             ("empty groups", d, f, empty, "bfloat16", both, ()),
             (GMM_DW_SKEW["model"], d, f, skew, "bfloat16", ("dw",), ("dw",))]
    rows = []
    for model, d_in, d_out, gs, dtype, checked, timed_set in cases:
        t, e = int(gs.sum()), gs.numel()
        host_sizes = gs.tolist()
        tdt = getattr(torch, dtype)
        x = torch.randn(t, d_in, generator=gen, device=dev, dtype=tdt)
        w = (torch.randn(e, d_in, d_out, generator=gen, device=dev) * 0.02).to(tdt)
        dy = torch.randn(t, d_out, generator=gen, device=dev, dtype=tdt)
        lib = grouped_mm_grad_calls(x, w, dy, gs) if timed_set else {}
        for what in checked:
            timed = what in timed_set
            if what == "dx":
                run = lambda: gb.moe_gmm_dx(dy, w, gs)  # noqa: E731
                plain = lambda: gb.moe_gmm_dx_plain(dy, w, gs)  # noqa: E731
                body = gmm.body_for(tdt, d_out, d_in, n_experts=e)
                old_body = "mma" if body == "wgmma" else None
                bound = gmm_bound(t, d_out, d_in, host_sizes, dtype, x.element_size())
            else:
                run = lambda: gb.moe_gmm_dw(x, dy, gs, e)  # noqa: E731
                plain = lambda: gb.moe_gmm_dw_plain(x, dy, gs, e)  # noqa: E731
                body = gb.dw_bodies_for(tdt, d_in, d_out, True, e)[0]
                old_body = "mma" if body == "wgmma" else None
                bound = gmm_dw_bound(t, d_in, d_out, e, dtype, x.element_size())
            got = run().float()
            torch.cuda.synchronize()
            want = plain().float()
            err = float((got - want).abs().max())
            tol = GMM_TOL[dtype]
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(f"gmm {what} {model} {dtype} T={t} {d_in}->{d_out} E={e}: "
                                     f"max err {err} outside {tol}")
            if what == "dw":
                zero = [i for i, s in enumerate(host_sizes) if s == 0 and i != e - 1]
                if got[zero].any():
                    raise AssertionError(f"gmm dw {model}: an empty group's dw is not zero")
            del got, want
            bound_ms, nbytes, flops, bound_by = bound
            row = dict(kernel=f"moe_gmm_{what}", model=model, t=t, e=e, d_in=d_in, d_out=d_out,
                       dtype=dtype, body=body, old_body=old_body, old_body_ms=None,
                       nonempty=sum(1 for s in host_sizes if s > 0), max_abs_err=err,
                       bound_ms=bound_ms, bytes=nbytes, flops=flops, bound_by=bound_by,
                       library_ms=None)
            if timed:
                reps = 25 if dtype == "bfloat16" else 10
                if old_body:  # the wgmma body against the mma body, in turns
                    old = ((lambda: gb.moe_gmm_dx(dy, w, gs, body=old_body)) if what == "dx"
                           else (lambda: gb.moe_gmm_dw(x, dy, gs, e, body=old_body)))
                    row["kernel_ms"], row["old_body_ms"], row["turns_ms"] = in_turns(
                        run, old, flush, reps)
                else:
                    row["kernel_ms"] = cuda_time_ms(run, flush, reps=reps)
                row["plain_ms"] = cuda_time_ms(plain, flush, reps=10)
                call, why = lib[what]
                row["library_note"] = why
                if call is not None:
                    row["library_ms"] = cuda_time_ms(call, flush, reps=reps)
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
                row["kernel_tb_per_s"] = nbytes / row["kernel_ms"] / 1e9
            rows.append(row)
            if timed:
                lib_txt = (f"{row['library_ms']:.4f} ms" if row["library_ms"] is not None
                           else f"- ({row['library_note']})")
                old_txt = (f" ({old_body} {row['old_body_ms']:.4f} ms in turns)" if old_body
                           else "")
                times = (f"kernel={row['kernel_ms']:.4f} ms{old_txt} plain={row['plain_ms']:.4f} "
                         f"ms library={lib_txt} {row['kernel_tflops']:.1f} TFLOP/s "
                         f"{row['kernel_tb_per_s']:.2f} TB/s")
            else:
                times = "not timed"
            print(f"{what} {model:14s} {dtype:8s} {body:8s} T={t:5d} E={e:3d} ({row['nonempty']} "
                  f"non-empty) {d_in:4d}->{d_out:4d} err={err:.2e} {times} "
                  f"bound={bound_ms:.4f} ms ({bound_by})", flush=True)
        del x, w, dy, lib
    return rows


def bwd_kernels_vs_plain():
    """Phase 2f: the SSD scan's backward kernel and the grouped matmul's dx
    and dw against their plain backwards at the training shapes."""
    import torch

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    return dict(ssd=ssd_bwd_vs_plain(flush, gen), gmm=gmm_bwd_vs_plain(flush, gen))


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def serve_full_width():
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.examples import serve_cluster as ex
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving import HostedModel

    dev = torch.device("cuda")
    granite_layers = 12
    cfgs = {
        ex.DRAFT: ARCHS["mamba2-780m"],
        ex.VERIFY: ARCHS["mistral-nemo-12b"],
        ex.REFINE: dataclasses.replace(ARCHS["granite-20b"], n_layers=granite_layers),
    }
    print(f"granite-20b depth cut: {ARCHS['granite-20b'].n_layers} -> {granite_layers} "
          "layers (the whole model is 56 GB and does not fit beside NeMo on one card)")
    t0 = time.perf_counter()
    hosted = [HostedModel(mid, cfg,
                          init_params(cfg, torch.Generator(device=dev).manual_seed(mid), dev),
                          dev)
              for mid, cfg in cfgs.items()]
    torch.cuda.synchronize()
    print(f"weights initialised in {time.perf_counter() - t0:.1f} s")
    for h in hosted:
        print(f"  model {h.model_id}: {h.cfg.name} ({h.cfg.n_layers} layers) "
              f"{h.size_bytes / 1e9:.2f} GB")

    # every hosted model's logits are finite after a short prefill
    for h in hosted:
        cache = init_cache(h.cfg, 2, 9, device=dev)
        for tok in range(1, 9):
            logits, cache = decode_step(h.params, cache, torch.full((2,), tok, device=dev), h.cfg)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{h.cfg.name}: non-finite logits")

    decode_tokens, prompt_len = 6, 64
    requests = ex.make_requests(n=10, prompt_len=prompt_len)
    spec, summ = ex.build_pipelines()

    # what the requests ran: prefill + decode steps of each task, times its layers
    expected, steps, by_model = 0, {}, {}
    for kind, _ in requests:
        dfg = spec if kind == 0 else summ
        for tid, task in dfg.tasks.items():
            n_in = prompt_len if not dfg.preds[tid] else decode_tokens * len(dfg.preds[tid])
            cfg = cfgs[task.model_id]
            steps[cfg.name] = steps.get(cfg.name, 0) + n_in + decode_tokens
            if cfg.arch_type == "dense":
                expected += cfg.n_layers * (n_in + decode_tokens)
                by_model[cfg.name] = by_model.get(cfg.name, 0) + cfg.n_layers * (n_in + decode_tokens)

    # the main path: the serving run, every decode step a graph replay
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc, wall = serve_requests(hosted, requests, decode_tokens)
    warm = da.launches  # eager launches: one warm-up step before each capture
    replayed = sc.engine.replayed_launches["decode_attention"]
    launches = warm + replayed
    launches_by_body = bodies(sc.engine)["decode_attention"]
    tokens_out = sum(o.size for r in sc.results for o in r.outputs.values())
    graphs = graph_rows(sc.engine)
    want_warm = sum(g["launches"]["decode_attention"] for g in graphs)
    for r in sc.results:
        print(f"  job {r.job_id} {r.dfg_name:20s} assign={r.assignment} "
              f"wall={r.latency_s:.3f} s")
    peak = torch.cuda.max_memory_allocated()
    summary = dict(
        requests=len(sc.results), wall_s=wall, decoded_tokens=tokens_out,
        decoded_tokens_per_s=tokens_out / wall, steps=steps,
        cache_hit_rate=sc.cache_hit_rate(), workers_used=sc.workers_used(),
        max_memory_allocated=peak, launches=launches, expected_launches=expected,
        replayed_launches=replayed, warmup_launches=warm,
        launches_by_body=launches_by_body, launches_by_model=by_model,
        granite_layers=granite_layers, graphs=graphs,
        latencies_s=[r.latency_s for r in sc.results],
        assignments=[r.assignment for r in sc.results],
    )
    print(f"decoded tokens/s (graphs): {tokens_out / wall:.1f} ({tokens_out} tokens in "
          f"{wall:.2f} s)")
    print(f"cache hit rate: {sc.cache_hit_rate():.3f}; workers used: {sc.workers_used()}")
    print(f"torch.cuda.max_memory_allocated: {peak / 1e9:.2f} GB")
    print(f"decode_attention launches: {launches} = {replayed} replayed (expected {expected}; "
          f"by model {by_model}) + {warm} warm-up (expected {want_warm}); by body "
          f"{launches_by_body}")
    if replayed != expected or warm != want_warm or expected == 0:
        raise AssertionError(f"decode_attention launched {replayed} times in replays and {warm} "
                             f"in warm-ups, expected {expected} and {want_warm}")
    if launches_by_body != {"split": launches}:
        raise AssertionError(f"decode_attention launches by body {launches_by_body}, "
                             "expected every one on the split body")

    # the same requests on a fresh cluster whose engine runs each task eagerly
    eager, eager_wall = serve_requests(hosted, requests, decode_tokens, eager=True)
    eager_launches = da.launches
    same = dict(assignments=[r.assignment for r in eager.results] == summary["assignments"],
                cache_hit_rate=eager.cache_hit_rate() == sc.cache_hit_rate(),
                tokens=all((a.outputs[t] == b.outputs[t]).all()
                           for a, b in zip(sc.results, eager.results) for t in b.outputs))
    summary.update(eager_wall_s=eager_wall, eager_decoded_tokens_per_s=tokens_out / eager_wall,
                   eager_launches=eager_launches, graph_vs_eager_equal=same)
    print(f"decoded tokens/s (eager): {tokens_out / eager_wall:.1f} ({tokens_out} tokens in "
          f"{eager_wall:.2f} s); decode_attention launches {eager_launches}")
    print(f"graphs against eager: equal {same}")
    if not all(same.values()) or eager_launches != expected:
        raise AssertionError(f"the eager run differs from the graphed one ({same}; launches "
                             f"{eager_launches})")
    SHARED.update(requests=requests, serve_wall=wall, expected_launches=expected)

    # each model's decode step, graph against eager, in turns, and the
    # device's busy share of each under the profiler
    prompt_np = requests[0][1]
    summary["step_graph_vs_eager"] = {
        h.cfg.name: graph_vs_eager(sc.engine, h.model_id, prompt_np) for h in hosted}

    # NeMo after a 64-token teacher-forced prefill: the kernel path against
    # the plain paths.  "ref_grouped" does the kernel's arithmetic in PyTorch
    # (fp32 scores, softmax and weighted sum); "ref" mirrors the JAX oracle,
    # which rounds scores and probabilities to bf16 on the way.  The kernel
    # path is held to the plain fp32 path within LOGIT_BOUND of the largest
    # logit, with equal argmax tokens, after the prefill and for one step
    # from one shared cache; the distance between the two plain paths is
    # printed beside it as the yardstick.
    nemo = next(h for h in hosted if h.model_id == ex.VERIFY)
    prompt = torch.as_tensor(requests[0][1], device=dev)
    SHARED.update(hosted=hosted, nemo_prompt=prompt)
    paths = ("auto", "ref_grouped", "ref")
    logits, caches, step_ms = {}, {}, {p: [] for p in paths}
    for impl in paths + paths[::-1]:  # in turns, each path twice
        cache = init_cache(nemo.cfg, 2, prompt_len + 2, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(prompt_len):
            out, cache = decode_step(nemo.params, cache, prompt[:, i], nemo.cfg, impl=impl)
        torch.cuda.synchronize()
        step_ms[impl].append((time.perf_counter() - t1) / prompt_len * 1e3)
        logits[impl], caches[impl] = out.float(), cache
    SHARED["nemo_decode_logits"] = logits["auto"]
    nxt = logits["auto"].argmax(-1)
    one_step = {
        impl: decode_step(nemo.params, {k: v.clone() for k, v in caches["auto"].items()},
                          nxt, nemo.cfg, impl=impl)[0].float()
        for impl in paths
    }
    if not all(bool(torch.isfinite(x).all()) for x in [*logits.values(), *one_step.values()]):
        raise AssertionError("non-finite NeMo logits")

    def compare(what, a, b, x, y):
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        same = bool(torch.equal(x.argmax(-1), y.argmax(-1)))
        print(f"NeMo {what}, {a} vs {b}: max |diff| = {err:.4e}, max |logit| = {scale:.4e}, "
              f"ratio {err / scale:.3e}; argmax equal: {same}")
        return dict(max_abs_diff=err, max_abs_logit=scale, ratio=err / scale, argmax_equal=same)

    pairs = (("auto", "ref_grouped"), ("auto", "ref"), ("ref_grouped", "ref"))
    prefill = {f"{a}|{b}": compare(f"logits after {prompt_len}-token prefill", a, b,
                                   logits[a], logits[b]) for a, b in pairs}
    step = {f"{a}|{b}": compare("logits of one step from one cache", a, b,
                                one_step[a], one_step[b]) for a, b in pairs}
    for impl in paths:
        print(f"NeMo decode step (B=2, bf16), {impl} path: {step_ms[impl]} ms")
    summary.update(nemo_prefill=prefill, nemo_one_step=step, nemo_step_ms=step_ms,
                   nemo_profile=profile_decode(nemo, prompt, dev))
    for name, c in (("prefill", prefill["auto|ref_grouped"]),
                    ("one step", step["auto|ref_grouped"])):
        if c["ratio"] > LOGIT_BOUND or not c["argmax_equal"]:
            raise AssertionError(f"NeMo logits ({name}): kernel path and plain path disagree")
    summary["long_context"] = long_context_decode(nemo, dev, compare)
    return summary


def serve_requests(hosted, requests, decode_tokens, eager=False, **planes):
    """The serving run of phases 3 and 3h: a 3-worker cluster (80 GB each)
    on the card serving ``requests`` through the serve example's two
    pipelines, with the cluster options ``planes``; with ``eager``, its
    engine runs each task through ``eager_task`` instead of its graphs.
    The kernel counts are set to 0 just before the requests.  Returns the
    cluster and the wall time of the requests."""
    import torch
    from repro_torch.core import ClusterSpec, GB
    from repro_torch.examples import serve_cluster as ex
    from repro_torch.serving import ServingCluster

    sc = ServingCluster(ClusterSpec(n_workers=3, gpu_capacity_bytes=80 * GB), hosted,
                        scheduler="navigator", decode_tokens=decode_tokens, **planes,
                        device=torch.device("cuda"))
    track(sc.engine)
    if eager:
        sc.engine.run_task = functools.partial(eager_task, sc.engine)
    spec, summ = ex.build_pipelines()
    sc.register_pipeline(spec)
    sc.register_pipeline(summ)
    torch.cuda.synchronize()
    counts_zeroed(sc.engine)
    t0 = time.perf_counter()
    for i, (kind, prompt) in enumerate(requests):
        dfg, entry = (spec, "draft") if kind == 0 else (summ, "perceive")
        sc.submit(dfg, {entry: prompt}, origin=i % 3)
    return sc, time.perf_counter() - t0


def track(engine):
    """Keep ``engine`` for ``release_models``."""
    ENGINES.append(engine)
    return engine


def graph_rows(engine):
    """Each graph of ``engine``: its key, capture time, pool bytes, replays
    and launches per replay (printed)."""
    rows = []
    for (mid, b, capacity), g in engine.graphs.items():
        rows.append(dict(model=engine.models[mid].cfg.name, b=b, capacity=capacity,
                         capture_s=g.capture_s, pool_bytes=g.pool_bytes, replays=g.replays,
                         launches=g.launches))
        print(f"  graph {engine.models[mid].cfg.name} B={b} capacity={capacity}: capture "
              f"{g.capture_s * 1e3:.1f} ms, pool {g.pool_bytes / 1e6:.1f} MB, "
              f"{g.replays} replays", flush=True)
    return rows


def eager_loop(engine, mid, prompt):
    """``engine``'s task without its graphs: the loop ``run_task`` ran
    before the engine captured its decode step (a fresh cache, eager
    ``decode_step`` calls with the engine's impl and MoE dispatch).
    Returns (tokens (B, decode_tokens) int32, wall seconds, the last
    step's logits)."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, init_cache

    hosted = engine.models[mid]
    t0 = time.perf_counter()
    b, s = prompt.shape
    kw = dict(impl=engine.impl, moe_dispatch=engine.moe_dispatch)
    with torch.inference_mode():
        cache = init_cache(hosted.cfg, b, s + engine.decode_tokens + 1, device=engine.device)
        toks = torch.as_tensor(prompt, device=engine.device)
        for i in range(s):
            logits, cache = decode_step(hosted.params, cache, toks[:, i], hosted.cfg, **kw)
        nxt, out = torch.argmax(logits, dim=-1), []
        for _ in range(engine.decode_tokens):
            out.append(nxt)
            logits, cache = decode_step(hosted.params, cache, nxt, hosted.cfg, **kw)
            nxt = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        tokens = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
    return tokens, time.perf_counter() - t0, logits


def eager_task(engine, mid, prompt):
    """``eager_loop`` as ``run_task`` returns: (tokens, wall seconds)."""
    return eager_loop(engine, mid, prompt)[:2]


def graph_vs_eager(engine, mid, prompt):
    """One task of model ``mid`` over the first ``TURN_PROMPT`` tokens of
    ``prompt`` through ``engine``'s graph (captured by one untimed task)
    and through ``eager_loop``, in turns (graph, eager, eager, graph): the
    ms per decode step of each, the tokens held equal, the last step's
    logits compared (the largest difference printed); then one task of
    each under the profiler over the first ``PROFILE_PROMPT`` tokens,
    with the device's busy share."""
    import numpy as np

    name = engine.models[mid].cfg.name
    short = prompt[:, :TURN_PROMPT]
    steps = short.shape[1] + engine.decode_tokens
    want, _ = engine.run_task(mid, short)
    g = engine.graphs[(mid, short.shape[0], steps + 1)]
    turns, equal, logits = [], True, {}
    for run in ("graph", "eager", "eager", "graph"):
        if run == "graph":
            got, wall = engine.run_task(mid, short)
            logits[run] = g.logits.float().clone()
        else:
            got, wall, last = eager_loop(engine, mid, short)
            logits[run] = last.float()
        turns.append(wall / steps * 1e3)
        equal = equal and bool(np.array_equal(got, want))
    diff = float((logits["graph"] - logits["eager"]).abs().max())
    prof = prompt[:, :PROFILE_PROMPT]
    engine.run_task(mid, prof)  # captures at the profile's capacity, untimed
    profiles = {run: profile_task(fn, engine, mid, prof, f"{name} task ({run})")
                for run, fn in (("graph", engine.run_task),
                                ("eager", functools.partial(eager_task, engine)))}
    print(f"{name} decode step (B={short.shape[0]}, {steps} steps a task), in turns (graph, "
          f"eager, eager, graph): {', '.join(f'{t:.2f}' for t in turns)} ms; tokens equal "
          f"{equal}; last logits graph vs eager max |diff| {diff:.3e}", flush=True)
    if not equal:
        raise AssertionError(f"{name}: graph and eager tokens differ")
    return dict(steps=steps, turns_ms=turns, graph_ms=[turns[0], turns[3]],
                eager_ms=[turns[1], turns[2]], tokens_equal=equal, logits_max_abs_diff=diff,
                profile=profiles)


def replay_records(events):
    """The device records of each graph replay among the profiler's
    ``events``, by the correlation id of its ``cudaGraphLaunch`` call
    (CUPTI gives every kernel of a replay that id): (records, main
    decode-attention kernels)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    rows = {e.correlation_id(): [0, 0] for e in events
            if e.device_type() != cuda and e.name().startswith("cudaGraphLaunch")}
    for e in events:
        row = rows.get(e.correlation_id()) if e.device_type() == cuda else None
        if row is not None:
            row[0] += 1
            row[1] += any(k in e.name() for k in DECODE_MAIN)
    return {cid: tuple(row) for cid, row in rows.items()}


#: Tiny kernels launched at the start of each profile of a task, before the
#: task. The profiler loses the first device records of a session, more of
#: them the longer the process has run (on the H100: none in its first
#: minute or two, then one more every few seconds), and these take the loss.
BALLAST = 4096
#: Profiles of one task taken at most, the ballast four times larger each
#: time, before ``profile_task`` gives up on a complete record of the task.
PROFILE_ATTEMPTS = 3


def profiled(fn, what, prepare=None, complete=None):
    """One call of ``fn()`` under the profiler, opened with ``BALLAST``
    tiny kernels and a synchronise: the profiler loses the first device
    records of a profile, and only the records after the ballast count.
    The profile is complete where some of the ballast's records are left
    (the loss ended before the call) and ``complete(events)`` holds, where
    given; an incomplete one is taken again with four times the ballast,
    up to ``PROFILE_ATTEMPTS`` times, ``prepare()`` run before each (it
    puts back what ``fn`` changes).  Returns (the device records of the
    call, its wall ms ending in a synchronise, what the attempts took:
    attempts, ballast, ballast_lost, incomplete)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    pad = torch.zeros(1, device="cuda")
    ballast, lost = BALLAST, []
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ballast):
                pad.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.profiler.kineto_results.events()
        # the ballast's synchronise is the session's first
        start = min(e.correlation_id() for e in events
                    if e.device_type() != cuda and e.name().startswith("cudaDeviceSynchronize"))
        kept = sum(e.device_type() == cuda and e.correlation_id() < start for e in events)
        task = [e for e in events if e.device_type() == cuda and e.correlation_id() > start]
        why = "" if kept else f"none of the ballast's {ballast} records left"
        if not why and complete is not None:
            why = complete(events)
        if not why:
            break
        lost.append(dict(attempt=attempt, ballast=ballast, ballast_kept=kept, why=why))
        print(f"profile of {what}, attempt {attempt}: incomplete ({why})", flush=True)
        ballast *= 4
    else:
        raise AssertionError(f"{what}: no complete profile in {PROFILE_ATTEMPTS}: {lost}")
    return task, wall_ms, dict(attempts=attempt, ballast=ballast, ballast_lost=ballast - kept,
                               incomplete=lost)


def by_kernel(task):
    """(device ms, calls) of each kernel name among a profile's records,
    the most device time first."""
    rows = collections.defaultdict(lambda: [0.0, 0])
    for e in task:
        rows[e.name()][0] += e.duration_ns() / 1e6
        rows[e.name()][1] += 1
    return sorted(((ms, n, k) for k, (ms, n) in rows.items()), reverse=True)


def profile_task(fn, engine, mid, prompt, what):
    """Device time of one task ``fn(mid, prompt)`` (the profiler's device
    records, :func:`profiled`) against its wall time, and the
    decode-attention kernels the card ran, by name: for a graphed task
    their main kernels must equal the launches the engine counts for its
    replays.  A graphed task's profile is complete where every replay is
    listed with as many records as the others (they run one graph)."""
    rows = {}

    def complete(events):
        rows.clear()
        rows.update(replay_records(events) if engine.replays else {})
        sizes = collections.Counter(n for n, _ in rows.values())
        if not engine.replays or (len(rows) == engine.replays and len(sizes) == 1):
            return ""
        return (f"{len(rows)} of {engine.replays} replays listed; replays by their record "
                f"count {dict(sizes)}")

    task, wall_ms, took = profiled(lambda: fn(mid, prompt), f"one {what}",
                                      prepare=engine.reset_counts, complete=complete)
    device_ms = sum(e.duration_ns() for e in task) / 1e6
    by_name = {k: sum(k in e.name() for e in task) for k in DECODE_KERNELS}
    main = sum(by_name[k] for k in DECODE_MAIN)
    replayed = engine.replayed_launches["decode_attention"]
    print(f"profile of one {what}: device busy {device_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"({100 * device_ms / wall_ms:.1f} %), {len(task)} kernels; decode-attention "
          f"kernels {by_name}, the engine's replayed launches {replayed}; the profiler lost "
          f"{took['ballast_lost']} of the ballast's {took['ballast']} records", flush=True)
    if engine.replays and main != replayed:
        raise AssertionError(f"{what}: the card ran {main} decode-attention kernels, the "
                             f"engine counted {replayed} launches in its replays")
    out = dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
               kernels=len(task), decode_kernels=by_name, replayed_launches=replayed,
               replays=engine.replays, **took)
    if engine.replays:
        sizes = collections.Counter(n for n, _ in rows.values())
        per_replay = collections.Counter(d for _, d in rows.values())
        out["records_per_replay"] = next(iter(sizes))
        print(f"  {len(rows)} replays of {out['records_per_replay']} device records each; "
              f"decode-attention kernels a replay {dict(per_replay)}", flush=True)
        if sum(d * n for d, n in per_replay.items()) != replayed:
            raise AssertionError(f"{what}: the replays' own records hold "
                                 f"{dict(per_replay)} decode-attention kernels")
    return out


LONG_CONTEXT = 32768  # cache slots of the long-context decode


def long_context_decode(nemo, dev, compare, steps=4):
    """Four NeMo decode steps at B = 2 from a cache of ``LONG_CONTEXT``
    slots filled with seeded bf16 K/V, ``pos`` = LONG_CONTEXT - steps: the
    kernel path against the plain path (within LOGIT_BOUND, equal argmax),
    the step time of each, and a profile of the kernel path's steps."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import decode_step, init_cache

    gen = torch.Generator(device=dev).manual_seed(7)
    cache = init_cache(nemo.cfg, 2, LONG_CONTEXT, device=dev)
    for name in ("k", "v"):
        cache[name].normal_(generator=gen)
    tokens = torch.randint(0, nemo.cfg.vocab, (steps, 2), generator=gen, device=dev)
    start = LONG_CONTEXT - steps
    cache_gb = (cache["k"].nbytes + cache["v"].nbytes) / 1e9
    print(f"long-context decode: NeMo ({nemo.cfg.n_layers} layers), B=2, cache of "
          f"{LONG_CONTEXT} slots ({cache_gb:.2f} GB), pos {start}", flush=True)
    logits, step_ms = {}, {}
    launches = by_body = None
    # each path rewrites the slots it reads past pos, so both start alike
    for impl in ("auto", "ref_grouped", "ref_grouped", "auto"):
        cache["pos"].fill_(start)
        if impl == "auto":
            da.launches = 0
            da.launches_by_body.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            out, cache = decode_step(nemo.params, cache, tokens[i], nemo.cfg, impl=impl)
        torch.cuda.synchronize()
        step_ms.setdefault(impl, []).append((time.perf_counter() - t0) / steps * 1e3)
        logits[impl] = out.float()
        if impl == "auto":
            launches, by_body = da.launches, dict(da.launches_by_body)
    if not all(bool(torch.isfinite(x).all()) for x in logits.values()):
        raise AssertionError("long-context decode: non-finite logits")
    calls = checked_attention(nemo.params, nemo.cfg, cache, tokens, start)
    cmp = compare(f"logits after {steps} steps from a {LONG_CONTEXT}-slot cache", "auto",
                  "ref_grouped", logits["auto"], logits["ref_grouped"])
    for impl in ("auto", "ref_grouped"):
        print(f"long-context NeMo decode step (B=2, bf16), {impl} path: {step_ms[impl]} ms")
    cache["pos"].fill_(start)
    profile = profile_decode(nemo, tokens.t().contiguous(), dev, steps=steps, cache=cache)
    out = dict(slots=LONG_CONTEXT, pos=start, steps=steps, cache_gb=cache_gb, step_ms=step_ms,
               kernel_vs_plain=cmp, attention_calls=calls, launches=launches,
               launches_by_body=by_body, profile=profile)
    del cache
    want = nemo.cfg.n_layers * steps
    if launches != want or by_body != {"split": want}:
        raise AssertionError(f"long-context decode launched {launches} ({by_body}), "
                             f"expected {want} on the split body")
    if cmp["ratio"] > LOGIT_BOUND or not cmp["argmax_equal"]:
        raise AssertionError("long-context decode: kernel path and plain path disagree")
    if calls["outside"] or calls["calls"] != want:
        raise AssertionError(f"long-context decode: {calls['outside']} of {calls['calls']} "
                             f"attention calls (expected {want}) outside phase 2's check")
    return out


def checked_attention(params, cfg, cache, tokens, start, what="long-context"):
    """The kernel path's steps once more from ``start``, with every decode
    attention call held against the plain version on its own inputs by
    phase 2's check (``decode_close``): the logits alone cannot show a
    wrong split, since over 32,768 random slots each layer's attention
    output is small beside the residual stream.  Returns the calls, how
    many fell outside, and the largest error absolute and relative to the
    largest |plain| of its call."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import decode_step

    real = da.decode_attention
    seen = dict(calls=0, outside=0, max_abs_err=0.0, max_rel_err=0.0)

    def checked(q, k, v, n, **kw):
        out = real(q, k, v, n, **kw)
        got, want = out.float(), da.decode_attention_plain(q, k, v, n).float()
        err = float((got - want).abs().max())
        seen["calls"] += 1
        seen["outside"] += not decode_close(got, want, "bfloat16")
        seen["max_abs_err"] = max(seen["max_abs_err"], err)
        seen["max_rel_err"] = max(seen["max_rel_err"], err / max(float(want.abs().max()), 1e-30))
        return out

    cache["pos"].fill_(start)
    da.decode_attention = checked
    try:
        for i in range(tokens.shape[0]):
            decode_step(params, cache, tokens[i], cfg, impl="auto")
    finally:
        da.decode_attention = real
    torch.cuda.synchronize()
    print(f"{what} attention calls held to phase 2's check: {seen}", flush=True)
    return seen


# the decode-attention kernels' names, as the profiler lists them
DECODE_KERNELS = ("decode_attention_kernel", "decode_split", "decode_combine")
#: The kernels of one decode-attention launch that run once each (the
#: split body's combine runs beside its split kernel only where it splits).
DECODE_MAIN = ("decode_attention_kernel", "decode_split")


def profile_decode(hosted, prompt, dev, steps=4, cache=None):
    """Device time of a few decode steps by kernel (:func:`profiled`),
    against their wall time (the profiler's own overhead is inside the
    wall time).  Without a ``cache``, a small one after one step on
    ``prompt[:, 0]``; with one, the steps take ``prompt[:, :steps]`` from
    where it stands (a retaken profile starts from there again)."""
    from repro_torch.models import decode_step, init_cache

    state = {}
    if cache is None:
        def prepare():
            state["cache"] = init_cache(hosted.cfg, 2, steps + 2, device=dev)
            decode_step(hosted.params, state["cache"], prompt[:, 0], hosted.cfg)
        first = 1
    else:
        pos = cache["pos"].clone()

        def prepare():
            cache["pos"].copy_(pos)
            state["cache"] = cache
        first = 0

    def run():
        for i in range(steps):
            decode_step(hosted.params, state["cache"], prompt[:, first + i], hosted.cfg)

    task, wall_ms, took = profiled(run, f"{steps} {hosted.cfg.name} decode steps",
                                      prepare=prepare)
    rows = by_kernel(task)
    total_ms = sum(ms for ms, _, _ in rows)
    attn_ms = sum(ms for ms, _, k in rows if any(d in k for d in DECODE_KERNELS))
    kernels_per_step = len(task) / steps
    print(f"  decode_attention kernels: {attn_ms:.3f} ms")
    print(f"profile of {steps} {hosted.cfg.name} decode steps: device busy {total_ms:.2f} ms "
          f"of {wall_ms:.2f} ms wall ({100 * total_ms / wall_ms:.1f} %), "
          f"{kernels_per_step:.0f} kernels per step")
    top = []
    for ms, n, k in rows[:10]:
        top.append(dict(name=k, device_ms=ms, calls=n))
        print(f"  {ms:9.3f} ms  {n:6d} calls  {k[:90]}")
    print(f"  per step: device {total_ms / steps:.3f} ms, decode attention "
          f"{attn_ms / steps:.3f} ms ({100 * attn_ms / max(total_ms, 1e-9):.1f} % of device time), "
          f"wall {wall_ms / steps:.2f} ms")
    return dict(steps=steps, wall_ms=wall_ms, device_ms=total_ms, attention_ms=attn_ms,
                kernels_per_step=kernels_per_step, top=top, **took)


# ---------------------------------------------------------------------------
# phase 3b: the prefill path at full width
# ---------------------------------------------------------------------------
def prefill_full_width():
    import torch
    from repro_torch.examples import serve_cluster as ex
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import forward, next_token_loss
    from repro_torch.training import make_prefill_step

    if "hosted" not in SHARED:
        raise RuntimeError("phase 3 did not leave its weights")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    models = sorted(SHARED["hosted"], key=lambda h: h.cfg.name)
    batches = {h.cfg.name: torch.randint(0, h.cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                                         device=dev) for h in models}
    calls = 2  # the first call per model, then a second one
    out = {}
    last = {}
    # the main path: counts set to 0 just before, read just after
    da.launches = fa.launches = ssd.launches = 0
    fa.launches_by_body.clear()
    ssd.launches_by_body.clear()
    for h in models:
        step = make_prefill_step(h.cfg, device=dev)
        f0, s0, w0 = fa.launches, ssd.launches, fa.launches_by_body.get("wgmma", 0)
        c0 = ssd.launches_by_body.get("chunked", 0)
        walls = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(h.params, {"tokens": batches[h.cfg.name]})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{h.cfg.name}: non-finite prefill logits")
        last[h.cfg.name] = logits[:, -1].float()
        del logits
        dense = h.cfg.arch_type == "dense"
        got = dict(flash=fa.launches - f0, ssd=ssd.launches - s0,
                   flash_wgmma=fa.launches_by_body.get("wgmma", 0) - w0,
                   ssd_chunked=ssd.launches_by_body.get("chunked", 0) - c0)
        want = dict(flash=h.cfg.n_layers * calls if dense else 0,
                    ssd=0 if dense else h.cfg.n_layers * calls,
                    flash_wgmma=h.cfg.n_layers * calls if dense else 0,
                    ssd_chunked=0 if dense else h.cfg.n_layers * calls)
        tokens = PREFILL_B * PREFILL_S
        out[h.cfg.name] = dict(layers=h.cfg.n_layers, wall_s=walls,
                               tokens_per_s=[tokens / w for w in walls],
                               launches=got, expected_launches=want)
        print(f"{h.cfg.name} ({h.cfg.n_layers} layers) prefill B={PREFILL_B} S={PREFILL_S}: "
              f"wall {', '.join(f'{w:.3f}' for w in walls)} s, "
              f"{', '.join(f'{tokens / w:.0f}' for w in walls)} tokens/s; "
              f"launches flash {got['flash']} (expected {want['flash']}; on wgmma "
              f"{got['flash_wgmma']}), "
              f"ssd {got['ssd']} (expected {want['ssd']}; on chunked {got['ssd_chunked']})",
              flush=True)
        if got != want:
            raise AssertionError(f"{h.cfg.name}: launches {got}, expected {want}")
    launches = dict(flash_attention=fa.launches, ssd_scan=ssd.launches,
                    decode_attention=da.launches)
    print(f"prefill launches: {launches}; flash by body: {fa.launches_by_body}; "
          f"ssd by body: {ssd.launches_by_body}")
    launches_by_body = dict(fa.launches_by_body)
    ssd_by_body = dict(ssd.launches_by_body)
    out["short_prefill_on_fused"] = short_prefill_on_fused(
        next(h for h in models if h.cfg.arch_type != "dense"), gen, dev)

    for h in models:
        batch = {"tokens": batches[h.cfg.name]}
        loss = float(next_token_loss(h.params, batch, h.cfg))
        plain_step = make_prefill_step(h.cfg, impl="ref_chunked", device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = plain_step(h.params, batch)[:, -1].float()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        x = last[h.cfg.name]
        err, scale = float((x - plain).abs().max()), float(plain.abs().max())
        same = bool(torch.equal(x.argmax(-1), plain.argmax(-1)))
        out[h.cfg.name].update(loss=loss, plain_wall_s=plain_wall, last_logits_max_abs_diff=err,
                               max_abs_logit=scale, ratio=err / scale, argmax_equal=same)
        print(f"{h.cfg.name}: next_token_loss {loss:.4f}; plain path wall {plain_wall:.3f} s; "
              f"last-position logits, kernel vs plain: max |diff| {err:.4e} of {scale:.4e} "
              f"(ratio {err / scale:.3e}), argmax equal: {same}", flush=True)
        if not (loss == loss and abs(loss) < float("inf")):
            raise AssertionError(f"{h.cfg.name}: non-finite loss {loss}")
        if err / scale > LOGIT_BOUND or not same:
            raise AssertionError(f"{h.cfg.name}: prefill logits, kernel path and plain path disagree")

    # NeMo's forward over phase 3's prompt against its decode path: the two
    # round at other places (batched against one-token matmuls, flash
    # against decode kernel), so they are held to LOGIT_BOUND as the kernel
    # and plain paths are
    nemo = next(h for h in models if h.model_id == ex.VERIFY)
    fwd = forward(nemo.params, {"tokens": SHARED["nemo_prompt"]}, nemo.cfg)[0][:, -1].float()
    dec = SHARED["nemo_decode_logits"]
    err, scale = float((fwd - dec).abs().max()), float(dec.abs().max())
    same = bool(torch.equal(fwd.argmax(-1), dec.argmax(-1)))
    if not bool(torch.isfinite(fwd).all()):
        raise AssertionError("NeMo forward over the prompt: non-finite logits")
    out["nemo_forward_vs_decode"] = dict(max_abs_diff=err, max_abs_logit=scale,
                                         ratio=err / scale, argmax_equal=same)
    print(f"NeMo last-position logits over the {SHARED['nemo_prompt'].shape[1]}-token prompt, "
          f"forward (flash kernel) vs decode path (decode kernel): max |diff| {err:.4e} of "
          f"{scale:.4e} (ratio {err / scale:.3e}), argmax equal: {same}", flush=True)
    if err / scale > LOGIT_BOUND or not same:
        raise AssertionError("NeMo over the prompt: forward and decode path disagree")
    out["launches"] = launches
    out["flash_launches_by_body"] = launches_by_body
    out["ssd_launches_by_body"] = ssd_by_body
    return out


def short_prefill_on_fused(h, gen, dev):
    """3b's one-card short prefill: mamba2 at full width and depth, B = 1,
    S = 256, whose SSD calls (48 heads, 2 chunks: 96 CTAs) fit one wave,
    so every one runs on ``fused``; the logits are bit for bit those of the
    same prefill with the fused body withheld (every call on ``chunked``)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.training import make_prefill_step

    batch = {"tokens": torch.randint(0, h.cfg.vocab, (1, 256), generator=gen, device=dev)}
    step = make_prefill_step(h.cfg, device=dev)
    choose, ran, logits = ssd.bodies_for, {}, {}
    for withheld in (False, True):
        if withheld:
            ssd.bodies_for = lambda *a, **kw: tuple(z for z in choose(*a, **kw) if z != "fused")
        before = dict(ssd.launches_by_body)
        try:
            logits[withheld] = step(h.params, batch)
            torch.cuda.synchronize()
        finally:
            ssd.bodies_for = choose
        ran[withheld] = {z: v - before.get(z, 0) for z, v in ssd.launches_by_body.items()
                         if v != before.get(z, 0)}
    same = bool(torch.equal(logits[False], logits[True]))
    want = ({"fused": h.cfg.n_layers}, {"chunked": h.cfg.n_layers})
    print(f"{h.cfg.name} prefill B=1 S=256 on one card: SSD launches by body {ran[False]} "
          f"(expected {want[0]}), with fused withheld {ran[True]}; logits bit for bit: {same}",
          flush=True)
    if (ran[False], ran[True]) != want or not same:
        raise AssertionError(f"{h.cfg.name} short prefill: launches {ran}, bit for bit {same}")
    return dict(b=1, s=256, launches_by_body=ran[False], withheld=ran[True], bitwise_equal=same)


# ---------------------------------------------------------------------------
# phase 3h: the serving run with the cluster's four options on
# ---------------------------------------------------------------------------
def serve_with_planes():
    """Phase 3's 10 requests on phase 3's models again, with gossip (the
    paper's 200 ms rounds), prefetch, the flight recorder and the health
    plane on: the assignments, hit rate and prefetch stats; the health
    summary and the recorder's Chrome trace held to their schemas; the
    recorder's events by kind; the spans ``build_spans`` stitches, one
    completed span per model task; the decode launches held as phase 3
    holds them; the wall time beside phase 3's.  Placements follow the
    wall clock here (gossip rounds run up to the virtual clock, which adds
    each task's measured wall time), so they are printed, not compared."""
    import collections

    from repro_torch.core import GossipConfig, PrefetchConfig, validate_schema
    from repro_torch.core.telemetry import build_spans
    from repro_torch.kernels import decode_attention as da

    if "requests" not in SHARED:
        raise RuntimeError("phase 3 did not leave its models and requests")
    requests = SHARED["requests"]
    sc, wall = serve_requests(SHARED["hosted"], requests, 6, gossip=GossipConfig(),
                              prefetch=PrefetchConfig(), trace=True, health=True)
    warm = da.launches
    replayed = sc.engine.replayed_launches["decode_attention"]
    by_body = bodies(sc.engine)["decode_attention"]
    graphs = graph_rows(sc.engine)
    want_warm = sum(g["launches"]["decode_attention"] for g in graphs)
    tokens_out = sum(o.size for r in sc.results for o in r.outputs.values())
    for r in sc.results:
        print(f"  job {r.job_id} {r.dfg_name:20s} assign={r.assignment} "
              f"virtual={r.virtual_latency_s:.3f} s wall={r.latency_s:.3f} s")
    stats = dataclasses.asdict(sc.prefetch_plane.stats)
    print(f"wall {wall:.2f} s ({tokens_out / wall:.1f} decoded tokens/s; phase 3: "
          f"{SHARED['serve_wall']:.2f} s); cache hit rate {sc.cache_hit_rate():.3f}; workers "
          f"used {sc.workers_used()}; gossip messages {sc.sst.messages_sent}", flush=True)
    print(f"prefetch stats: {stats}")
    summary = sc.health.summary()
    validate_schema(summary, json.loads((ROOT / "schemas" / "health.schema.json").read_text()))
    print(f"health summary: valid against schemas/health.schema.json; detectors "
          f"{summary['detectors']}; fleet job latency {summary['fleet_job_latency']}")
    kinds = collections.Counter(e[2] for e in sc.recorder.events())
    print(f"recorder events by kind: {dict(sorted(kinds.items()))}; dropped "
          f"{sc.recorder.dropped}")
    chrome = json.loads(json.dumps(sc.recorder.to_chrome_trace()))
    validate_schema(chrome, json.loads((ROOT / "schemas" / "trace.schema.json").read_text()))
    print(f"Chrome trace: {len(chrome['traceEvents'])} events, valid against "
          "schemas/trace.schema.json")
    spans = build_spans(sc.recorder.events())
    done = [x for x in spans.values() if x.t_done is not None]
    tasks = sum(len(r.outputs) for r in sc.results)
    print(f"spans: {len(done)} completed of {len(spans)} (model tasks: {tasks})")
    print(f"decode_attention launches: {replayed} replayed (expected "
          f"{SHARED['expected_launches']}) + {warm} warm-up (expected {want_warm}); by body "
          f"{by_body}", flush=True)
    out = dict(wall_s=wall, phase3_wall_s=SHARED["serve_wall"], decoded_tokens=tokens_out,
               decoded_tokens_per_s=tokens_out / wall, cache_hit_rate=sc.cache_hit_rate(),
               workers_used=sc.workers_used(), assignments=[r.assignment for r in sc.results],
               virtual_latencies_s=[r.virtual_latency_s for r in sc.results],
               gossip_messages=sc.sst.messages_sent, prefetch_stats=stats,
               health_detectors=summary["detectors"], events_by_kind=dict(kinds),
               trace_events=len(chrome["traceEvents"]), spans_done=len(done), tasks=tasks,
               replayed_launches=replayed, warmup_launches=warm, graphs=graphs)
    if len(done) != tasks or any(x.t_start is None or x.t_done < x.t_start for x in done):
        raise AssertionError(f"{len(done)} completed spans for {tasks} model tasks")
    if replayed != SHARED["expected_launches"] or warm != want_warm \
            or by_body != {"split": replayed + warm}:
        raise AssertionError(f"decode launches {replayed} + {warm} ({by_body})")
    if sc.recorder.dropped or not stats["prefetches_completed"] or not sc.sst.messages_sent:
        raise AssertionError("the recorder dropped events, or no prefetch or gossip ran")
    return out


# ---------------------------------------------------------------------------
# phases 3c and 3d: the MoE family at full width
# ---------------------------------------------------------------------------
def release_models():
    """Drop every model an earlier phase left, with every engine's graphs
    and caches, and hand their memory back."""
    import gc
    import torch

    SHARED.clear()
    for e in ENGINES:
        e.close()
    ENGINES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory in use after release: {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)


class RouteRecorder:
    """Records each ``route`` call's expert sets (sorted top-k ids per
    token, one entry per MoE layer and call) while it is active."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.calls, self.module, self.route = [], moe_mod, moe_mod.route

        def recording(x, router_w, top_k):
            gates, idx, aux = self.route(x, router_w, top_k)
            self.calls.append(idx.sort(dim=-1).values)
            return gates, idx, aux

        moe_mod.route = recording
        return self

    def __exit__(self, *exc):
        self.module.route = self.route


def flips(a, b):
    """Tokens per layer whose expert set differs between two recordings."""
    return [int((x != y).any(dim=-1).sum()) for x, y in zip(a.calls, b.calls)]


def argmax_share(x, y):
    """Share of rows (the last axis is the vocabulary) at which the two
    logits pick the same token: x's argmax is one of y's largest logits or
    y's one of x's (an exact tie makes argmax's first-index pick arbitrary)."""
    ax, ay = x.argmax(-1, keepdim=True), y.argmax(-1, keepdim=True)
    same = (y.gather(-1, ax) == y.gather(-1, ay)) | (x.gather(-1, ay) == x.gather(-1, ax))
    return float(same.float().mean())


def top2(x):
    """The two largest logits of each row of ``x`` (B, V), as (token, logit)
    pairs: what decides a flip of one row's argmax."""
    vals, idx = x.float().topk(2, dim=-1)
    return [[(int(i), float(v)) for i, v in zip(ri, rv)] for ri, rv in zip(idx, vals)]


def compare_logits(what, x, y):
    err, scale = float((x - y).abs().max()), float(y.abs().max())
    same = bool((x.argmax(-1) == y.argmax(-1)).all())
    print(f"{what}: max |diff| {err:.4e} of {scale:.4e} (ratio {err / scale:.3e}), "
          f"argmax equal: {same}", flush=True)
    return dict(max_abs_diff=err, max_abs_logit=scale, ratio=err / scale, argmax_equal=same)


def counts_zeroed(*engines):
    """Set every kernel's launch counts, and the replay counts of
    ``engines``, to 0; returns a function that reads each kernel's
    launches since: the wrapper's count (eager calls, a capture's warm-up
    step among them) plus the launches of the engines' graph replays."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_bwd as gb
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssd_scan_bwd as sb

    # the backward kernels' counts are zeroed too, and read by phases 6, 6b
    # and 7c alone; so are the partials path's, read by phase 7e alone
    da.launches = fa.launches = fb.launches = ssd.launches = gmm.launches = sb.launches = 0
    gb.dx_launches = gb.dw_launches = 0
    da.partials_launches = da.combine_launches = 0
    for counts in (da.launches_by_body, da.partials_by_body, da.combine_by_body,
                   fa.launches_by_body, fb.launches_by_body,
                   ssd.launches_by_body, gmm.launches_by_body, sb.launches_by_body,
                   gb.dx_by_body, gb.dw_by_body):
        counts.clear()
    for e in engines:
        e.reset_counts()

    def read():
        out = dict(decode_attention=da.launches, flash_attention=fa.launches,
                   ssd_scan=ssd.launches, moe_gmm=gmm.launches)
        for e in engines:
            for k, n in e.replayed_launches.items():
                out[k] += n
        return out

    return read


def bodies(*engines):
    """Launches by body of each kernel since ``counts_zeroed``, the
    replays of ``engines`` included."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ssd_scan as ssd

    out = {name: dict(mod.launches_by_body) for name, mod in (
        ("decode_attention", da), ("flash_attention", fa), ("ssd_scan", ssd), ("moe_gmm", gmm))}
    for e in engines:
        for name, by in e.replayed_by_body.items():
            for body, n in by.items():
                out[name][body] = out[name].get(body, 0) + n
    return out


def on_bodies(launches, **body):
    """What ``bodies`` reads when every launch of a run with these
    ``launches`` went through the body named for its kernel."""
    return {k: {body[k]: n} if n else {} for k, n in launches.items()}


def load_full_width(name, layers=None, reason=None):
    """Release the earlier phase's models, then the zoo's ``name`` at full
    width in bf16, with its depth cut to ``layers`` where given (printed,
    with ``reason``), its weights from a ``torch.Generator`` seed.  Returns
    (cfg, params, the phase's output dict)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    release_models()
    dev = torch.device("cuda")
    cfg = ARCHS[name]
    if layers is not None:
        print(f"{name} depth cut: {cfg.n_layers} -> {layers} layers ({reason})")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(13), dev)
    torch.cuda.synchronize()
    size = sum(p.nbytes for p in params.parameters())
    out = dict(model=name, layers=cfg.n_layers, bytes=size, init_s=time.perf_counter() - t0)
    print(f"{name}: {cfg.n_layers} layers, {size / 1e9:.2f} GB bf16, weights initialised in "
          f"{out['init_s']:.1f} s", flush=True)
    return cfg, params, out


def moe_full_width(name, layers=None, reason=None):
    """Prefill (twice, with launch counts), the loss, the kernel path against
    the plain path (whole model and one MoE layer), one serving task, and
    sorted against scan decode on one cache, for the MoE model ``name``."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, forward, init_cache, next_token_loss
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import ExecutionEngine, HostedModel
    from repro_torch.training import make_prefill_step

    dev = torch.device("cuda")
    cfg, params, out = load_full_width(name, layers, reason)
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                                     device=dev)}
    n = cfg.n_layers

    # 1. prefill, the main path
    calls = 2
    logits, walls, launches, by_body, peak = timed_prefill(cfg, params, batch, calls)
    del logits
    want = dict(decode_attention=0, flash_attention=n * calls, ssd_scan=0,
                moe_gmm=3 * n * calls)
    tokens = PREFILL_B * PREFILL_S
    out.update(prefill_wall_s=walls, prefill_tokens_per_s=[tokens / w for w in walls],
               prefill_launches=launches, prefill_expected_launches=want,
               prefill_launches_by_body=by_body, prefill_peak_bytes=peak)
    print(f"{name} prefill B={PREFILL_B} S={PREFILL_S}: wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} s, "
          f"{', '.join(f'{tokens / w:.0f}' for w in walls)} tokens/s; launches {launches} "
          f"(expected {want}); by body {by_body}; peak "
          f"{out['prefill_peak_bytes'] / 1e9:.2f} GB", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: prefill launches {launches}, expected {want}")
    if by_body != on_bodies(want, flash_attention="wgmma", moe_gmm="wgmma"):
        raise AssertionError(f"{name}: prefill launches by body {by_body}, expected all on wgmma")
    loss = float(next_token_loss(params, batch, cfg))
    out["loss"] = loss
    print(f"{name}: next_token_loss {loss:.4f}", flush=True)
    if not np.isfinite(loss):
        raise AssertionError(f"{name}: non-finite loss")

    # 2. kernel path against plain path: one MoE layer on one input (the
    # router sees the same input, so the routing is the same), then the
    # whole model with each path's expert sets recorded
    layer = params["layers"].layer(0)["moe"]
    x = torch.randn(PREFILL_B, PREFILL_S, cfg.d_model, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    read = counts_zeroed()
    y_kernel, _ = moe_mod.moe_ffn(x, layer, top_k=cfg.top_k)
    kernel_launches = read()["moe_gmm"]
    if bodies()["moe_gmm"] != {"wgmma": 3}:
        raise AssertionError(f"{name}: one MoE layer ran moe_gmm on {bodies()['moe_gmm']}")
    y_plain, _ = moe_mod.moe_ffn(x, layer, top_k=cfg.top_k, impl="ref")
    if (kernel_launches, read()["moe_gmm"]) != (3, 3):
        raise AssertionError(f"{name}: one MoE layer launched moe_gmm {read()['moe_gmm']} times")
    one_err = float((y_kernel.float() - y_plain.float()).abs().max())
    out["one_layer_max_abs_err"] = one_err
    print(f"{name}: one MoE layer (sorted, B={PREFILL_B} S={PREFILL_S}), kernel (3 launches) "
          f"vs plain (moe_gmm_ref, no launch): max |diff| {one_err:.3e} "
          f"(tolerance {TOL['bfloat16']})", flush=True)
    if not torch.allclose(y_kernel.float(), y_plain.float(), atol=TOL["bfloat16"],
                          rtol=TOL["bfloat16"]):
        raise AssertionError(f"{name}: one MoE layer, kernel and plain path disagree")
    del x, y_kernel, y_plain
    with RouteRecorder() as rk:
        kernel_last = forward(params, batch, cfg)[0][:, -1].float()
    with RouteRecorder() as rp:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain_last = make_prefill_step(cfg, impl="ref_chunked", device=dev)(params, batch)[:, -1]
        torch.cuda.synchronize()
        out["plain_prefill_wall_s"] = time.perf_counter() - t1
    flipped = flips(rk, rp)
    cmp = compare_logits(f"{name} last-position logits, kernel vs plain (bf16, {n} layers)",
                         kernel_last, plain_last.float())
    print(f"  routing flips per layer (tokens of {tokens} whose expert set differs): {flipped}")
    cmp["flips"] = flipped
    out["kernel_vs_plain"] = cmp
    del rk, rp, kernel_last, plain_last

    # 3. one serving task, as a card serves it (the sorted dispatch),
    # through a graph, then graph against eager
    hosted = HostedModel(0, cfg, params, dev)
    engine = track(ExecutionEngine({0: hosted}, decode_tokens=6, device=dev))
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)
    out["serve"] = graphed_task(engine, prompt, n * (prompt.shape[1] + 6), moe=True)
    out["serve"]["graph_vs_eager"] = graph_vs_eager(engine, 0, prompt)

    # 4. sorted against scan decode from one cache (moe_gmm at 16 rows a layer)
    prompt_t = torch.as_tensor(prompt, device=dev)
    cache = init_cache(cfg, 2, 24, device=dev)
    for i in range(16):
        decode_step(params, cache, prompt_t[:, i], cfg, moe_dispatch="scan")
    dec, dec_steps = {}, 4
    for dispatch in ("sorted", "scan", "sorted", "scan"):
        c = {k: v.clone() for k, v in cache.items()}
        read = counts_zeroed()
        with RouteRecorder() as rec:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(16, 16 + dec_steps):
                step_logits, c = decode_step(params, c, prompt_t[:, i], cfg,
                                             moe_dispatch=dispatch)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / dec_steps * 1e3
        d = dec.setdefault(dispatch, dict(step_ms=[]))
        d.update(logits=step_logits.float(), launches=read(), by_body=bodies(), rec=rec)
        d["step_ms"].append(ms)
    for dispatch in ("sorted", "scan"):
        print(f"{name} decode step (B=2, bf16), {dispatch}: {dec[dispatch]['step_ms']} ms; "
              f"launches {dec[dispatch]['launches']}", flush=True)
    if dec["sorted"]["launches"]["moe_gmm"] != 3 * n * dec_steps:
        raise AssertionError(f"{name}: sorted decode launched moe_gmm "
                             f"{dec['sorted']['launches']['moe_gmm']} times")
    if dec["sorted"]["by_body"]["moe_gmm"] != {"decode": 3 * n * dec_steps}:
        raise AssertionError(f"{name}: sorted decode ran moe_gmm on "
                             f"{dec['sorted']['by_body']['moe_gmm']}")
    dec_flips = flips(dec["sorted"]["rec"], dec["scan"]["rec"])
    dcmp = compare_logits(f"{name} decode logits after {dec_steps} steps, sorted vs scan",
                          dec["sorted"]["logits"], dec["scan"]["logits"])
    print(f"  routing flips per layer and step (of 2 tokens): {sum(dec_flips)} in all")
    dcmp.update(flips=dec_flips)
    out["decode"] = {k: dict(step_ms=v["step_ms"], launches=v["launches"], by_body=v["by_body"])
                     for k, v in dec.items()}
    out["sorted_vs_scan"] = dcmp
    out["profile"] = profile_decode(hosted, prompt_t, dev)

    # the whole model is held as phase 3b holds it, with the expert sets
    # that the two paths chose counted beside it
    for what, c in (("prefill, kernel vs plain", cmp), ("decode, sorted vs scan", dcmp)):
        if c["ratio"] > LOGIT_BOUND or not c["argmax_equal"]:
            raise AssertionError(f"{name} {what}: logits disagree")
    return out


def qwen3_moe_full_width():
    return moe_full_width("qwen3-moe-30b-a3b")


def deepseek_v2_cut_depth():
    return moe_full_width(
        "deepseek-v2-236b", layers=4,
        reason="the whole model is 478.85 GB and cannot be held by one card; each layer "
               "at full width takes about 7.9 GB")


# ---------------------------------------------------------------------------
# phases 3e-3g: the hybrid, audio and VLM families at full width
# ---------------------------------------------------------------------------
def timed_prefill(cfg, params, batch, calls=2):
    """``make_prefill_step`` over ``batch``, ``calls`` times: the main path,
    with the counts set to 0 just before and read just after.  Returns the
    last call's logits, the wall times, the launches, the launches by body
    and the peak device memory."""
    import torch
    from repro_torch.training import make_prefill_step

    step = make_prefill_step(cfg, device=torch.device("cuda"))
    walls = []
    torch.cuda.reset_peak_memory_stats()
    read = counts_zeroed()
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches, by_body = read(), bodies()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    return logits, walls, launches, by_body, torch.cuda.max_memory_allocated()


def prefill_checks(cfg, params, batch, what, want, **body):
    """The prefill of phases 3e-3g: ``timed_prefill`` with its launches
    (and by body) held to ``want``; the loss; the kernel path against the
    plain path (``ref_chunked``): the last position's logits within
    ``LOGIT_BOUND`` and the argmax equal at ``ARGMAX_SHARE`` of all
    positions (the last position's agreement and top two logits printed
    beside it); and the device's busy share over one more call, by the
    profiler."""
    import numpy as np
    import torch
    from repro_torch.models import next_token_loss
    from repro_torch.training import make_prefill_step

    dev = torch.device("cuda")
    logits, walls, launches, by_body, peak = timed_prefill(cfg, params, batch)
    tokens = int(np.prod(batch["tokens"].shape))
    print(f"{cfg.name} prefill {what}: wall {', '.join(f'{w:.3f}' for w in walls)} s, "
          f"{', '.join(f'{tokens / w:.0f}' for w in walls)} tokens/s; launches {launches} "
          f"(expected {want}); by body {by_body}; peak {peak / 1e9:.2f} GB", flush=True)
    if launches != want:
        raise AssertionError(f"{cfg.name}: prefill launches {launches}, expected {want}")
    if by_body != on_bodies(want, **body):
        raise AssertionError(f"{cfg.name}: prefill launches by body {by_body}, expected {body}")
    loss = float(next_token_loss(params, batch, cfg))
    print(f"{cfg.name}: next_token_loss {loss:.4f}", flush=True)
    if not np.isfinite(loss):
        raise AssertionError(f"{cfg.name}: non-finite loss")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = make_prefill_step(cfg, impl="ref_chunked", device=dev)(params, batch)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    cmp = compare_logits(f"{cfg.name} prefill {what}, last-position logits, kernel vs plain",
                         logits[:, -1].float(), plain[:, -1].float())
    cmp.update(argmax_agreement(logits, plain, logits[:, -1], plain[:, -1]))
    del logits, plain
    print(f"  argmax equal at {cmp['argmax_share']:.4f} of {tokens} positions, kernel vs plain; "
          f"at the last position (ties equal) {cmp['last_agrees']}, top two kernel "
          f"{cmp['last_top2'][0]} plain {cmp['last_top2'][1]}", flush=True)
    if cmp["ratio"] > LOGIT_BOUND or cmp["argmax_share"] < ARGMAX_SHARE:
        raise AssertionError(f"{cfg.name} prefill {what}: kernel and plain path disagree")
    step = make_prefill_step(cfg, device=dev)
    busy = profile_call(lambda: step(params, batch), f"one {cfg.name} prefill {what}")
    return dict(wall_s=walls, tokens_per_s=[tokens / w for w in walls], launches=launches,
                expected_launches=want, launches_by_body=by_body, peak_bytes=peak, loss=loss,
                plain_wall_s=plain_wall, kernel_vs_plain=cmp, profile=busy)


def argmax_agreement(x, y, x_last, y_last):
    """The argmax of logits ``x`` against ``y`` (the last axis is the
    vocabulary): the share of all rows that agree, and for the last
    position's or step's rows ``x_last``, ``y_last`` (B, V) each row's
    agreement and the top two logits of each side (ties count as agreement
    throughout)."""
    return dict(argmax_share=argmax_share(x, y),
                last_agrees=[argmax_share(a, b) == 1.0 for a, b in zip(x_last, y_last)],
                last_top2=(top2(x_last), top2(y_last)))


def profile_call(fn, what, top=0):
    """Device time of one call of ``fn`` (:func:`profiled`) against its
    wall time, which ends in a synchronise; with ``top``, also the
    ``top`` kernels that took the most device time, by name."""
    task, wall_ms, took = profiled(fn, what)
    rows = by_kernel(task)
    device_ms = sum(ms for ms, _, _ in rows)
    print(f"profile of {what}: device busy {device_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"({100 * device_ms / wall_ms:.1f} %)", flush=True)
    out = dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms, **took)
    if top:
        out["top"] = [dict(ms=ms, count=n, kernel=k) for ms, n, k in rows[:top]]
        for r in out["top"]:
            print(f"  {r['ms']:9.3f} ms  x{r['count']:5d}  {r['kernel'][:110]}")
    return out


def serve_task(cfg, params, prompt, want_decode):
    """``ExecutionEngine.run_task`` (a 64-token prompt, 6 tokens), the
    main path of serving, through a new engine: its first task captures
    the step, and its launches are held to ``want_decode`` decode launches
    in the replays plus one warm-up step's, every one on the split body;
    then the step, graph against eager, in turns (``graph_vs_eager``).
    Returns the hosted model and the readings."""
    import torch
    from repro_torch.serving import ExecutionEngine, HostedModel

    dev = torch.device("cuda")
    hosted = HostedModel(0, cfg, params, dev)
    engine = track(ExecutionEngine({0: hosted}, decode_tokens=6, device=dev))
    out = graphed_task(engine, prompt, want_decode)
    out["graph_vs_eager"] = graph_vs_eager(engine, 0, prompt)
    return hosted, out


def graphed_task(engine, prompt, want_decode, moe=False):
    """The first task of model 0 on ``engine``, which captures its step:
    the launches held to ``want_decode`` decode launches in the replays
    and one step's in the warm-up (every one on the split body) and, for an
    MoE model (``moe``), three grouped-matmul launches for each decode
    launch, every one on the decode body; no other kernel; the tokens, the
    wall time, the graph's capture."""
    from repro_torch.kernels import decode_attention as da

    cfg = engine.models[0].cfg
    read = counts_zeroed(engine)
    generated, wall = engine.run_task(0, prompt)
    launches, by_body = read(), bodies(engine)
    steps = prompt.shape[1] + engine.decode_tokens
    warm = da.launches
    (graph,) = graph_rows(engine)
    print(f"{cfg.name} serving task (B=2, {prompt.shape[1]}-token prompt, 6 tokens"
          f"{', routed' if moe else ''}): {wall:.3f} s with the capture, {wall / steps * 1e3:.2f} "
          f"ms per decode step; launches {launches} ({warm} decode in the warm-up); by body "
          f"{by_body}", flush=True)
    decodes = want_decode + want_decode // steps
    want = dict(decode_attention=decodes, flash_attention=0, ssd_scan=0,
                moe_gmm=3 * decodes if moe else 0)
    if launches != want or by_body != on_bodies(want, decode_attention="split",
                                                moe_gmm="decode") \
            or warm != want_decode // steps:
        raise AssertionError(f"{cfg.name}: serving launches {launches} ({by_body}; warm-up "
                             f"{warm}), expected {want}")
    return dict(wall_s=wall, step_ms=wall / steps * 1e3, launches=launches,
                warmup_launches=warm, by_body=by_body, graph=graph, tokens=generated.tolist())


def decode_logits(cfg, params, cache, tokens, start, impl):
    """``tokens.shape[0]`` decode steps on ``impl``'s path from a copy of
    ``cache`` at ``pos`` = start: the logits (steps, B, V) in fp32 and the
    host's ms per step."""
    import torch
    from repro_torch.models import decode_step

    c = {k: v.clone() for k, v in cache.items()}
    c["pos"].fill_(start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for i in range(tokens.shape[0]):
        out, c = decode_step(params, c, tokens[i], cfg, impl=impl)
        outs.append(out)
    torch.cuda.synchronize()
    return torch.stack(outs).float(), (time.perf_counter() - t0) / tokens.shape[0] * 1e3


def decode_kernel_vs_plain(cfg, params, cache, tokens, start, want_decode):
    """``tokens.shape[0]`` decode steps from ``cache`` at ``pos`` = start on
    the kernel path and on the plain path, each from its own copy of the
    cache, after one untimed step on each (the first call at these shapes
    warms cuBLAS and the allocator), in turns (kernel, plain, plain,
    kernel): step times, the kernel path's launches (held to
    ``want_decode``, all on the split body), the logits compared (the last
    step's within ``LOGIT_BOUND``, the argmax equal at ``ARGMAX_SHARE`` of
    every step's rows); then every attention call of one more kernel pass
    held to ``decode_close``."""
    steps = tokens.shape[0]
    for impl in ("auto", "ref_grouped"):
        decode_logits(cfg, params, cache, tokens[:1], start, impl)
    logits, step_ms, turns = {}, {}, []
    launches = by_body = None
    for impl in ("auto", "ref_grouped", "ref_grouped", "auto"):
        read = counts_zeroed()
        logits[impl], ms = decode_logits(cfg, params, cache, tokens, start, impl)
        step_ms.setdefault(impl, []).append(ms)
        turns.append(ms)
        if impl == "auto":
            launches, by_body = read(), bodies()
    print(f"{cfg.name} decode step (B=2, bf16) from pos {start}, in turns (kernel, plain, plain, "
          f"kernel): {', '.join(f'{t:.2f}' for t in turns)} ms", flush=True)
    print(f"  kernel path launches {launches}; by body {by_body}", flush=True)
    x, y = logits["auto"], logits["ref_grouped"]
    cmp = compare_logits(f"{cfg.name} logits after {steps} decode steps from pos {start}, "
                         "kernel vs plain", x[-1], y[-1])
    cmp.update(argmax_agreement(x, y, x[-1], y[-1]))
    print(f"  argmax equal at {cmp['argmax_share']:.4f} of {steps} steps x {tokens.shape[1]} rows; "
          f"at the last step (ties equal) {cmp['last_agrees']}, top two kernel "
          f"{cmp['last_top2'][0]} plain {cmp['last_top2'][1]}", flush=True)
    calls = checked_attention(params, cfg, {k: v.clone() for k, v in cache.items()}, tokens,
                              start, what=cfg.name)
    want = dict(decode_attention=want_decode, flash_attention=0, ssd_scan=0, moe_gmm=0)
    if launches != want or by_body != on_bodies(want, decode_attention="split"):
        raise AssertionError(f"{cfg.name}: decode launches {launches} ({by_body}), expected {want}")
    if cmp["ratio"] > LOGIT_BOUND or cmp["argmax_share"] < ARGMAX_SHARE:
        raise AssertionError(f"{cfg.name}: decode logits, kernel and plain path disagree")
    if calls["outside"] or calls["calls"] != want_decode:
        raise AssertionError(f"{cfg.name}: {calls['outside']} of {calls['calls']} attention calls "
                             f"(expected {want_decode}) outside phase 2's check")
    return dict(start=start, steps=steps, step_ms=step_ms, turns_ms=turns, launches=launches,
                by_body=by_body, kernel_vs_plain=cmp, attention_calls=calls)


def serve_prompt(cfg):
    """The serving task's prompt of phases 3e-3g: (2, 64) tokens from seed 6."""
    import numpy as np

    return np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)


# The seeded inputs of phases 3e-3g (also ``tools/logit_agreement.py``'s):
# each returns the prefill batches by name and a function that builds the
# checked decode's inputs, dict(cache, tokens, start), drawing on from the
# same generator.
def zamba2_inputs(cfg, params, dev):
    """zamba2: B = 2, S = 2048 and B = 1, S = 8192 (the shared block's
    4,096-key window cuts into the band); decode from a shared block ring
    seeded with random K/V and ``pos`` past the window (it has wrapped)."""
    import torch
    from repro_torch.models import init_cache

    gen = torch.Generator(device=dev).manual_seed(8)
    prefill = {
        f"B={PREFILL_B} S={PREFILL_S}": {"tokens": torch.randint(
            0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen, device=dev)},
        f"B=1 S={ZAMBA_LONG_S}": {"tokens": torch.randint(
            0, cfg.vocab, (1, ZAMBA_LONG_S), generator=gen, device=dev)},
    }

    def decode():
        window = cfg.sliding_window
        cache = init_cache(cfg, 2, window, device=dev)
        for key in ("shared_k", "shared_v"):
            cache[key].normal_(generator=gen)
        tokens = torch.randint(0, cfg.vocab, (DECODE_STEPS, 2), generator=gen, device=dev)
        return dict(cache=cache, tokens=tokens, start=3 * window + 100)  # wrapped three times

    return prefill, decode


def whisper_inputs(cfg, params, dev):
    """whisper: B = 2, its 448-token text context over 1,500 stub frames;
    decode from a cross-attention cache seeded from the encoder's output
    (each layer's projection, as ``tests/test_archs.py`` seeds it) after 16
    steps over the serving prompt.  ``decode`` also reads the encoder's
    launches (by body)."""
    import torch
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.layers import project_cross_kv
    from repro_torch.models.model import _encode_audio

    gen = torch.Generator(device=dev).manual_seed(9)
    frames = (torch.randn(PREFILL_B, cfg.n_audio_frames, cfg.d_model, generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, WHISPER_S), generator=gen,
                                     device=dev),
             "audio_frames": frames}

    def decode():
        read = counts_zeroed()
        enc = _encode_audio(params, frames, cfg, impl="auto")
        encoder = dict(launches=read(), by_body=bodies())
        cache = init_cache(cfg, 2, 16 + DECODE_STEPS, device=dev)
        for i in range(cfg.n_layers):
            k, v = project_cross_kv(enc, params["layers"].layer(i)["cross"],
                                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd)
            cache["cross_k"][i].copy_(k)
            cache["cross_v"][i].copy_(v)
        del enc
        prompt = torch.as_tensor(serve_prompt(cfg), device=dev)
        for i in range(16):
            decode_step(params, cache, prompt[:, i], cfg)
        return dict(cache=cache, tokens=prompt[:, 16:16 + DECODE_STEPS].t().contiguous(),
                    start=16, encoder=encoder)

    return {f"B={PREFILL_B} S={WHISPER_S}, {cfg.n_audio_frames} frames": batch}, decode


def qwen2_vl_inputs(cfg, params, dev):
    """qwen2-vl: B = 2, 1,024 vision embeddings and 2,048 tokens; decode
    after 16 steps over the serving prompt."""
    import torch
    from repro_torch.models import decode_step, init_cache

    gen = torch.Generator(device=dev).manual_seed(10)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                                     device=dev),
             "vision_embeds": (torch.randn(PREFILL_B, VLM_VISION, cfg.d_model, generator=gen,
                                           device=dev) * 0.02).to(torch.bfloat16)}

    def decode():
        prompt = torch.as_tensor(serve_prompt(cfg), device=dev)
        cache = init_cache(cfg, 2, 16 + DECODE_STEPS, device=dev)
        for i in range(16):
            decode_step(params, cache, prompt[:, i], cfg)
        return dict(cache=cache, tokens=prompt[:, 16:16 + DECODE_STEPS].t().contiguous(),
                    start=16)

    return {f"B={PREFILL_B}, {VLM_VISION} vision embeddings + {PREFILL_S} tokens": batch}, decode


QWEN2_VL_LAYERS = 32
QWEN2_VL_CUT = ("the whole model is 145.41 GB and cannot be held by one card; each layer at full "
                "width takes 1.76 GB, and the prefill's activations and the plain path's scores "
                "need the rest")


def zamba2_full_width():
    """zamba2-7b at full width and depth: prefill at B = 2, S = 2048, one
    forward at B = 1, S = 8192, one serving task, and 16 decode steps from
    a wrapped shared block ring (``zamba2_inputs``).  Flash attention runs
    on the mma body (D = 112 is no wgmma head dim), the SSD scan on
    chunked, decode on split."""
    import torch

    dev = torch.device("cuda")
    cfg, params, out = load_full_width("zamba2-7b")
    n, napp = cfg.n_layers, cfg.n_layers // cfg.attn_period
    prefill, decode = zamba2_inputs(cfg, params, dev)
    want = dict(decode_attention=0, flash_attention=2 * napp, ssd_scan=2 * n, moe_gmm=0)
    for part, (what, batch) in zip(("prefill", "prefill_long"), prefill.items()):
        out[part] = prefill_checks(cfg, params, batch, what, want, flash_attention="mma",
                                   ssd_scan="chunked")
    prompt = serve_prompt(cfg)
    hosted, out["serve"] = serve_task(cfg, params, prompt, napp * (64 + 6))
    d = decode()
    out["decode"] = decode_kernel_vs_plain(cfg, params, d["cache"], d["tokens"], d["start"],
                                           napp * DECODE_STEPS)
    del d
    out["profile"] = profile_decode(hosted, torch.as_tensor(prompt, device=dev), dev)
    return out


def whisper_full_width():
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers): prefill over 1,500 stub frames and a 448-token text context;
    decode from a cross-attention cache seeded from the encoder's output
    (``whisper_inputs``); one serving task (over a zero cross cache, as the
    reference's engine decodes).  Flash attention (the encoder's, the
    decoder's self- and cross-attention) runs on wgmma."""
    import torch

    dev = torch.device("cuda")
    cfg, params, out = load_full_width("whisper-medium")
    n, n_enc = cfg.n_layers, cfg.n_encoder_layers
    prefill, decode = whisper_inputs(cfg, params, dev)
    (what, batch), = prefill.items()
    out["prefill"] = prefill_checks(
        cfg, params, batch, what,
        dict(decode_attention=0, flash_attention=2 * (n_enc + 2 * n), ssd_scan=0, moe_gmm=0),
        flash_attention="wgmma")
    d = decode()
    enc = d["encoder"]
    print(f"whisper encoder over {cfg.n_audio_frames} frames: launches {enc['launches']}; by body "
          f"{enc['by_body']}", flush=True)
    if enc["launches"]["flash_attention"] != n_enc \
            or enc["by_body"]["flash_attention"] != {"wgmma": n_enc}:
        raise AssertionError(f"whisper encoder: flash launches {enc['by_body']}, "
                             f"expected {n_enc} on wgmma")
    out["decode"] = decode_kernel_vs_plain(cfg, params, d["cache"], d["tokens"], d["start"],
                                           2 * n * DECODE_STEPS)
    del d
    prompt = serve_prompt(cfg)
    hosted, out["serve"] = serve_task(cfg, params, prompt, 2 * n * (64 + 6))
    out["encoder_launches"], out["encoder_by_body"] = enc["launches"], enc["by_body"]
    out["profile"] = profile_decode(hosted, torch.as_tensor(prompt, device=dev), dev)
    return out


def qwen2_vl_cut_depth():
    """qwen2-vl-72b at full width with its depth cut: prefill at B = 2 over
    1,024 vision embeddings and 2,048 tokens (M-RoPE over the vision grid),
    decode steps and one serving task (``qwen2_vl_inputs``).  Its forward
    is not held against its decode: the reference decodes without the
    vision offset."""
    import torch

    dev = torch.device("cuda")
    cfg, params, out = load_full_width("qwen2-vl-72b", QWEN2_VL_LAYERS, QWEN2_VL_CUT)
    n = cfg.n_layers
    prefill, decode = qwen2_vl_inputs(cfg, params, dev)
    (what, batch), = prefill.items()
    out["prefill"] = prefill_checks(
        cfg, params, batch, what,
        dict(decode_attention=0, flash_attention=2 * n, ssd_scan=0, moe_gmm=0),
        flash_attention="wgmma")
    d = decode()
    out["decode"] = decode_kernel_vs_plain(cfg, params, d["cache"], d["tokens"], d["start"],
                                           n * DECODE_STEPS)
    del d
    prompt = serve_prompt(cfg)
    hosted, out["serve"] = serve_task(cfg, params, prompt, n * (64 + 6))
    out["profile"] = profile_decode(hosted, torch.as_tensor(prompt, device=dev), dev)
    return out


# ---------------------------------------------------------------------------
# phase 4: the reduced fp32 example, kernel path against plain path
# ---------------------------------------------------------------------------
def reduced_example():
    """The serve example reduced in fp32, kernel path against plain path:
    as it runs, and with all four options on, with each task's wall time
    pinned (``PINNED_WALL_S``) so that both paths' virtual clocks, and so
    their gossip rounds, are the same: then the placements, tokens, SST
    rows, prefetch stats, health summaries and the recorders' JSONL must
    be equal."""
    import numpy as np
    from repro_torch.core import ClusterSpec, GB, GossipConfig, PrefetchConfig
    from repro_torch.examples import serve_cluster as ex
    from repro_torch.serving import ServingCluster

    requests = ex.make_requests()
    out = {}
    for sched in ("navigator", "hash"):
        runs = {}
        for impl in ("auto", "ref"):
            sc, _, _ = ex.run(sched, requests, lambda: ex.reduced_hosted("cuda"),
                              device="cuda", impl=impl)
            track(sc.engine)
            runs[impl] = sc
        k, p = runs["auto"], runs["ref"]
        for rk, rp in zip(k.results, p.results):
            if rk.assignment != rp.assignment:
                raise AssertionError(f"{sched} job {rk.job_id}: assignments differ")
            for tid in rp.outputs:
                if not (rk.outputs[tid] == rp.outputs[tid]).all():
                    raise AssertionError(f"{sched} job {rk.job_id} {tid}: tokens differ")
        print(f"{sched}: 10 requests, equal assignments and tokens; cache hit rate "
              f"{k.cache_hit_rate():.3f}, workers used {k.workers_used()}")
        out[sched] = dict(cache_hit_rate=k.cache_hit_rate(), workers_used=k.workers_used())

        planes = {}
        for impl in ("auto", "ref"):
            sc = ServingCluster(ClusterSpec(n_workers=3, gpu_capacity_bytes=1 * GB),
                                ex.reduced_hosted("cuda"), scheduler=sched, decode_tokens=6,
                                gossip=GossipConfig(period_s=0.05), prefetch=PrefetchConfig(),
                                trace=True, health=True, device="cuda", impl=impl)
            track(sc.engine)
            real = sc.engine.run_task
            sc.engine.run_task = lambda mid, prompt, real=real: (real(mid, prompt)[0],
                                                                 PINNED_WALL_S)
            spec, summ = ex.build_pipelines()
            sc.register_pipeline(spec)
            sc.register_pipeline(summ)
            for i, (kind, prompt) in enumerate(requests):
                dfg, entry = (spec, "draft") if kind == 0 else (summ, "perceive")
                sc.submit(dfg, {entry: prompt}, origin=i % 3)
            planes[impl] = sc
        k, p = planes["auto"], planes["ref"]
        same = dict(
            assignments=[r.assignment for r in k.results] == [r.assignment for r in p.results],
            tokens=all(np.array_equal(a.outputs[t], b.outputs[t])
                       for a, b in zip(k.results, p.results) for t in b.outputs),
            sst=[dataclasses.asdict(r) for r in k.sst.view(None, 1e9)]
            == [dataclasses.asdict(r) for r in p.sst.view(None, 1e9)],
            prefetch=k.prefetch_plane.stats == p.prefetch_plane.stats,
            health=k.health.summary() == p.health.summary(),
            trace=k.recorder.to_jsonl() == p.recorder.to_jsonl())
        print(f"{sched} with gossip, prefetch, trace and health (task wall pinned to "
              f"{PINNED_WALL_S} s), kernel vs plain path: equal {same}; cache hit rate "
              f"{k.cache_hit_rate():.3f}; gossip messages {k.sst.messages_sent}; prefetches "
              f"{k.prefetch_plane.stats.prefetches_completed}; trace events "
              f"{len(k.recorder.events())}", flush=True)
        out[sched]["planes"] = dict(equal=same, cache_hit_rate=k.cache_hit_rate(),
                                    gossip_messages=k.sst.messages_sent,
                                    prefetch_stats=dataclasses.asdict(k.prefetch_plane.stats))
        if not all(same.values()):
            raise AssertionError(f"{sched} with all four options: kernel and plain path differ "
                                 f"({same})")
    return out


# ---------------------------------------------------------------------------
# phase 5: Compass on the card
# ---------------------------------------------------------------------------
#: Phase 5a's cluster sizes and the jobs planned for each DFG at each.
PLAN_JOBS = {5: 200, 250: 200, 1000: 50}
#: Every lane of the planner on: a fixed eviction penalty (the vectorized
#: planner's surrogate otherwise differs from the Python planner's by
#: design), intents priced at 70 %, the anti-herd margin, suspect rows
#: priced; the speculative cache is on by default.
PLAN_CONFIG = dict(eviction_penalty_s=1.5, intent_confidence=0.7, intent_herd_margin=0.15,
                   suspect_penalty_s=3.0)
#: A phase 5b reading may stray this far from its constant.
CONSTANT_TOL = 0.25


def plan_cluster(n):
    """``H100_CLUSTER`` at ``n`` workers over four racks (two for five
    workers), every third card an H100 NVL's 94 GB."""
    from repro_torch.core import H100_CLUSTER, rack_topology

    racks = [n // 4] * 3 + [n - 3 * (n // 4)] if n >= 8 else [n // 2, n - n // 2]
    return dataclasses.replace(
        H100_CLUSTER, n_workers=n, topology=rack_topology(racks),
        worker_gpu_capacity={w: 94e9 if w % 3 == 0 else H100_CLUSTER.gpu_capacity_bytes
                             for w in range(n)})


def plan_rows(n, n_models, rng):
    """Seeded SST rows: cache and intent bits, free cache, intents fresh
    and stale, in-flight fetches with their ETAs, dead and suspect rows."""
    import numpy as np
    from repro_torch.core import SSTRow

    bits = rng.random((n, n_models)) < 0.25
    intent = bits | (rng.random((n, n_models)) < 0.25)
    weights = 1 << np.arange(n_models)
    fetch = rng.integers(-1, n_models, n)
    live = rng.choice(["alive"] * 6 + ["suspect", "dead"], n)
    return [SSTRow(ft_estimate_s=float(rng.uniform(0, 5)),
                   cache_bitmap=int(bits[w] @ weights), free_cache_bytes=float(rng.uniform(0, 80e9)),
                   pushed_at=float(rng.choice([1.0, -30.0])), intent_bitmap=int(intent[w] @ weights),
                   liveness=str(live[w]), fetch_model_id=int(fetch[w]),
                   fetch_eta_s=float(rng.uniform(0.5, 3.0)) if fetch[w] >= 0 else 0.0)
            for w in range(n)]


def same_ft(a, b, rel):
    return a == b if math.isinf(a) or math.isinf(b) else abs(a - b) <= rel * abs(b)


def in_fresh_process(call: str):
    """``call()`` of this script run by a new Python process on the card,
    its output passed through; returns what it returns.  Phase 5 times in
    a process that never ran the profiler: after phases 1-4 had run it in
    this process, a 4 KiB copy took 30.5 µs here against 11-18 µs in fresh
    processes, and the card's plans 1.4-1.6x as long."""
    code = f"import json, chip_smoke; print(json.dumps(chip_smoke.{call}(), default=str))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    lines = out.stdout.rstrip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    if out.returncode != 0:
        print(out.stderr, file=sys.stderr)
        raise AssertionError(f"{call} in a fresh process exited with {out.returncode}")
    return json.loads(lines[-1])


def planner_on_card():
    """Phase 5a: the vectorized planner through its CUDA graphs and
    eagerly on the card, torch on the CPU and the Python Navigator plan
    the same seeded jobs of the four paper and four arch DFGs."""
    import numpy as np
    import torch
    from repro_torch.core import (FlightRecorder, Job, NavigatorConfig, NavigatorScheduler,
                                  ProfileRepository)
    from repro_torch.core.packed import PackedViews
    from repro_torch.core.torch_planner import TorchNavigatorPlanner
    from repro_torch.workflows import MODELS, paper_dfgs
    from repro_torch.workflows.arch_pipelines import arch_dfgs, arch_models

    cfg = NavigatorConfig(**PLAN_CONFIG)
    ways = ("python", "torch_cpu", "card_eager", "card_graph")
    out = {}
    for n, n_jobs in PLAN_JOBS.items():
        cluster = plan_cluster(n)
        rng = np.random.default_rng(n)
        times = {w: [] for w in ways}
        tasks = infeasible = captures = 0
        capture_ms = []
        for models, dfgs in ((MODELS, paper_dfgs()), (arch_models(), arch_dfgs())):
            profiles = ProfileRepository(cluster, models)
            for d in dfgs:
                profiles.register(d)
            py = NavigatorScheduler(profiles, cfg)
            cpu = TorchNavigatorPlanner(profiles, cfg, device="cpu")
            graphed = TorchNavigatorPlanner(profiles, cfg, device="cuda")
            # the same planner running its task loop eagerly on the card
            eager = TorchNavigatorPlanner(profiles, cfg, device="cuda")
            eager._outputs = lambda name, static, comps, p=eager: p._plan(static, comps)
            for d in dfgs:
                # the flight recorder on for one DFG: provenance from every planner
                traced = d.name == "translation"
                planners = (py, cpu, eager, graphed)
                for p in planners:
                    p.recorder = FlightRecorder(n) if traced else None
                for j in range(n_jobs):
                    rows = plan_rows(n, len(models), rng)
                    origin = int(rng.integers(n))
                    # every other job as the indexed engine's packed views (the
                    # Python planner records no provenance from those)
                    packed = j % 2 and not traced
                    sst = PackedViews.from_rows(rows, reader=origin) if packed else rows
                    job = Job(j, d, 1.0)
                    got = {}
                    for way, fn in (("python", lambda: py.plan(job, 1.0, origin, sst)),
                                    ("torch_cpu", lambda: cpu.plan(job, 1.0, origin, sst)),
                                    ("card_eager", lambda: eager.plan(job, 1.0, origin, sst)),
                                    ("card_graph", lambda: graphed.plan(job, 1.0, origin,
                                                                        sst))):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        got[way] = fn()
                        times[way].append(time.perf_counter() - t0)
                    want = got["python"]
                    for way in ways[1:]:
                        if got[way].assignment != want.assignment:
                            raise AssertionError(f"W={n} {d.name} job {j}: {way} assigns "
                                                 f"{got[way].assignment}, python "
                                                 f"{want.assignment}")
                        for t, ft in got[way].planned_ft.items():
                            if not same_ft(ft, want.planned_ft[t], 1e-5):
                                raise AssertionError(f"W={n} {d.name} job {j} {t}: {way} "
                                                     f"planned_ft {ft}, python "
                                                     f"{want.planned_ft[t]}")
                    if got["card_graph"].planned_ft != got["card_eager"].planned_ft:
                        raise AssertionError(f"W={n} {d.name} job {j}: graph and eager differ")
                    tasks += len(want.assignment)
                    infeasible += sum(math.isinf(ft) for ft in want.planned_ft.values())
                if traced:
                    check_provenance(n, d.name, *(p.recorder for p in planners))
                    for p in planners:
                        p.recorder = None
            captures += len(graphed.graphs)
            capture_ms += [g.capture_s * 1e3 for g in graphed.graphs.values()]
            if eager.graphs:
                raise AssertionError("the eager planner captured a graph")
        med = {w: statistics.median(times[w]) * 1e3 for w in ways}
        out[n] = dict(jobs=n_jobs * 8, tasks=tasks, infeasible_tasks=infeasible,
                      graphs=captures, capture_ms=capture_ms, median_ms=med)
        print(f"W={n}: {n_jobs} jobs x 8 DFGs, {tasks} tasks ({infeasible} fit no worker), "
              f"{captures} graphs (capture {min(capture_ms):.1f}-{max(capture_ms):.1f} ms); "
              f"median plan ms: "
              + ", ".join(f"{w} {med[w]:.3f}" for w in ways), flush=True)
    return out


def check_provenance(n, name, py, cpu, eager, card):
    """The recorded Eq. 2 candidates: the torch planners' JSONL equal (CPU,
    card eager, card graph), their totals within 1e-3 s of the Python
    planner's (as ``tests/test_telemetry.py`` holds the JAX planner's)."""
    if not cpu.to_jsonl() == eager.to_jsonl() == card.to_jsonl():
        raise AssertionError(f"W={n} {name}: the card's provenance differs from the CPU's")
    decisions = 0
    for dp, dc in zip(py.placements, card.placements):
        if (dp.job_id, dp.task_id, dp.chosen) != (dc.job_id, dc.task_id, dc.chosen):
            raise AssertionError(f"W={n} {name}: provenance of {dp.task_id} differs")
        for cp, cc in zip(dp.candidates, dc.candidates):
            if not (cp.worker == cc.worker and (cp.total_s == cc.total_s
                                                or abs(cp.total_s - cc.total_s) <= 1e-3)):
                raise AssertionError(f"W={n} {name} {dp.task_id} worker {cp.worker}: "
                                     f"total {cc.total_s} against python {cp.total_s}")
        decisions += 1
    if decisions != len(py.placements) or not decisions:
        raise AssertionError(f"W={n} {name}: {decisions} decisions recorded")
    print(f"W={n} {name}: {decisions} recorded decisions agree", flush=True)


def profiles_on_card(prefill, idle_w):
    """Phase 5b: the readings behind ``H100_CLUSTER`` and the arch
    pipelines' rate, beside the constants; a constant more than
    ``CONSTANT_TOL`` from this run's reading fails."""
    from repro_torch import probe
    from repro_torch.configs import ARCHS
    from repro_torch.core import H100_CLUSTER
    from repro_torch.workflows import arch_pipelines

    link = probe.fresh_readings()
    nemo = next(v for k, v in prefill.items() if k.startswith("mistral-nemo-12b"))
    n = ARCHS["mistral-nemo-12b"].param_count()
    flops = 2.0 * n * PREFILL_B * PREFILL_S
    rate = flops / nemo["wall_s"][-1]  # the second call: the first builds and loads
    rows = [
        ("host->device rate (B/s)", link["bandwidth_bytes_per_s"],
         H100_CLUSTER.link.bandwidth_bytes_per_s),
        ("host->device 4 KiB latency (s)", link["delta_s"], H100_CLUSTER.link.delta_s),
        ("device->device 4 KiB latency (s)", link["d2d_delta_s"], H100_CLUSTER.network.delta_s),
        ("idle power.draw (W)", idle_w, H100_CLUSTER.gpu_power_idle_w),
        ("power.limit (W)", probe.power_limit_w(), H100_CLUSTER.gpu_power_active_w),
        ("bf16 prefill rate (FLOP/s)", rate, arch_pipelines._UTILIZED_FLOPS),
    ]
    out, bad = {}, []
    for what, reading, constant in rows:
        off = abs(constant - reading) / reading
        print(f"{what}: read {reading!r}, constant {constant!r} ({off:.1%} apart)")
        out[what] = dict(reading=reading, constant=constant, apart=off)
        if off > CONSTANT_TOL:
            bad.append(what)
    print(f"NeMo prefill: {flops:.4e} FLOP in {nemo['wall_s'][-1]!r} s")
    if bad:
        raise AssertionError(f"constants more than {CONSTANT_TOL:.0%} from this card: {bad}")
    return out


def compass_simulator():
    """Phase 5c: the port's quickstart comparison (the paper's four
    workflows on five workers, Poisson 2 jobs/s for 300 s, seed 7), then
    the arch pipelines under Navigator and Hash.  ``H100_CLUSTER``'s
    workers are single 80 GB cards, which hold none of the four arch
    pipelines (llama3-405b alone needs 1.30 TB with its cached copy): the
    simulator refuses them there, so they run on eight pods of 24 cards
    (three HGX nodes, 1.92 TB), each fed by 24 of the card's host links."""
    from repro_torch.core import H100_CLUSTER, AcceleratorLink, ClusterSpec, ProfileRepository
    from repro_torch.sim import Simulation, poisson_workload
    from repro_torch.workflows import MODELS, paper_dfgs
    from repro_torch.workflows.arch_pipelines import arch_dfgs, arch_models

    def run(cluster, models, dfgs, sched, rate, duration, seed, sim_seed):
        profiles = ProfileRepository(cluster, models)
        for d in dfgs:
            profiles.register(d)
        jobs = poisson_workload(dfgs, rate, duration, seed=seed)
        t0 = time.perf_counter()
        res = Simulation(cluster, profiles, models, scheduler=sched, seed=sim_seed).run(jobs)
        if len(res.records) != len(jobs):
            raise AssertionError(f"{sched}: {len(res.records)} of {len(jobs)} jobs completed")
        return res, time.perf_counter() - t0

    def table(title, cluster, models, dfgs, scheds, rate, duration, seed, sim_seed):
        print(title)
        print(f"{'scheduler':>10} | {'mean lat':>8} | {'slowdown':>8} | {'hit rate':>8} | "
              f"{'GPU util':>8} | {'jobs':>5} | {'host s':>6}")
        rows = {}
        for sched in scheds:
            res, wall = run(cluster, models, dfgs, sched, rate, duration, seed, sim_seed)
            rows[sched] = dict(mean_latency=res.mean_latency, slowdown=res.mean_slowdown,
                               hit_rate=res.cache_hit_rate, gpu_util=res.gpu_utilization,
                               jobs=len(res.records), host_s=wall)
            print(f"{sched:>10} | {res.mean_latency:7.2f}s | {res.mean_slowdown:8.2f} | "
                  f"{res.cache_hit_rate * 100:7.1f}% | {res.gpu_utilization * 100:7.1f}% | "
                  f"{len(res.records):5d} | {wall:6.2f}", flush=True)
        return rows

    quick = table("quickstart: 5 workers, Poisson 2 jobs/s for 300 s, seed 7",
                  ClusterSpec(n_workers=5), MODELS, paper_dfgs(),
                  ("navigator", "jit", "heft", "hash"), 2.0, 300.0, 7, 1)
    try:
        run(H100_CLUSTER, arch_models(), arch_dfgs(), "navigator", 1.2, 10.0, 5, 1)
    except ValueError as e:
        print(f"arch pipelines on H100_CLUSTER, refused as expected: {e}")
    else:
        raise AssertionError("H100_CLUSTER ran the arch pipelines on single cards")
    cards = 24
    pods = dataclasses.replace(
        H100_CLUSTER, gpu_capacity_bytes=cards * H100_CLUSTER.gpu_capacity_bytes,
        link=AcceleratorLink(cards * H100_CLUSTER.link.bandwidth_bytes_per_s,
                             H100_CLUSTER.link.delta_s))
    arch = table(f"arch pipelines: 8 pods of {cards} H100s, Poisson 1.2 jobs/s for 300 s, seed 5",
                 pods, arch_models(), arch_dfgs(), ("navigator", "hash"), 1.2, 300.0, 5, 1)
    if not arch["navigator"]["hit_rate"] > arch["hash"]["hit_rate"]:
        raise AssertionError(f"Navigator's hit rate {arch['navigator']['hit_rate']} does not "
                             f"exceed Hash's {arch['hash']['hit_rate']}")
    return dict(quickstart=quick, arch=arch)


# ---------------------------------------------------------------------------
# phase 6: training at full width
# ---------------------------------------------------------------------------
TRAIN_MODEL = "mistral-nemo-12b"
TRAIN_LAYERS = 8          # of NeMo's 40: 3.52 B parameters
TRAIN_LAYERS_CUT = 6      # where 8 layers pass TRAIN_PEAK_BYTES
TRAIN_PEAK_BYTES = 70e9
TRAIN_STEPS = 5           # timed, after one warm-up step
TRAIN_COMPARE_LAYERS = 2  # the kernel path against the plain path
# the 2-layer step held kernel path against plain path: each leaf's
# gradient at cosine >= 0.99 and max error within this share of the leaf's
# largest |gradient| (bf16 rounds the two paths' products differently)
TRAIN_COS = 0.99
TRAIN_LEAF_TOL = 0.05


def train_step_run(cfg, steps, probe="wq"):
    """``make_train_step`` (remat, fp32 AdamW moments) on ``cfg`` over the
    synthetic pipeline: one warm-up step, then ``steps`` timed steps, the
    counts set to 0 just before them and read just after (every kernel's,
    forward and backward, by body); the first values of the layers' leaf
    ``probe`` show that the params moved."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_bwd as gb
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssd_scan_bwd as sb
    from repro_torch.models import init_params
    from repro_torch.training import make_train_step, optimizer as opt

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(17), dev)
    state = opt.init(params)
    n = cfg.param_count()
    step = make_train_step(cfg, opt.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100),
                           device=dev)
    data = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=PREFILL_S, global_batch=PREFILL_B,
                                    seed=3))
    probe_leaf = params["layers"].get_parameter(probe).detach().flatten()[:4096].clone()
    params, state, metrics = step(params, state, next(data))  # warm-up
    torch.cuda.synchronize()
    warm_loss = float(metrics["loss"])
    batches = [next(data) for _ in range(steps)]
    read = counts_zeroed()
    walls, losses, norms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = read()
    fwd_by_body, bwd_launches = dict(fa.launches_by_body), fb.launches
    bwd_by_body = dict(fb.launches_by_body)
    by_body = {name: dict(counts) for name, counts in (
        ("ssd_scan", ssd.launches_by_body), ("ssd_scan_bwd", sb.launches_by_body),
        ("flash_attention", fa.launches_by_body), ("flash_attention_bwd", fb.launches_by_body),
        ("moe_gmm", gmm.launches_by_body), ("moe_gmm_dx", gb.dx_by_body),
        ("moe_gmm_dw", gb.dw_by_body), ("decode_attention", da.launches_by_body))}
    peak = torch.cuda.max_memory_allocated()
    moved = float((params["layers"].get_parameter(probe).detach().flatten()[:4096]
                   - probe_leaf).abs().max())
    out = dict(layers=cfg.n_layers, params=n, steps=steps, wall_s=walls, losses=losses,
               grad_norms=norms, warm_up_loss=warm_loss, launches=launches,
               flash_by_body=fwd_by_body, bwd_launches=bwd_launches, bwd_by_body=bwd_by_body,
               by_body=by_body, peak_bytes=peak, moved=moved)
    return params, state, step, data, out


def train_full_width():
    """Phase 6: NeMo at full width and 8 of its 40 layers, bf16 params and
    fp32 AdamW moments, B = 2, S = 2048 of the synthetic pipeline, through
    ``make_train_step`` with remat: one warm-up step and five timed steps,
    every flash forward and backward on wgmma, the counts per
    step, finite losses, moved params, the step time, tokens/s, 6·N·tokens
    over the step time, the peak memory and the device's busy share; then
    one step's loss, grad-norm and per-leaf gradients at 2 layers, kernel
    path against plain path."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models import init_params

    release_models()
    dev = torch.device("cuda")
    base = ARCHS[TRAIN_MODEL]
    cfg = dataclasses.replace(base, n_layers=TRAIN_LAYERS)
    print(f"{TRAIN_MODEL} depth cut: {base.n_layers} -> {TRAIN_LAYERS} layers "
          f"({cfg.param_count() / 1e9:.2f} B parameters; bf16 params and grads, fp32 AdamW "
          f"moments)", flush=True)
    params, state, step, data, out = train_step_run(cfg, TRAIN_STEPS)
    cut = None
    if out["peak_bytes"] > TRAIN_PEAK_BYTES:
        cut = (f"{TRAIN_LAYERS} layers peaked at {out['peak_bytes'] / 1e9:.1f} GB, above "
               f"{TRAIN_PEAK_BYTES / 1e9:.0f} GB: {TRAIN_LAYERS_CUT} layers")
        print(f"cut: {cut}", flush=True)
        del params, state, step, data
        release_models()
        cfg = dataclasses.replace(base, n_layers=TRAIN_LAYERS_CUT)
        params, state, step, data, out = train_step_run(cfg, TRAIN_STEPS)
    out["cut"] = cut
    layers, steps = cfg.n_layers, TRAIN_STEPS
    want_fwd, want_bwd = steps * layers * 2, steps * layers
    tokens = PREFILL_B * PREFILL_S
    med = statistics.median(out["wall_s"])
    out.update(step_s=med, tokens_per_s=tokens / med,
               tflops=6.0 * out["params"] * tokens / med / 1e12)
    print(f"{TRAIN_MODEL}@{layers}: {out['params'] / 1e9:.3f} B params; steps "
          f"{', '.join(f'{w:.4f}' for w in out['wall_s'])} s (median {med:.4f} s), "
          f"{out['tokens_per_s']:.0f} tokens/s, 6·N·tokens/step time = {out['tflops']:.1f} "
          f"TFLOP/s; peak {out['peak_bytes'] / 1e9:.2f} GB; losses "
          f"{', '.join(f'{x:.4f}' for x in out['losses'])} (warm-up {out['warm_up_loss']:.4f}); "
          f"grad norms {', '.join(f'{x:.3f}' for x in out['grad_norms'])}; "
          f"flash launches {out['launches']['flash_attention']} (expected {want_fwd}) by body "
          f"{out['flash_by_body']}; backward launches {out['bwd_launches']} (expected "
          f"{want_bwd}) by body {out['bwd_by_body']}; params moved by {out['moved']:.3e}",
          flush=True)
    if not all(np.isfinite(out["losses"])) or not all(np.isfinite(out["grad_norms"])):
        raise AssertionError("non-finite training loss or grad norm")
    if not out["moved"] > 0:
        raise AssertionError("the params did not move")
    if out["launches"]["flash_attention"] != want_fwd or out["flash_by_body"] != {"wgmma": want_fwd}:
        raise AssertionError(f"flash forward launches {out['flash_by_body']}, expected "
                             f"{want_fwd} on wgmma")
    bwd_body = fb.body_for(torch.bfloat16, cfg.head_dim)
    if out["bwd_launches"] != want_bwd or out["bwd_by_body"] != {bwd_body: want_bwd}:
        raise AssertionError(f"flash backward launches {out['bwd_by_body']}, expected "
                             f"{want_bwd} on {bwd_body}")
    others = {k: v for k, v in out["launches"].items() if k != "flash_attention" and v}
    if others:
        raise AssertionError(f"training launched other kernels: {others}")
    batch = next(data)
    out["profile"] = profile_call(lambda: step(params, state, batch),
                                  f"one {TRAIN_MODEL}@{layers} train step", top=15)
    del params, state, step, data
    release_models()

    # the kernel path against the plain path, at 2 layers
    cfg2 = dataclasses.replace(base, n_layers=TRAIN_COMPARE_LAYERS)
    params = init_params(cfg2, torch.Generator(device=dev).manual_seed(19), dev)
    params.requires_grad_(True)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    out["compare"] = dict(layers=TRAIN_COMPARE_LAYERS, **grad_paths(
        cfg2, params, toks, f"{TRAIN_MODEL}@{TRAIN_COMPARE_LAYERS}"))
    del params, toks
    release_models()
    return out


# ---------------------------------------------------------------------------
# phase 6b: the SSM, hybrid and MoE families training through their kernels
# ---------------------------------------------------------------------------
# (model, layers): mamba2 whole; zamba2 cut to 12 layers, where its shared
# attention block (every 6 layers) runs twice; Qwen3-MoE cut to 4 of its 48
# layers (the sorted dispatch)
FAMILY_TRAIN = (("mamba2-780m", None), ("zamba2-7b", 12), ("qwen3-moe-30b-a3b", 4))
#: The leaf whose first values show that a step moved the params.
FAMILY_PROBE = {"ssm": "w_in", "hybrid": "w_in", "moe": "moe.wg"}
#: The families whose step is profiled once after the timed steps, and the
#: backward kernels whose device time a step is read there (by name: the
#: SSD backward's four launches on either body; dw on either body).
FAMILY_PROFILE = {"mamba2-780m": ("ssd_scan_bwd", ("ssd_bwd_", "ssd_chunk_state_mma_kernel<true>")),
                  "qwen3-moe-30b-a3b": ("moe_gmm_dw", ("gmm_wgrad",))}


def step_profile(step, params, state, batch, what, names):
    """One more train step under the profiler (``profiled``): the device
    time of the step's records, and that of the records whose kernel name
    holds one of ``names``, with their count and names."""
    records, wall_ms, attempts = profiled(lambda: step(params, state, batch), what)
    import re

    mine = [e for e in records if any(k in e.name() for k in names)]
    kinds = collections.Counter(
        next(iter(re.findall(r"\w*kernel\w*(?:<[^>]*>)?", e.name())), e.name()) for e in mine)
    return dict(wall_ms=wall_ms, device_ms=sum(e.duration_ns() for e in records) / 1e6,
                kernel_ms=sum(e.duration_ns() for e in mine) / 1e6, launches=len(mine),
                kernels=dict(kinds), records=len(records), attempts=attempts)


class RouteReplay:
    """The MoE router's expert ids, recorded on one path of a comparison
    (``recording``) and replayed on the other (``replaying``, call by call
    in the same order): a near tie that bf16 breaks one way on the kernel
    path and the other way on the plain path would move a token's gradient
    to another expert, which says nothing about the kernels.  The replay
    keeps that path's own ``route`` for everything but the ids: its aux
    loss, and its probabilities (``route`` over all experts) from which
    the recorded ids' gates are gathered and renormalised as ``route``
    does.  ``flips`` counts, per replayed call, the tokens whose own top-k
    differs from the recorded one."""

    def __init__(self):
        from repro_torch.models import moe as moe_mod

        self.module, self.route, self.ids, self.flips = moe_mod, moe_mod.route, [], []

    @contextlib.contextmanager
    def recording(self):
        def recorded(x, router_w, top_k):
            gates, idx, aux = self.route(x, router_w, top_k)
            self.ids.append(idx)
            return gates, idx, aux

        self.module.route = recorded
        try:
            yield self
        finally:
            self.module.route = self.route

    @contextlib.contextmanager
    def replaying(self):
        import torch

        calls = iter(self.ids)

        def replayed(x, router_w, top_k):
            idx = next(calls)
            _, own, aux = self.route(x, router_w, top_k)
            self.flips.append(int((own.sort(-1).values != idx.sort(-1).values).any(-1).sum()))
            ranked, order, _ = self.route(x, router_w, router_w.shape[-1])
            probs = torch.empty_like(ranked).scatter_(-1, order, ranked)
            gates = probs.gather(-1, idx)
            return gates / gates.sum(dim=-1, keepdim=True), idx, aux

        self.module.route = replayed
        try:
            yield self
        finally:
            self.module.route = self.route
        if next(calls, None) is not None:
            raise AssertionError("the plain path routed fewer times than the kernel path")


def grad_paths(cfg, params, toks, what):
    """One step's loss, grad norm and every leaf's gradient, kernel path
    (``impl="auto"``) against plain path (``impl="ref"``), remat on, each
    leaf held at cosine >= ``TRAIN_COS`` and max error within
    ``TRAIN_LEAF_TOL`` of the leaf's largest |gradient|; an MoE model's
    routing recorded on the kernel path and replayed on the plain one
    (:class:`RouteReplay`)."""
    import torch
    from repro_torch.models import next_token_loss

    replay = RouteReplay() if cfg.arch_type == "moe" else None
    runs = {}
    for impl in ("auto", "ref"):
        ctx = (contextlib.nullcontext() if replay is None
               else replay.recording() if impl == "auto" else replay.replaying())
        with ctx:
            loss = next_token_loss(params, {"tokens": toks}, cfg, impl=impl, remat=True)
            loss.backward()
        # a leaf the step does not reach (zamba2's shared block below its
        # period) has no gradient on either path
        grads = {n: p.grad.float() for n, p in params.named_parameters() if p.grad is not None}
        norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        runs[impl] = (float(loss.detach()), norm, grads)
        params.zero_grad(set_to_none=True)
    (la, na, ga), (lr_, nr, gr) = runs["auto"], runs["ref"]
    if ga.keys() != gr.keys():
        raise AssertionError(f"{what}: the two paths reach different leaves: "
                             f"{sorted(ga.keys() ^ gr.keys())}")
    leaves = {}
    for n, g in gr.items():
        cos = float(torch.nn.functional.cosine_similarity(ga[n].flatten(), g.flatten(), dim=0))
        rel = float((ga[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
        leaves[n] = dict(cosine=cos, max_err_share=rel)
    worst_cos = min(v["cosine"] for v in leaves.values())
    worst_rel = max(v["max_err_share"] for v in leaves.values())
    flips = replay.flips if replay is not None else None
    print(f"{what} one step, kernel path against plain path: loss {la:.5f} / {lr_:.5f}, grad "
          f"norm {na:.5f} / {nr:.5f}; per leaf: lowest cosine {worst_cos:.5f}, largest max "
          f"error {worst_rel:.4f} of the leaf's largest"
          + (f"; routing replayed, tokens whose own top-k differed per call {flips}"
             if flips is not None else ""), flush=True)
    for n, v in sorted(leaves.items()):
        print(f"  {n}: cosine {v['cosine']:.5f}, max err {v['max_err_share']:.4f}")
    out = dict(loss=(la, lr_), grad_norm=(na, nr), leaves=leaves, route_flips=flips)
    if not (abs(la - lr_) <= TOL["bfloat16"] * abs(lr_) and abs(na - nr) <= TOL["bfloat16"] * nr):
        raise AssertionError(f"{what}: the kernel path's loss or grad norm differs from the "
                             f"plain path's")
    if worst_cos < TRAIN_COS or worst_rel > TRAIN_LEAF_TOL:
        raise AssertionError(f"{what}: gradients differ: cosine {worst_cos}, max err {worst_rel}")
    return out


def family_train_expected(cfg, steps):
    """Each kernel's launches over ``steps`` train steps (remat: every
    forward twice a step, every backward once), by body."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import moe_gmm_bwd as gb
    from repro_torch.kernels import ssd_scan_bwd as sb

    n, at = cfg.n_layers, cfg.arch_type
    ssm = n if at in ("ssm", "hybrid") else 0
    attn = n // cfg.attn_period if at == "hybrid" else n if at == "moe" else 0
    moe = n if at == "moe" else 0
    bf16 = torch.bfloat16
    hd = cfg.head_dim
    return {
        "ssd_scan": {"chunked": 2 * steps * ssm} if ssm else {},
        "ssd_scan_bwd": {sb.body_for(bf16): steps * ssm} if ssm else {},
        "flash_attention": {fa.body_for(bf16, hd): 2 * steps * attn} if attn else {},
        "flash_attention_bwd": {fb.body_for(bf16, hd): steps * attn} if attn else {},
        "moe_gmm": ({gmm.body_for(bf16, cfg.d_model, cfg.d_ff_expert, n_experts=cfg.n_experts):
                     6 * steps * moe} if moe else {}),
        "moe_gmm_dx": ({gmm.body_for(bf16, cfg.d_ff_expert, cfg.d_model,
                                     n_experts=cfg.n_experts): 3 * steps * moe} if moe else {}),
        "moe_gmm_dw": ({gb.dw_bodies_for(bf16, cfg.d_model, cfg.d_ff_expert, True,
                                         cfg.n_experts)[0]: 3 * steps * moe} if moe else {}),
        "decode_attention": {},
    }


def train_families():
    """Phase 6b: mamba2-780m whole, zamba2-7b at 12 layers and Qwen3-MoE
    at 4 layers, full width, bf16 params and fp32 AdamW moments, B = 2,
    S = 2048 of the synthetic pipeline, through ``make_train_step`` (remat,
    the sorted dispatch): one warm-up and five timed steps each, the
    counts set to 0 just before them (the SSD scan's forward and backward,
    the grouped matmul's forward, dx and dw, flash where the model has
    attention, each against what the layers and remat predict, by body),
    finite losses, moved params, the step time, tokens/s and peak memory;
    for the families of ``FAMILY_PROFILE`` one more step under the
    profiler; then each family at 2 layers, kernel path against plain
    path."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    release_models()
    dev = torch.device("cuda")
    out = {}
    for name, layers in FAMILY_TRAIN:
        base = ARCHS[name]
        cfg = base if layers is None else dataclasses.replace(base, n_layers=layers)
        cut = None if layers is None else f"{base.n_layers} -> {layers} layers"
        params, state, step, data, row = train_step_run(cfg, TRAIN_STEPS,
                                                        FAMILY_PROBE[cfg.arch_type])
        batch = next(data)
        if name in FAMILY_PROFILE:  # the backward kernels' share of a step, from the card
            kernel, names = FAMILY_PROFILE[name]
            prof = step_profile(step, params, state, next(data), f"{name} step", names)
            row["profile"] = dict(kernel=kernel, **prof)
            print(f"{name}@{cfg.n_layers} one step under the profiler: {prof['wall_ms']:.2f} ms "
                  f"wall, {prof['device_ms']:.2f} ms of device records; {kernel}: "
                  f"{prof['kernel_ms']:.3f} ms in {prof['launches']} launches "
                  f"({100 * prof['kernel_ms'] / prof['device_ms']:.1f} % of the device time; "
                  f"{prof['kernels']})", flush=True)
        del params, state, step, data
        release_models()
        med = statistics.median(row["wall_s"])
        tokens = PREFILL_B * PREFILL_S
        want = family_train_expected(cfg, TRAIN_STEPS)
        row.update(cut=cut, step_s=med, tokens_per_s=tokens / med, expected_by_body=want)
        print(f"{name}@{cfg.n_layers}{f' (cut {cut})' if cut else ''}: "
              f"{row['params'] / 1e9:.3f} B params; steps "
              f"{', '.join(f'{w:.4f}' for w in row['wall_s'])} s (median {med:.4f} s), "
              f"{tokens / med:.0f} tokens/s; peak {row['peak_bytes'] / 1e9:.2f} GB; losses "
              f"{', '.join(f'{x:.4f}' for x in row['losses'])} (warm-up "
              f"{row['warm_up_loss']:.4f}); grad norms "
              f"{', '.join(f'{x:.3f}' for x in row['grad_norms'])}; launches by body "
              f"{row['by_body']} (expected {want}); params moved by {row['moved']:.3e}",
              flush=True)
        if not all(np.isfinite(row["losses"])) or not all(np.isfinite(row["grad_norms"])):
            raise AssertionError(f"{name}: non-finite training loss or grad norm")
        if not row["moved"] > 0:
            raise AssertionError(f"{name}: the params did not move")
        if row["by_body"] != want:
            raise AssertionError(f"{name}: launches by body {row['by_body']}, expected {want}")

        # the kernel path against the plain path, at 2 layers
        cfg2 = dataclasses.replace(base, n_layers=TRAIN_COMPARE_LAYERS)
        params = init_params(cfg2, torch.Generator(device=dev).manual_seed(19), dev)
        params.requires_grad_(True)
        toks = torch.as_tensor(batch["tokens"], device=dev)
        row["compare"] = dict(layers=TRAIN_COMPARE_LAYERS, **grad_paths(
            cfg2, params, toks, f"{name}@{TRAIN_COMPARE_LAYERS}"))
        del params, toks
        release_models()
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# phase 7: the mesh at world size 1 (NCCL)
# ---------------------------------------------------------------------------
MESH_SERVE = dict(model="mistral-nemo-12b", batch=4, capacity=256, tokens=64)
MESH_EP_MODEL = "qwen3-moe-30b-a3b"
MESH_TRAIN_LAYERS = 2     # NeMo at full width
MESH_TRAIN_STEPS = 3
MESH_TRAIN_REL = 1e-6     # loss, grad norm and params against the mesh-less step
SST_EXCHANGES = 200


def mesh_serve(mesh):
    """7a: ``launch.serve``'s step on NeMo at full width in bf16 over DTensor
    params, timed, with its launches (every decode launch on split); then
    the same step beside the mesh-less ``make_serve_step`` on the same
    params and cache, logits bit for bit and tokens equal each step."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.device import mesh_device
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import init_cache, sharding
    from repro_torch.training import make_serve_step

    cfg = ARCHS[MESH_SERVE["model"]]
    b, cap, n_tok = MESH_SERVE["batch"], MESH_SERVE["capacity"], MESH_SERVE["tokens"]
    read = counts_zeroed()
    run = launch_serve.serve(cfg, mesh, batch=b, capacity=cap, tokens=n_tok, seed=13)
    launches, by_body = read(), bodies()
    want = cfg.n_layers * n_tok
    out = dict(model=cfg.name, batch=b, capacity=cap, tokens=n_tok, path=run["path"],
               ms_per_step=run["ms_per_step"], tokens_per_s=run["tokens_per_s"],
               launches=launches, launches_by_body=by_body)
    print(f"7a {cfg.name} launch.serve over the mesh (bf16, B={b}, capacity {cap}, {n_tok} "
          f"tokens): {run['ms_per_step']:.2f} ms a step, {run['tokens_per_s']:.1f} tokens/s; "
          f"launches {launches} by body {by_body}", flush=True)
    if launches != dict(decode_attention=want, flash_attention=0, ssd_scan=0, moe_gmm=0) \
            or by_body["decode_attention"] != {"split": want}:
        raise AssertionError(f"7a: launches {launches} by body {by_body}, expected {want} "
                             f"decode launches on split")
    params = run.pop("params")
    dev = mesh_device(mesh)
    sharded = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
    cache = init_cache(cfg, b, cap, device=dev)
    mcache = sharding.shard_tree(init_cache(cfg, b, cap, device=dev), mesh,
                                 sharding.cache_pspecs(mesh, cache))
    plain, meshed = make_serve_step(cfg, device=dev), make_serve_step(cfg, mesh=mesh)
    tok = torch.ones((b,), dtype=torch.int32, device=dev)
    equal, same_tokens, walls = True, True, dict(plain=[], mesh=[])
    for i in range(n_tok):
        for way, fn in (("plain", lambda: plain(params, cache, tok)),
                        ("mesh", lambda: meshed(sharded, mcache, tok))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_i, _ = fn()
            torch.cuda.synchronize()
            walls[way].append(time.perf_counter() - t0)
            if way == "plain":
                want_logits = logits_i
        equal &= bool(torch.equal(logits_i.full_tensor(), want_logits))
        tok = want_logits.argmax(-1).to(torch.int32)
        same_tokens &= bool((tok.cpu().numpy() == run["tokens"][i]).all())
    med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    out.update(logits_bitwise_equal=equal, tokens_equal=same_tokens, side_by_side_ms=med)
    print(f"7a mesh step against the mesh-less step, {n_tok} steps: logits bit for bit "
          f"{equal}, tokens equal {same_tokens}; median ms a step (eager, host clock, in "
          f"turns): mesh {med['mesh']:.2f}, mesh-less {med['plain']:.2f}", flush=True)
    if not (equal and same_tokens):
        raise AssertionError("7a: the mesh step differs from the mesh-less step")
    return out


def mesh_ep(mesh):
    """7b: Qwen3-MoE at full width and depth, prefill of B = 2, S = 2048
    through ``forward`` with the ``ep`` dispatch over the mesh (at
    |model| = 1 with capacity factor 1.5 nothing is dropped), its launches
    by body and its grouped-matmul kernels counted by the profiler, held
    against the ``sorted`` dispatch as phase 3c holds its logits."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import forward

    cfg, params, out = load_full_width(MESH_EP_MODEL)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                                     device=dev)}
    n = cfg.n_layers
    with torch.no_grad():
        forward(params, batch, cfg, moe_dispatch="ep", mesh=mesh)  # warm-up
        torch.cuda.synchronize()
        read = counts_zeroed()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ep_logits, ep_aux = forward(params, batch, cfg, moe_dispatch="ep", mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, by_body = read(), bodies()
        sorted_logits, sorted_aux = forward(params, batch, cfg, moe_dispatch="sorted")
    profiled = {k: sum(e.count for e in prof.key_averages()
                       if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                       and k in e.key)
                for k in ("gmm_wgmma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel")}
    want = dict(decode_attention=0, flash_attention=n, ssd_scan=0, moe_gmm=3 * n)
    cmp = compare_logits(f"7b {cfg.name} prefill logits, ep against sorted (bf16, {n} layers)",
                         ep_logits[:, -1].float(), sorted_logits[:, -1].float())
    cmp.update(argmax_agreement(ep_logits, sorted_logits, ep_logits[:, -1],
                                sorted_logits[:, -1]))
    cmp["bitwise_equal"] = bool(torch.equal(ep_logits, sorted_logits))
    cmp["aux"] = (float(ep_aux), float(sorted_aux))
    out.update(wall_s=wall, launches=launches, launches_by_body=by_body,
               profiled_gmm_kernels=profiled, ep_vs_sorted=cmp)
    print(f"7b {cfg.name} ep prefill B={PREFILL_B} S={PREFILL_S}: wall {wall:.3f} s (under the "
          f"profiler); launches {launches} by body {by_body}; the profiler's grouped-matmul "
          f"kernels {profiled}; argmax equal at {cmp['argmax_share']:.4f}, bit for bit "
          f"{cmp['bitwise_equal']}, aux {cmp['aux']}", flush=True)
    del params, ep_logits, sorted_logits
    release_models()
    if launches != want or by_body["moe_gmm"] != {"wgmma": 3 * n} \
            or by_body["flash_attention"] != {"wgmma": n} or profiled["gmm_wgmma_kernel"] != 3 * n:
        raise AssertionError(f"7b: launches {launches} by body {by_body}, profiled {profiled}; "
                             f"expected {want}, all on wgmma")
    if cmp["ratio"] > TOL["bfloat16"] or cmp["argmax_share"] < ARGMAX_SHARE:
        raise AssertionError("7b: the ep dispatch's logits differ from the sorted dispatch's")
    return out


def mesh_train(mesh):
    """7c: three steps of ``make_train_step`` over the mesh (DTensor params
    and moments, each layer's weights gathered on use) on NeMo at full
    width and 2 layers, against three mesh-less steps from the same
    weights and batches: loss, grad norm and every updated param within
    ``MESH_TRAIN_REL``; the mesh run's flash launches, forward and
    backward, by body."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models import init_params, sharding
    from repro_torch.training import make_train_step, optimizer as opt

    dev = torch.device("cuda")
    cfg = dataclasses.replace(ARCHS[TRAIN_MODEL], n_layers=MESH_TRAIN_LAYERS)
    data = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=PREFILL_S, global_batch=PREFILL_B,
                                    seed=3))
    batches = [next(data) for _ in range(MESH_TRAIN_STEPS)]
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    runs = {}
    for way in ("mesh-less", "mesh"):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(19), dev)
        if way == "mesh":
            params = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
            step = make_train_step(cfg, ocfg, mesh=mesh)
        else:
            step = make_train_step(cfg, ocfg, device=dev)
        state = opt.init(params)
        read = counts_zeroed()
        walls, metrics = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[way] = dict(walls=walls, metrics=metrics, launches=read(), by_body=bodies(),
                         bwd=fb.launches, bwd_by_body=dict(fb.launches_by_body),
                         params={p: t.detach().clone() for p, t in
                                 opt.leaves(sharding.gather_tree(params))})
        del params, state, step
        release_models()
    a, b = runs["mesh"], runs["mesh-less"]
    worst = max(float((a["params"][p].float() - t.float()).abs().max())
                / max(float(t.float().abs().max()), 1e-30) for p, t in b["params"].items())
    rel = max(abs(x - y) / abs(y) for ma, mb in zip(a["metrics"], b["metrics"])
              for x, y in zip(ma, mb))
    want_fwd, want_bwd = MESH_TRAIN_STEPS * MESH_TRAIN_LAYERS * 2, MESH_TRAIN_STEPS * MESH_TRAIN_LAYERS
    out = dict(layers=MESH_TRAIN_LAYERS, steps=MESH_TRAIN_STEPS, mesh_walls=a["walls"],
               plain_walls=b["walls"], metrics=a["metrics"], plain_metrics=b["metrics"],
               worst_metric_rel=rel, worst_param_rel=worst, launches=a["launches"],
               flash_by_body=a["by_body"]["flash_attention"], bwd_launches=a["bwd"],
               bwd_by_body=a["bwd_by_body"])
    print(f"7c {TRAIN_MODEL}@{MESH_TRAIN_LAYERS} train step over the mesh: "
          f"{', '.join(f'{w:.4f}' for w in a['walls'])} s (mesh-less "
          f"{', '.join(f'{w:.4f}' for w in b['walls'])} s); loss, grad norm {a['metrics']}; "
          f"largest difference from the mesh-less step: metrics {rel:.2e}, params {worst:.2e} of "
          f"each leaf's largest; flash launches {a['launches']['flash_attention']} by body "
          f"{out['flash_by_body']} (expected {want_fwd}), backward {a['bwd']} by body "
          f"{a['bwd_by_body']} (expected {want_bwd})", flush=True)
    if rel > MESH_TRAIN_REL or worst > MESH_TRAIN_REL:
        raise AssertionError(f"7c: the mesh step differs from the mesh-less step ({rel}, {worst})")
    if a["launches"]["flash_attention"] != want_fwd or a["bwd"] != want_bwd \
            or out["flash_by_body"] != {"wgmma": want_fwd} or a["bwd_by_body"] != {"wgmma": want_bwd}:
        raise AssertionError(f"7c: flash launches {out}, expected {want_fwd} forward and "
                             f"{want_bwd} backward on wgmma")
    return out


def mesh_sst(mesh):
    """7d: the SST all-gather over NCCL: this rank's packed row against the
    table bit for bit, and the time of one exchange."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import SSTRow
    from repro_torch.core.sst_exchange import make_sst_allgather, pack_row

    exchange = make_sst_allgather(mesh, axis="data")
    rows = pack_row(SSTRow(ft_estimate_s=3.25, cache_bitmap=(1 << 40) | 7, free_cache_bytes=4096.0,
                           version=9, heartbeat_s=1.5, epoch=2), queue_len=4)[None]
    local = torch.as_tensor(rows, device="cuda")
    table = exchange(local)
    exchange(local)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SST_EXCHANGES):
        exchange(local)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / SST_EXCHANGES * 1e6
    same = bool(np.array_equal(table.cpu().numpy(), rows))
    print(f"7d SST all-gather over {dist.get_backend()} ({mesh.size()} rank): bit for bit {same}, "
          f"{us:.1f} µs an exchange (host clock over {SST_EXCHANGES}, ending in a synchronise)",
          flush=True)
    if not same or table.dtype != torch.uint32:
        raise AssertionError("7d: the gathered table differs from the rows")
    return dict(bitwise_equal=same, us_per_exchange=us, exchanges=SST_EXCHANGES)


#: 7e: decode attention over a cache split along T into n slices, as the
#: ranks of a (1, n) mesh run it, on one card
PARTIALS_T = 32768
PARTIALS_SLICES = (2, 4, 16)
PARTIALS_MODELS = {"mistral-nemo-12b": (2, 32, 8, 128), "granite-20b": (2, 48, 1, 128)}


def partials_bound(b, h, kh, d, local_lens, n):
    """Least time (ms) of one rank's partials and the combine of n: q and
    lens read once, the slice's valid K/V rows read once, its fp32 (m, l,
    acc) written once, the n partials read once and the bf16 output
    written once; 4·H·D flops a valid row, 2·D a partial of a row.
    Returns (ms, bytes, flops, 'bytes' or 'operations')."""
    rows = sum(local_lens)
    part = b * h * (d + 2) * 4
    nbytes = b * h * d * 2 + 4 * b + 2 * rows * kh * d * 2 + part + n * part + b * h * d * 2
    flops = 4 * h * d * rows + 2 * n * b * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, nbytes, flops, "bytes" if t_bytes >= t_ops else "operations"


def partials_library_call(q, k, v, lens):
    """One PyTorch call that gives a slice's (output, LSE), the same
    function as its record's acc / l and m + log l: the memory-efficient
    SDPA with ``compute_log_sumexp``, each KV head's G query rows taken as
    G query positions of that head (q (B, KH, G, D) and the cache
    (B, KH, T, D) as views, no copy) and the length mask as ``attn_bias``
    expanded over them (timed only); or the reason the op refuses the
    shape.  Returns (a call giving (out (B, H, D), lse (B, H)), reason)."""
    import torch

    b, t, kh, d = k.shape
    h = q.shape[1]
    qs = q.view(b, kh, h // kh, d)
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    bias = torch.zeros((b, 1, 1, t), dtype=q.dtype, device=q.device)
    bias = bias.masked_fill(~valid[:, None, None, :], float("-inf")).expand(b, kh, h // kh, t)

    def call():
        out, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
            qs, ks, vs, bias, True)[:2]
        return out.reshape(b, h, d), lse[..., :h // kh].reshape(b, h)

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0][:200]}"
    return call, None


def mesh_partials():
    """7e: NeMo's and granite's 32,768-slot bf16 caches at B = 2, each cut
    along T into n = 2, 4 and 16 slices as a (1, n) mesh's ranks hold
    them: every slice through ``decode_attention_partials`` with its local
    length clamp(len − r·T_loc, 0, T_loc), the n records stacked as the
    all-gather leaves them, then ``combine_partials`` over the n, held
    against the whole ``decode_attention`` kernel and the plain path to
    phase 2's scaled bf16 check, for a full cache and one whose second half
    holds no slot (an all-empty slice at every n, whose record must be
    (-inf, 0, 0) with zero pads): the new bodies (``cluster``, the ``warp``
    combine) and the old (``split``, the ``block`` combine) alike, one
    partials launch a slice and one combine by body.  Then, at n = 16
    (T_loc = 2,048), the launches one rank's ``t_split_decode_attention``
    makes in a layer, and one rank's work as it runs it (its slice's
    record, then the combine of 16 records, the gather replaced by 16
    copies of the record) timed in turns, new bodies against old, with
    each launch's time, the whole kernel over the 32,768 slots, the plain
    path's time, the bound and the library's yardstick
    (:func:`partials_library_call`)."""
    import types

    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.layers import t_split_decode_attention

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    bf16, t = torch.bfloat16, PARTIALS_T
    paths = {"new": ("cluster", "warp"), "old": ("split", "block")}
    rows = []
    for model, (b, h, kh, d) in PARTIALS_MODELS.items():
        q = torch.randn(b, h, d, generator=gen, device=dev, dtype=bf16)
        k = torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=bf16)
        v = torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=bf16)
        errs = {}
        for case, lens in (("full", [t, t]), ("half", [t // 2 - 7, t // 32])):
            n_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            whole = da.decode_attention(q, k, v, n_t).float()
            plain = da.decode_attention_plain(q, k, v, n_t).float()
            for n in PARTIALS_SLICES:
                t_loc = t // n
                ks = [k[:, r * t_loc:(r + 1) * t_loc].contiguous() for r in range(n)]
                vs = [v[:, r * t_loc:(r + 1) * t_loc].contiguous() for r in range(n)]
                for way, (pbody, cbody) in paths.items():
                    before = (dict(da.partials_by_body), dict(da.combine_by_body))
                    rec = torch.stack([da.decode_attention_partials(
                        q, ks[r], vs[r], (n_t - r * t_loc).clamp(0, t_loc).to(torch.int32),
                        body=pbody) for r in range(n)])
                    got = da.combine_partials(rec, bf16, body=cbody).float()
                    torch.cuda.synchronize()
                    ran = (da.partials_by_body.get(pbody, 0) - before[0].get(pbody, 0),
                           da.combine_by_body.get(cbody, 0) - before[1].get(cbody, 0))
                    if ran != (n, 1):
                        raise AssertionError(f"7e {model} n={n} {pbody}/{cbody}: {ran} launches, "
                                             f"expected {n} partials and one combine")
                    errs[f"{case} n={n} {way}"] = float((got - plain).abs().max())
                    if not (decode_close(got, whole, "bfloat16")
                            and decode_close(got, plain, "bfloat16")):
                        worst = float((got - whole).abs().max())
                        raise AssertionError(f"7e {model} {case} n={n} {pbody}/{cbody}: partials "
                                             f"+ combine differ from the whole kernel ({worst}) "
                                             f"or the plain path "
                                             f"({errs[f'{case} n={n} {way}']})")
                    m, l, acc = da.unpack_partials(rec[-1])
                    empty = (bool(torch.isinf(m).all()) and not l.any() and not acc.any()
                             and not rec[-1, ..., d + 2:].any())
                    if case == "half" and not empty:
                        raise AssertionError(f"7e {model} n={n} {pbody}: the all-empty slice's "
                                             f"record is not (-inf, 0, 0) with zero pads")
        n = PARTIALS_SLICES[-1]
        t_loc = t // n
        full = torch.full((b,), t, dtype=torch.int32, device=dev)
        local = torch.full((b,), t_loc, dtype=torch.int32, device=dev)
        ks, vs = k[:, :t_loc].contiguous(), v[:, :t_loc].contiguous()
        rec = da.decode_attention_partials(q, ks, vs, local)
        gathered = rec.expand(n, b, h, d + 4).contiguous()
        # the launches of one rank's layer: t_split_decode_attention over a
        # one-rank ``model`` (its gather the identity)
        one_rank = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
        read = counts_zeroed()
        t_split_decode_attention(q, ks, vs, full, 0, one_rank)
        torch.cuda.synchronize()
        layer = dict(partials=dict(da.partials_by_body), combine=dict(da.combine_by_body),
                     other=read())
        if layer["partials"] != {"cluster": 1} or layer["combine"] != {"warp": 1} \
                or any(layer["other"].values()):
            raise AssertionError(f"7e {model}: a layer's rank work launched {layer}, expected "
                                 f"one cluster partials launch and one warp combine")

        def work(way):
            pbody, cbody = paths[way]
            return lambda: (da.decode_attention_partials(q, ks, vs, local, body=pbody),
                            da.combine_partials(gathered, bf16, body=cbody))

        rank_ms, old_ms, turns = in_turns(work("new"), work("old"), flush, 25)
        timed = {f"{way}_{part}_ms": cuda_time_ms(fn, flush)
                 for way, (pbody, cbody) in paths.items() for part, fn in (
                     ("partials", lambda pbody=pbody: da.decode_attention_partials(
                         q, ks, vs, local, body=pbody)),
                     ("combine", lambda cbody=cbody: da.combine_partials(gathered, bf16,
                                                                         body=cbody)))}
        by_launch = {way: kernel_split(work(way), ("decode_split", "decode_combine_warp",
                                                   "decode_combine_kernel"), rest="other")
                     for way in paths}
        whole_ms = cuda_time_ms(lambda: da.decode_attention(q, k, v, full), flush)

        def plain_work():
            da.combine_partials_plain(torch.stack([da.decode_attention_partials_plain(
                q, ks, vs, local)] * n), bf16)

        plain_ms = cuda_time_ms(plain_work, flush)
        lib, why = partials_library_call(q, ks, vs, local)
        library_ms = library_err = None
        if lib is not None:
            library_ms = cuda_time_ms(lib, flush)
            out, lse = lib()
            m, l, acc = da.unpack_partials(da.decode_attention_partials_plain(q, ks, vs, local))
            library_err = max(float((out.float() - acc / l[..., None]).abs().max()),
                              float((lse.float() - (m + l.log())).abs().max()))
        bound_ms, nbytes, flops, bound_by = partials_bound(b, h, kh, d, [t_loc] * b, n)
        fits = da.cluster_fits(dev, h // kh, d)
        cluster = da.cluster_splits(b, kh, t_loc, da.sm_count(dev), fits)
        row = dict(model=model, b=b, h=h, kh=kh, d=d, t=t, dtype="bfloat16", slices=n,
                   t_loc=t_loc, body="cluster", combine_body="warp", old_body="split",
                   old_combine_body="block", cluster=cluster,
                   cluster_fits=fits,
                   splits=da.splits_for(b, kh, t_loc, da.sm_count(dev)),
                   max_abs_err=max(errs.values()), errs=errs, ms=rank_ms, old_body_ms=old_ms,
                   turns_ms=turns, partials_ms=timed["new_partials_ms"],
                   combine_ms=timed["new_combine_ms"], old_partials_ms=timed["old_partials_ms"],
                   old_combine_ms=timed["old_combine_ms"], by_launch=by_launch,
                   launches_per_layer=layer, whole_kernel_ms=whole_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bytes=nbytes, flops=flops, bound_by=bound_by,
                   library_ms=library_ms, library_err=library_err, library_refused=why)
        rows.append(row)
        lib_text = (f"library (efficient SDPA with LSE) {library_ms * 1e3:.1f} us, err "
                    f"{library_err:.2e}" if library_ms is not None else f"library {why}")
        print(f"7e {model} bf16 B={b} H={h} KH={kh} T={t} over n = {PARTIALS_SLICES} slices: "
              f"cluster + warp and split + block against the whole kernel and plain path, max "
              f"err {row['max_abs_err']:.2e}; a layer's launches {layer['partials']} + "
              f"{layer['combine']}; at n={n} (T_loc {t_loc}, clusters of {cluster}; clusters the "
              f"card holds by size {fits}; split body {row['splits']} ranges) one rank's work "
              f"{rank_ms * 1e3:.1f} us (partials {timed['new_partials_ms'] * 1e3:.1f}, combine "
              f"{timed['new_combine_ms'] * 1e3:.1f}) against the old bodies' "
              f"{old_ms * 1e3:.1f} us (partials {timed['old_partials_ms'] * 1e3:.1f}, combine "
              f"{timed['old_combine_ms'] * 1e3:.1f}) in turns; by launch, ms {by_launch}; the "
              f"whole kernel {whole_ms * 1e3:.1f} us; plain {plain_ms * 1e3:.1f} us; bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}); {lib_text}", flush=True)
        del q, k, v, ks, vs, gathered
    return rows


MESH_SSM = dict(model="mamba2-780m", batch=4, steps=16)


def mesh_ssm(mesh):
    """7f: mamba2-780m at full width and depth in bf16 over the mesh, its
    Mamba-2 layers on the head-split path (at one ``model`` rank every
    head, and no collective over ``model``): 16 serve steps at B = 4
    beside the mesh-less ``make_serve_step`` on the same params (logits
    bit for bit, the ``ssm`` cache where it lies), then a prefill at
    B = 2, S = 2048 beside the mesh-less prefill (logits bit for bit,
    every SSD launch on chunked)."""
    import torch
    from repro_torch.models import init_cache, sharding
    from repro_torch.training import make_prefill_step, make_serve_step

    cfg, params, out = load_full_width(MESH_SSM["model"])
    dev = torch.device("cuda")
    heads = sharding.ssm_heads(cfg, mesh)
    if heads != (0, cfg.n_ssm_heads):
        raise AssertionError(f"7f: the rank's heads are {heads}, expected all {cfg.n_ssm_heads}")
    stored = sharding.shard_tree(params, mesh, sharding.param_pspecs(mesh, params, cfg))
    b, steps = MESH_SSM["batch"], MESH_SSM["steps"]
    cache = init_cache(cfg, b, 16, device=dev)
    mcache = sharding.shard_tree(init_cache(cfg, b, 16, device=dev), mesh,
                                 sharding.cache_pspecs(mesh, cache))
    plain, meshed = make_serve_step(cfg, device=dev), make_serve_step(cfg, mesh=mesh)
    tok = torch.ones((b,), dtype=torch.int32, device=dev)
    serve_equal, walls = True, dict(plain=[], mesh=[])
    for _ in range(steps):
        for way, fn in (("plain", lambda: plain(params, cache, tok)),
                        ("mesh", lambda: meshed(stored, mcache, tok))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_i, _ = fn()
            torch.cuda.synchronize()
            walls[way].append(time.perf_counter() - t0)
            if way == "plain":
                want_logits = logits_i
        serve_equal &= bool(torch.equal(logits_i.full_tensor(), want_logits))
        tok = want_logits.argmax(-1).to(torch.int32)
    state_equal = bool(torch.equal(mcache["ssm"].to_local(), cache["ssm"]))
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                                     device=dev)}
    want = make_prefill_step(cfg, device=dev)(params, batch)
    mesh_prefill = make_prefill_step(cfg, mesh=mesh)
    read = counts_zeroed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = mesh_prefill(stored, batch).full_tensor()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_body = read(), bodies()
    prefill_equal = bool(torch.equal(got, want))
    med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    out.update(batch=b, steps=steps, serve_logits_bitwise_equal=serve_equal,
               ssm_cache_bitwise_equal=state_equal, serve_ms=med, prefill_wall_s=wall,
               prefill_logits_bitwise_equal=prefill_equal, launches=launches,
               launches_by_body=by_body)
    print(f"7f {cfg.name} over the mesh (bf16, heads {heads}): {steps} serve steps at B={b} "
          f"against the mesh-less step, logits bit for bit {serve_equal}, ssm cache bit for bit "
          f"{state_equal}, median ms a step (eager, host clock, in turns) mesh {med['mesh']:.2f}, "
          f"mesh-less {med['plain']:.2f}; prefill B={PREFILL_B} S={PREFILL_S} {wall:.3f} s, "
          f"logits bit for bit {prefill_equal}, launches {launches} by body {by_body}",
          flush=True)
    del params, stored, cache, mcache, got, want
    release_models()
    n = cfg.n_layers
    if launches != dict(decode_attention=0, flash_attention=0, ssd_scan=n, moe_gmm=0) \
            or by_body["ssd_scan"] != {"chunked": n}:
        raise AssertionError(f"7f: launches {launches} by body {by_body}, expected {n} SSD "
                             f"launches on chunked")
    if not (serve_equal and state_equal and prefill_equal):
        raise AssertionError("7f: the mesh steps differ from the mesh-less steps")
    return out


#: 7g: the SSD scan of one ``model`` rank: phase 2c's bf16 inputs of
#: mamba2's and zamba2's heads cut into n slices of heads, as the ranks of
#: a (1, n) mesh compute them
SSD_HEAD_MODELS = ("mamba2-780m", "zamba2-7b")
SSD_HEAD_SLICES = (2, 4, 16)


def mesh_ssd_heads():
    """7g: mamba2's (H = 48) and zamba2's (H = 112) heads at B = 2,
    T = 2,048 in bf16, cut into 2, 4 and 16 slices of heads: each slice's
    x, dt, a, B and C through ``ssd_scan`` on the ``fused`` and on the
    ``chunked`` body by name, the y and final states side by side, held
    against the whole call (``chunked``) and the plain path to phase 2c's
    check, and bit for bit against the whole call (a failure either way
    fails the phase), one launch a slice by body.  The fused body takes a
    slice only where its grid fits one wave (n = 16 at both models) and
    must refuse the others without a launch.  Then at n = 16 (3 and 7
    heads) one rank's call: the body ``ssd_scan`` picks, fused against
    chunked in turns, each body's time by launch under the profiler ((a),
    (b), (c) for chunked), the plain path's time and the bound (the whole
    call's over 16); and the whole call on chunked."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, t, dtype = PREFILL_B, PREFILL_S, "bfloat16"
    rows = []
    fused_launches = 0
    for model in SSD_HEAD_MODELS:
        cfg = ARCHS[model]
        h, p, n, chunk = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        x = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        dt = F.softplus(torch.randn(b, t, h, generator=gen, device=dev))
        a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
        bb = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        cc = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        whole = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk, body="chunked")
        plain = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk)
        errs, bitwise = {}, {}
        for k in SSD_HEAD_SLICES:
            ranks = [tuple(z.contiguous() for z in (x[:, :, s], dt[:, :, s], a[s], bb[:, :, s],
                                                   cc[:, :, s]))
                     for s in (slice(i * h // k, (i + 1) * h // k) for i in range(k))]
            fits = b * (h // k) * -(-t // chunk) <= sms * ssd.fused_blocks_per_sm(
                dev, chunk, p, n, 1)
            for body in ("fused", "chunked"):
                before = ssd.launches_by_body.get(body, 0)
                if body == "fused" and not fits:  # past one wave: refused, no launch
                    try:
                        ssd.ssd_scan(*ranks[0], chunk=chunk, body=body)
                    except ValueError:
                        bitwise[f"n={k} {body}"] = "refused"
                    if ssd.launches_by_body.get(body, 0) != before or f"n={k} {body}" not in bitwise:
                        raise AssertionError(f"7g {model} n={k}: the fused body took a grid "
                                             f"past one wave")
                    continue
                fused_launches += k if body == "fused" else 0
                parts = [ssd.ssd_scan(*r, chunk=chunk, body=body) for r in ranks]
                y, state = (torch.cat([y for y, _ in parts], dim=2),
                            torch.cat([s for _, s in parts], 1))
                torch.cuda.synchronize()
                if ssd.launches_by_body.get(body, 0) != before + k:
                    raise AssertionError(f"7g {model} n={k} {body}: "
                                         f"{ssd.launches_by_body.get(body, 0) - before} "
                                         f"launches, expected {k}")
                errs[f"n={k} {body}"] = float((y.float() - plain[0].float()).abs().max())
                bitwise[f"n={k} {body}"] = bool(torch.equal(y, whole[0])
                                                and torch.equal(state, whole[1]))
                for want_y, want_state in (whole, plain):
                    if not (torch.allclose(y.float(), want_y.float(), **SSD_TOL[dtype])
                            and torch.allclose(state, want_state, **SSD_TOL["float32"])):
                        raise AssertionError(
                            f"7g {model} n={k} {body}: the head slices differ from the whole "
                            f"call or the plain path (y "
                            f"{float((y.float() - want_y.float()).abs().max())})")
                if not bitwise[f"n={k} {body}"]:
                    raise AssertionError(f"7g {model} n={k} {body}: the head slices are not the "
                                         f"whole chunked call bit for bit")
        k, rank = SSD_HEAD_SLICES[-1], ranks[0]
        hl = h // k
        nc = -(-t // chunk)
        per_sm = {z: ssd.fused_blocks_per_sm(dev, chunk, p, n, z) for z in (1, 2, 4)}
        body = ssd.body_for(torch.bfloat16, p, n, chunk, b * hl, sms, nc, per_sm[1])
        rank_ms, old_ms, turns = in_turns(
            lambda: ssd.ssd_scan(*rank, chunk=chunk, body="fused"),
            lambda: ssd.ssd_scan(*rank, chunk=chunk, body="chunked"), flush, 25)
        form = f"split {ssd.fused_split(p, b * hl * nc, sms, per_sm)}"
        plain_ms = cuda_time_ms(lambda: ssd.ssd_scan_plain(*rank, chunk=chunk), flush, reps=10)
        by_launch = {
            "chunked": kernel_split(lambda: ssd.ssd_scan(*rank, chunk=chunk, body="chunked"),
                                    ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")),
            "fused": kernel_split(lambda: ssd.ssd_scan(*rank, chunk=chunk, body="fused"),
                                  ("ssd_fused",))}
        whole_ms = cuda_time_ms(lambda: ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk,
                                                     body="chunked"), flush, reps=10)
        bound_ms, nbytes, flops, bound_by = ssd_bound(b, t, hl, p, n, chunk, dtype, 2)
        row = dict(model=model, b=b, t=t, h=h, slices=k, heads=hl, p=p, n=n, chunk=chunk,
                   dtype=dtype, body=body, old_body="chunked", fused_form=form,
                   per_sm=per_sm, ctas=b * hl * nc * int(form[6:]),
                   max_abs_err=max(errs.values()), errs=errs, bitwise_equal=bitwise,
                   ms=rank_ms, old_body_ms=old_ms, turns_ms=turns,
                   by_launch=by_launch, whole_kernel_ms=whole_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bytes=nbytes, flops=flops, bound_by=bound_by,
                   library_ms=None, launches=sum(SSD_HEAD_SLICES) + fused_launches)
        rows.append(row)
        print(f"7g {model} bf16 B={b} T={t} H={h} P={p} N={n} over n = {SSD_HEAD_SLICES} slices "
              f"of heads, fused and chunked: against the whole call and plain path, max err "
              f"{row['max_abs_err']:.2e}, bit for bit the whole chunked call {bitwise}; at n={k} "
              f"({hl} heads, {b * hl * nc} chunks; fused CTAs an SM by split {per_sm}; picked "
              f"{body}, {form}) one rank's call on fused "
              f"{rank_ms * 1e3:.1f} us against chunked {old_ms * 1e3:.1f} us in turns; by launch, "
              f"ms {by_launch}; plain {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}); the whole call chunked {whole_ms * 1e3:.1f} us", flush=True)
        del x, dt, bb, cc, whole, plain, ranks, parts, y, state
        fused_launches = 0
    return rows


def mesh_on_card():
    """Phase 7, in a fresh process so that its process group stays out of
    the other phases: a one-rank NCCL group and ``make_debug_mesh``'s
    (1, 1) mesh, then 7a-7g.  A failure in any part fails the phase."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_debug_mesh(device="cuda")
    out = dict(mesh=sharding.mesh_sizes(mesh), backend=dist.get_backend(),
               world=dist.get_world_size())
    print(f"phase 7 mesh {out['mesh']} over {out['backend']}, world {out['world']}", flush=True)
    try:
        out["serve"] = mesh_serve(mesh)
        release_models()
        out["ep"] = mesh_ep(mesh)
        out["train"] = mesh_train(mesh)
        out["sst"] = mesh_sst(mesh)
        out["partials"] = mesh_partials()
        out["ssm"] = mesh_ssm(mesh)
        out["ssd_heads"] = mesh_ssd_heads()
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 8: the analysis tooling (specs, dry-run, roofline), checked on the card
# ---------------------------------------------------------------------------
#: 8a's dry-run calls, ``python -m repro_torch.launch.dryrun --arch A --shape
#: S --no-direct`` each (the extrapolation from 2- and 3-layer variants): every arch's prefill
#: and decode shapes but the SSM ones' 32k prefill (their SSD loop runs
#: 512 chunks a layer on fake tensors, ~1 min), and NeMo's train shape.
DRYRUN_CALLS = (
    ("deepseek-v2-236b,granite-20b,llama3-405b,mistral-large-123b,mistral-nemo-12b,"
     "qwen2-vl-72b,qwen3-moe-30b-a3b,whisper-medium", "prefill_32k,decode_32k,long_500k"),
    ("mamba2-780m,zamba2-7b", "decode_32k,long_500k"),
    ("mistral-nemo-12b", "train_4k"),
)
#: 8a's direct full-depth count, held equal to its own extrapolation.
DRYRUN_DIRECT = ("mistral-nemo-12b", "prefill_32k")
#: 8b's steps: NeMo at full width and this many layers, B = 2, S = 2048.
COUNT_LAYERS = 2
#: 8b: the counted peak of a step (above its state) against the card's
#: ``max_memory_allocated`` (above what was allocated before it), relative.
PEAK_TOL = 0.05


def run_module(*argv, timeout=600):
    """``python -m <argv>`` from the checkout, its output printed; a
    failure where it exits non-zero."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    print(out.stdout.rstrip(), flush=True)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"python -m {' '.join(argv)} exited with {out.returncode}")


def dryrun_on_host():
    """Phase 8a: ``python -m repro_torch.launch.dryrun`` over the fake 16x16
    mesh (256 ranks) for ``DRYRUN_CALLS``, each in a process of its own (a
    fake group cannot share one with phase 7's NCCL group): every record
    ok, whisper x long_500k skipped and no other; one direct full-depth
    count equal to its extrapolation; then the roofline's ``main`` over
    the records (its table, and the cases whose state does not fit
    80 GB)."""
    from repro_torch.launch import roofline

    out_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    for archs, shapes in DRYRUN_CALLS:
        run_module("repro_torch.launch.dryrun", "--arch", archs, "--shape", shapes,
                   "--no-direct", "--out", str(out_dir / "cases"))
    arch, shape = DRYRUN_DIRECT
    run_module("repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--out", str(out_dir / "direct"))
    records = [json.loads(p.read_text()) for p in sorted((out_dir / "cases").glob("*.json"))]
    failed = [f"{r['arch']} {r['shape']}" for r in records if not r["ok"]]
    skipped = [f"{r['arch']} {r['shape']}" for r in records if r.get("skipped")]
    if failed or skipped != ["whisper-medium long_500k"]:
        raise AssertionError(f"dry-run: failed {failed}, skipped {skipped}")
    direct = json.loads((out_dir / "direct" / f"{arch}__{shape}__16x16.json").read_text())
    corr = direct["corrected"]
    same = {k: direct[k] == corr[k] for k in ("flops", "matmul_flops", "bytes_accessed",
                                              "collectives", "links")}
    print(f"{arch} {shape} on 16x16: direct count {direct['flops']:.6e} FLOPs, "
          f"{direct['bytes_accessed']:.6e} bytes, {direct['collectives']['count']} "
          f"collectives in {direct['count_s']} s; equal to its extrapolation "
          f"({corr['variant_count_s']} s): {same}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"the extrapolation differs from the direct count: {same}")
    roofline.main(["--dir", str(out_dir / "cases"), "--json-out", str(out_dir / "roofline.json")])
    rows = json.loads((out_dir / "roofline.json").read_text())
    return dict(seconds=time.perf_counter() - t0, records=len(records), skipped=skipped,
                direct=dict(arch=arch, shape=shape, flops=direct["flops"],
                            bytes_accessed=direct["bytes_accessed"], count_s=direct["count_s"],
                            variant_count_s=corr["variant_count_s"], equal=same),
                over_80gb=[f"{r['arch']} {r['shape']}" for r in rows if not r["fits_hbm"]],
                roofline=rows)


def _real_count_case(cfg, kind, dev, seed=23):
    """8b's step on real tensors on the card: seeded params and tokens."""
    import torch
    from repro_torch.models import init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen, device=dev,
                           dtype=torch.int32)
    case = {"kind": kind, "cfg": cfg, "params": params, "batch": {"tokens": tokens}}
    if kind == "train":
        case["accum_steps"] = 1
    return case


def _same_counts(what, real, fake):
    keys = ("flops", "matmul_flops", "bytes_accessed", "collectives", "links", "ops",
            "state_bytes_per_device")
    diff = {k: (real[k], fake[k]) for k in keys if real[k] != fake[k]}
    print(f"{what}: counted on the card {real['flops']:.6e} FLOPs ({real['matmul_flops']:.6e} "
          f"matmul), {real['bytes_accessed']:.6e} bytes, {real['ops']} ops, collectives "
          f"{real['collectives']}; state {real['state_bytes_per_device']} bytes; the fake count "
          f"{'equal' if not diff else 'DIFFERS: ' + str(diff)}", flush=True)
    if diff:
        raise AssertionError(f"{what}: the card's count and the fake count differ: {diff}")


def counts_on_card():
    """Phase 8b: NeMo at full width and ``COUNT_LAYERS`` layers, prefill at
    B = 2, S = 2048 and one train step (bf16 moments, remat), on the plain
    path (``impl="ref"``): the step counted by ``StepCounter`` on the card
    (after one untimed warm-up) against the same step counted on fake
    tensors: FLOPs, bytes, collectives and ops equal, the state bytes
    equal to the real params' and moments' own bytes, and the counted peak
    (above the state) within ``PEAK_TOL`` of ``max_memory_allocated``
    (above what was allocated before the step)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.counter import StepCounter
    from repro_torch.models.config import InputShape
    from repro_torch.training import optimizer as opt

    release_models()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(ARCHS["mistral-nemo-12b"], n_layers=COUNT_LAYERS)
    out = {}
    for kind in ("prefill", "train"):
        shape = InputShape(kind, PREFILL_S, PREFILL_B, kind)
        with FakeTensorMode():
            fake = dryrun.count_case(dryrun.abstract_case(cfg, kind, shape, 1, "cuda"), None,
                                     "sorted", device="cuda")
        case = _real_count_case(cfg, kind, dev)
        step, args, resident = dryrun.prepare_step(case, None, "sorted", device="cuda")
        own = sum(t.numel() * t.element_size() for _, t in opt.leaves(args[0]))
        if kind == "train":
            own += sum(t.numel() * t.element_size() for tree in (args[1].m, args[1].v)
                       for _, t in opt.leaves(tree))
        del case
        step(*args)  # warm-up: the libraries' workspaces, outside the count
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with StepCounter(resident=resident) as counter:
            got = step(*args)
            del got
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        real = counter.counts.as_record()
        real["state_bytes_per_device"] = resident
        what = f"{cfg.name}@{COUNT_LAYERS} {kind} B={PREFILL_B} S={PREFILL_S} (ref path)"
        _same_counts(what, real, fake)
        predicted, measured = fake["peak_bytes"] - fake["resident_bytes"], peak - before
        rel = abs(predicted - measured) / measured
        print(f"  state: predicted {fake['state_bytes_per_device']} bytes, the real params"
              f"{' and moments' if kind == 'train' else ''} {own} bytes; peak above the "
              f"state: predicted {predicted / 1e9:.4f} GB (counted on the card "
              f"{(real['peak_bytes'] - resident) / 1e9:.4f}), max_memory_allocated above "
              f"what was allocated before {measured / 1e9:.4f} GB: {100 * rel:.2f} % apart "
              f"(tolerance {100 * PEAK_TOL:.0f} %)", flush=True)
        if fake["state_bytes_per_device"] != own:
            raise AssertionError(f"{what}: predicted state {fake['state_bytes_per_device']} "
                                 f"bytes, the real tensors hold {own}")
        if rel > PEAK_TOL:
            raise AssertionError(f"{what}: predicted peak {predicted} bytes, the card's "
                                 f"{measured}")
        out[kind] = dict(fake=fake, real=real, own_state_bytes=own,
                         predicted_peak_above_state=predicted, measured_peak_above_state=measured,
                         peak_rel=rel)
        del step, args
        release_models()
    return out


def mesh_counts_on_card():
    """Phase 8b over a mesh, in a fresh process: NeMo@``COUNT_LAYERS``'s
    prefill and train step on the plain path over ``make_debug_mesh``'s
    (1, 1) NCCL mesh, counted on the card; then the group gone, the same
    steps counted on fake tensors over a fake (1, 1) mesh of the card's
    device type: equal counts."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import abstract_world
    from repro_torch.models.config import InputShape

    dev = torch.device("cuda")
    cfg = dataclasses.replace(ARCHS["mistral-nemo-12b"], n_layers=COUNT_LAYERS)
    shapes = {k: InputShape(k, PREFILL_S, PREFILL_B, k) for k in ("prefill", "train")}
    mesh = make_debug_mesh(device="cuda")
    try:
        real = {k: dryrun.count_case(_real_count_case(cfg, k, dev), mesh, "sorted",
                                     device="cuda") for k in shapes}
    finally:
        dist.destroy_process_group()
    release_models()
    with abstract_world((1, 1), ("data", "model"), device="cuda") as fmesh:
        fake = {k: dryrun.count_case(dryrun.abstract_case(cfg, k, sh, 1, "cuda"), fmesh,
                                     "sorted", device="cuda") for k, sh in shapes.items()}
    for k in shapes:
        _same_counts(f"{cfg.name}@{COUNT_LAYERS} {k} over the (1, 1) mesh (ref path)",
                     real[k], fake[k])
    return dict(real=real, fake=fake)


def card_roofline(served, prefill, training, card):
    """Phase 8c, on earlier phases' readings only: the roofline of the
    kernel-path steps phases 3, 3b and 6 time (NeMo's graphed decode
    step, NeMo's prefill at B = 2, S = 2048, NeMo@8's train step), each
    step's compute and memory terms counted on fake tensors (the ``ref``
    path's count of the same function: its unmasked attention and unfused
    bytes), the bound's share of the measured time, and 6·N·tokens (train)
    or 2·N·tokens over the measured time and the card's peak bf16 rate."""
    import statistics as st

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.models.config import InputShape

    nemo = ARCHS["mistral-nemo-12b"]
    graph = served["step_graph_vs_eager"][nemo.name]
    steps = [
        ("decode", nemo, InputShape("decode", graph["steps"] + 1, 2, "decode"), 2,
         st.median(graph["graph_ms"]) / 1e3, "phase 3, graphed step", dryrun.MOMENT_DTYPE),
        ("prefill", nemo, InputShape("prefill", PREFILL_S, PREFILL_B, "prefill"),
         PREFILL_B * PREFILL_S, st.median(prefill[nemo.name]["wall_s"]), "phase 3b",
         dryrun.MOMENT_DTYPE),
        ("train", dataclasses.replace(nemo, n_layers=training["layers"]),
         InputShape("train", PREFILL_S, PREFILL_B, "train"), PREFILL_B * PREFILL_S,
         training["step_s"], "phase 6 (fp32 moments)", torch.float32),
    ]
    rows = []
    for kind, cfg, shape, tokens, measured_s, source, moments in steps:
        with FakeTensorMode():
            got = dryrun.count_case(dryrun.abstract_case(cfg, kind, shape, 1, "cuda"), None,
                                    "sorted", device="cuda", moment_dtype=moments)
        t = roofline.terms(got["flops"], got["bytes_accessed"], got["links"])
        bound = max(t.values())
        useful = (6.0 if kind == "train" else 2.0) * cfg.param_count() * tokens
        row = dict(kind=kind, model=f"{cfg.name}@{cfg.n_layers}", batch=shape.global_batch,
                   seq=shape.seq_len, source=source, measured_s=measured_s,
                   counted_flops=got["flops"], counted_bytes=got["bytes_accessed"],
                   compute_s=t["compute"], memory_s=t["memory"], bound_s=bound,
                   bound_share=bound / measured_s, model_flops=useful,
                   mfu=useful / (measured_s * PEAK_FLOPS_BF16), card=card)
        rows.append(row)
        print(f"{row['model']} {kind} (B={shape.global_batch}, "
              f"{'capacity' if kind == 'decode' else 'S'}={shape.seq_len}; {source}) on {card}: "
              f"measured {measured_s * 1e3:.3f} ms; the ref path's count of the same function "
              f"{got['flops']:.4e} FLOPs and {got['bytes_accessed']:.4e} bytes: compute "
              f"{t['compute'] * 1e3:.3f} ms, memory {t['memory'] * 1e3:.3f} ms; the bound's "
              f"share of the measured time {100 * row['bound_share']:.1f} %; "
              f"{'6' if kind == 'train' else '2'}·N·tokens = {useful:.4e}, mfu "
              f"{100 * row['mfu']:.2f} %", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one card.")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the full measurements (JSON) and nvcc's report")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        die("PyTorch is not installed")
    if not torch.cuda.is_available():
        die("no CUDA device: this script measures the port on the card")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        die(f"the port is not beside this script ({e})")
    # fp32 matmuls and convolutions in full fp32, no TF32 (the reference's precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    from repro_torch import probe

    # the idle card, with this process's context open and before any load
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    time.sleep(1.0)
    idle_w = probe.idle_power_w()
    print(f"idle power.draw: {idle_w} W")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phases = Phases()
    built = phases.run("phase 1: build kernels", build_kernels)
    rows = phases.run("phase 2: decode_attention against plain", kernel_vs_plain) if built else None
    flash_rows = phases.run("phase 2b: flash_attention against plain", flash_vs_plain) \
        if built else None
    ssd_rows = phases.run("phase 2c: ssd_scan against plain", ssd_vs_plain) if built else None
    gmm_rows = phases.run("phase 2d: moe_gmm against plain", gmm_vs_plain) if built else None
    bwd_rows = phases.run("phase 2e: flash_attention backward against plain", flash_bwd_vs_plain) \
        if built else None
    grad_rows = phases.run("phase 2f: ssd_scan and moe_gmm backward against plain",
                           bwd_kernels_vs_plain) if built else None
    served = phases.run("phase 3: serving at full width (bf16)", serve_full_width) if built else None
    prefill = phases.run("phase 3b: prefill at full width (bf16)", prefill_full_width) \
        if built else None
    planes = phases.run("phase 3h: serving with gossip, prefetch, trace and health (bf16)",
                        serve_with_planes) if built else None
    qwen = phases.run("phase 3c: Qwen3-MoE at full width and depth (bf16)",
                      qwen3_moe_full_width) if built else None
    deepseek = phases.run("phase 3d: DeepSeek-V2 at full width, 4 layers (bf16)",
                          deepseek_v2_cut_depth) if built else None
    zamba = phases.run("phase 3e: zamba2-7b at full width and depth (bf16)",
                       zamba2_full_width) if built else None
    whisper = phases.run("phase 3f: whisper-medium at full width and depth (bf16)",
                         whisper_full_width) if built else None
    vlm = phases.run(f"phase 3g: qwen2-vl-72b at full width, {QWEN2_VL_LAYERS} layers (bf16)",
                     qwen2_vl_cut_depth) if built else None
    release_models()
    reduced = phases.run("phase 4: reduced fp32 example, kernel against plain", reduced_example) \
        if built else None
    planner = phases.run("phase 5a: the Navigator planner on the card", in_fresh_process,
                         "planner_on_card")
    constants = phases.run("phase 5b: the card's readings against the H100 constants",
                           profiles_on_card, prefill or {}, idle_w)
    simulated = phases.run("phase 5c: the simulator on the card's host", compass_simulator)
    training = phases.run(f"phase 6: {TRAIN_MODEL} training at full width, {TRAIN_LAYERS} layers "
                          f"(bf16)", train_full_width) if built else None
    release_models()
    families = phases.run("phase 6b: mamba2, zamba2@12 and Qwen3-MoE@4 training at full width "
                          "(bf16)", train_families) if built else None
    release_models()
    meshed = phases.run("phase 7: the mesh at world size 1 (NCCL)", in_fresh_process,
                        "mesh_on_card") if built else None
    dry = phases.run("phase 8a: the dry-run over a fake 16x16 mesh, and its roofline",
                     dryrun_on_host)
    counted = phases.run("phase 8b: the counter on the card against the fake count",
                         counts_on_card)
    mesh_counted = phases.run("phase 8b: the same over the (1, 1) NCCL mesh", in_fresh_process,
                              "mesh_counts_on_card")
    roofs = phases.run("phase 8c: the roofline of the card's kernel-path steps", card_roofline,
                       served, prefill, training, card) if built else None
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(
            dict(card=card, build=built, kernels=rows, flash=flash_rows, ssd=ssd_rows,
                 gmm=gmm_rows, flash_bwd=bwd_rows, grads=grad_rows, training=training,
                 training_families=families, serving=served, prefill=prefill, planes=planes,
                 qwen3_moe=qwen,
                 deepseek_v2=deepseek, zamba2=zamba, whisper=whisper, qwen2_vl=vlm,
                 reduced=reduced, planner=planner, constants=constants,
                 simulator=simulated, mesh=meshed, dryrun=dry, counts=counted,
                 mesh_counts=mesh_counted, card_roofline=roofs, idle_power_w=idle_w,
                 failed=phases.failed, tracebacks=phases.tracebacks), indent=1, default=str))
    if phases.failed or not built:
        die(f"failed phases: {phases.failed}")
    main_row = next(r for r in rows if all(r[k] == MAIN_SHAPE[k] for k in MAIN_SHAPE))
    flash_row = next(r for r in flash_rows if all(r[k] == FLASH_MAIN[k] for k in FLASH_MAIN))
    ssd_row = next(r for r in ssd_rows if all(r[k] == SSD_MAIN[k] for k in SSD_MAIN))
    gmm_row = next(r for r in gmm_rows if all(r[k] == GMM_MAIN[k] for k in GMM_MAIN))
    granite_row = next(r for r in rows if all(r[k] == GRANITE_SHAPE[k] for k in GRANITE_SHAPE))
    bwd_row = next(r for r in bwd_rows if all(r[k] == BWD_MAIN[k] for k in BWD_MAIN))
    ssd_bwd_row = next(r for r in grad_rows["ssd"]
                       if all(r[k] == SSD_BWD_MAIN[k] for k in SSD_BWD_MAIN))
    gmm_grad_rows = {what: next(r for r in grad_rows["gmm"] if r["kernel"] == f"moe_gmm_{what}"
                                and all(r[k] == GMM_BWD_MAIN[k] for k in GMM_BWD_MAIN))
                     for what in ("dx", "dw")}

    def decode_shape(r):
        return {k: r[k] for k in ("model", "b", "h", "kh", "d", "t", "dtype", "body", "splits",
                                  "max_abs_err", "kernel_ms", "old_body_ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}

    def shape_of(r, keys):
        return {k: r.get(k) for k in keys + ("dtype", "body", "max_abs_err", "kernel_ms",
                                             "plain_ms", "bound_ms", "bound_by", "library_ms")}

    # the shapes the hybrid, audio and VLM paths gave each kernel (bf16), and
    # each kernel's launches in those phases: prefill (two calls), the
    # serving task and the decode steps
    new_models = ("whisper-medium", "zamba2-7b", "qwen2-vl-72b")
    slice_rows = {
        "decode_attention": [decode_shape(r) for r in rows if r["model"] in new_models
                             and r["dtype"] == "bfloat16" and r["t"] != 300],
        "flash_attention": [shape_of(r, ("model", "b", "s", "sk", "h", "kh", "d", "case"))
                            for r in flash_rows if r["model"] in new_models
                            and r["dtype"] == "bfloat16" and r["s"] != 1024],
        "ssd_scan": [shape_of(r, ("model", "b", "t", "h", "p", "n")) for r in ssd_rows
                     if r["model"] == "zamba2-7b" and r["dtype"] == "bfloat16"],
        "moe_gmm": [],
        "flash_attention_bwd": [shape_of(r, ("model", "b", "s", "sk", "h", "kh", "d", "case",
                                             "splits", "dkdv_ctas", "old_body", "old_body_ms"))
                                for r in bwd_rows],
        "ssd_scan_bwd": [shape_of(r, ("model", "b", "t", "h", "p", "n", "initial_state",
                                      "old_body", "old_body_ms"))
                         for r in grad_rows["ssd"]],
        "moe_gmm_dx": [shape_of(r, ("model", "t", "e", "d_in", "d_out", "old_body",
                                    "old_body_ms"))
                       for r in grad_rows["gmm"] if r["kernel"] == "moe_gmm_dx"],
        "moe_gmm_dw": [shape_of(r, ("model", "t", "e", "d_in", "d_out", "old_body",
                                    "old_body_ms"))
                       for r in grad_rows["gmm"] if r["kernel"] == "moe_gmm_dw"],
    }
    family_phases = {"3e zamba2-7b": zamba, "3f whisper-medium": whisper,
                     f"3g qwen2-vl-72b@{QWEN2_VL_LAYERS}": vlm}

    def phase_launches(kernel):
        return {ph: {part: r[part]["launches"][kernel]
                     for part in ("prefill", "prefill_long", "serve", "decode") if part in r}
                for ph, r in family_phases.items()}

    kernels = [{
        "name": "decode_attention",
        "body": main_row["body"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:110",
        "launches": served["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # the serving run's two shapes: NeMo's (the numbers above) and granite's
        "shapes": [decode_shape(main_row), decode_shape(granite_row)],
    }, {
        "name": "flash_attention",
        "body": flash_row["body"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:130",
        "launches": prefill["launches"]["flash_attention"],
        "max_abs_err": flash_row["max_abs_err"],
        "ms": flash_row["kernel_ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
    }, {
        "name": "ssd_scan",
        "body": ssd_row["body"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:130",
        "launches": prefill["launches"]["ssd_scan"],
        "max_abs_err": ssd_row["max_abs_err"],
        "ms": ssd_row["kernel_ms"],
        "plain_ms": ssd_row["plain_ms"],
        "bound_ms": ssd_row["bound_ms"],
        "bound_by": ssd_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "moe_gmm",
        "body": gmm_row["body"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:90",
        "launches": qwen["prefill_launches"]["moe_gmm"],
        "max_abs_err": gmm_row["max_abs_err"],
        "ms": gmm_row["kernel_ms"],
        "plain_ms": gmm_row["plain_ms"],
        "bound_ms": gmm_row["bound_ms"],
        "bound_by": gmm_row["bound_by"],
        "library_ms": gmm_row["library_ms"],
    }, {
        "name": "flash_attention_bwd",
        "body": bwd_row["body"],
        # the body it replaced on the main path, timed in turns with it
        "old_body": bwd_row["old_body"],
        "old_body_ms": bwd_row["old_body_ms"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        # the gradient of the TPU kernel (XLA's, as the Pallas kernel has no custom_vjp)
        "replaces": "src/repro/kernels/flash_attention.py:130",
        "launches": training["bwd_launches"],
        "max_abs_err": bwd_row["max_abs_err"],
        "ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
    }, {
        "name": "ssd_scan_bwd",
        "body": ssd_bwd_row["body"],
        # the body it replaced on the main path, timed in turns with it
        "old_body": ssd_bwd_row["old_body"],
        "old_body_ms": ssd_bwd_row["old_body_ms"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        # the gradient of the TPU kernel (XLA's of ssd_chunked_ref: no Pallas backward)
        "replaces": "src/repro/kernels/ssd_scan.py:130",
        "launches": families["mamba2-780m"]["by_body"]["ssd_scan_bwd"].get(ssd_bwd_row["body"], 0),
        "max_abs_err": ssd_bwd_row["max_abs_err"],
        "ms": ssd_bwd_row["kernel_ms"],
        "plain_ms": ssd_bwd_row["plain_ms"],
        "bound_ms": ssd_bwd_row["bound_ms"],
        "bound_by": ssd_bwd_row["bound_by"],
        "library_ms": None,
    }] + [{
        "name": f"moe_gmm_{what}",
        "body": row["body"],
        "old_body": row["old_body"],
        "old_body_ms": row["old_body_ms"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        # the gradient of the TPU kernel (XLA's of moe_gmm_ref: no Pallas backward)
        "replaces": "src/repro/kernels/moe_gmm.py:90",
        "launches": sum(families["qwen3-moe-30b-a3b"]["by_body"][f"moe_gmm_{what}"].values()),
        "max_abs_err": row["max_abs_err"],
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    } for what, row in gmm_grad_rows.items()]
    for k in kernels:
        k.update(slice_shapes=slice_rows[k["name"]],
                 launches_by_phase=phase_launches(k["name"]) if k["name"] in (
                     "decode_attention", "flash_attention", "ssd_scan", "moe_gmm")
                 else {f"6 {TRAIN_MODEL}@{training['layers']}": training["bwd_launches"]}
                 if k["name"] == "flash_attention_bwd" else {})
        for model, r in families.items():  # phase 6b's training runs
            n = sum(r["by_body"].get(k["name"], {}).values())
            if n:
                k["launches_by_phase"][f"6b {model}@{r['layers']} (training)"] = n
    kernels[1]["launches_by_phase"][f"6 {TRAIN_MODEL}@{training['layers']} (training)"] = \
        training["launches"]["flash_attention"]
    # phase 7's runs over the (1, 1) NCCL mesh
    mesh_phase = {
        "decode_attention": {"7a mesh serve": meshed["serve"]["launches"]["decode_attention"]},
        "flash_attention": {"7b ep prefill": meshed["ep"]["launches"]["flash_attention"],
                            "7c mesh training": meshed["train"]["launches"]["flash_attention"]},
        "ssd_scan": {"7f mesh prefill": meshed["ssm"]["launches"]["ssd_scan"]},
        "moe_gmm": {"7b ep prefill": meshed["ep"]["launches"]["moe_gmm"]},
        "flash_attention_bwd": {"7c mesh training": meshed["train"]["bwd_launches"]},
    }
    for k in kernels:
        k["launches_by_phase"].update(mesh_phase.get(k["name"], {}))
    # phase 7e: the partials path of a cache split along T (one rank's work
    # at n = 16 beside the whole kernel)
    kernels[0]["partials"] = meshed["partials"]
    # phase 7g: the SSD scan on one rank's heads (n = 16) beside the whole call
    kernels[2]["heads"] = meshed["ssd_heads"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
