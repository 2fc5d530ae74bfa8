#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (or any sm_90a card).

    python3 chip_smoke.py [--out DIR]

It needs the checkout around it (``src/repro_torch``), PyTorch with CUDA,
``nvcc`` and one card, and exits non-zero when any of them is missing or
any phase fails.  Phases:

1. the card (name and power limit) and the build of every kernel under
   ``src/repro_torch/csrc`` for sm_90a, one nvcc per source, all at once,
   with ptxas's registers and spills of the wgmma, split and chunked
   bodies and the shared memory of the wgmma bodies;
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
   and the grouped matmul's wgmma against mma.sync (2b, 2d), the SSD
   scan's chunked against serial (2c); then (2e) the flash backward
   kernel against ``flash_attention_bwd_plain`` at the training shapes
   (NeMo's B = 2, S = 2048; granite's MQA; whisper's 1,500-frame encoder;
   zamba2's window at D = 112; NeMo's in fp32), on the forward kernel's
   output and LSE, held as phase 2 holds decode (bf16 errors scaled to
   each row), with its time, its bound (10·H·D flops a visible pair),
   the plain version's and the backward of
   ``scaled_dot_product_attention``, and the forward with and without
   its LSE store, in turns;
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
   path; then NeMo's forward over phase 3's prompt against its decode path,
   within ``LOGIT_BOUND`` with equal argmax;
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
   (``ExecutionEngine.run_task``, scan dispatch, through a graph; then
   graph against eager in turns, tokens equal) and sorted against scan
   decode from one cache;
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
   with remat's recomputation; every backward on mma, layers × 1),
   finite losses, moved params, the step time, tokens/s, 6·N·tokens over
   the step time, the peak memory, the busy share and the top kernels of
   one more step under the profiler; then one step at 2 layers, kernel
   path against plain path (``impl="ref"``): loss, grad norm and every
   leaf's gradient (cosine, and max error against the leaf's largest).

It prints, in order: the card line, per-phase results, one JSON line with
every kernel's numbers (with the shapes phases 3e-3g gave it and its
launches there), and last ``{"ok": true, "device": {...}}``.
``--out DIR`` also writes every measurement and nvcc's ptxas report there.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
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
        "ssd_scan": ("ssd_chunk", "ssd_state_pass")})
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
    smem.update({f"moe_gmm E={e}": gmm_lib.moe_gmm_wgmma_smem_bytes(e) for e in (128, 160)})
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


def kernel_split(fn, names, calls=5):
    """Device time (ms per call) of ``fn``'s kernels by name: the profiler's
    device events over ``calls`` calls, summed by which of ``names`` each
    kernel's name holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in names}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for k in names:
            if k in e.key:
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
        splits = da.splits_for(b, kh, t)
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
                             ("qwen3 sorted decode", qwen, 2, 1),
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
            body = gmm.body_for(tdt, d_in, d_out, n_experts=e)
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
                if dtype == "bfloat16":  # the wgmma body against the mma body, in turns
                    row["kernel_ms"], row["old_body_ms"], row["turns_ms"] = in_turns(
                        lambda: gmm.moe_gmm(x, w, sizes),
                        lambda: gmm.moe_gmm(x, w, sizes, body="mma"), flush, reps)
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
                old_txt = (f" mma body={old:.4f} ms ({flops / old / 1e9:.1f} TFLOP/s)"
                           if old is not None else "")
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
        got = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
        errs = {}
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            ok, err, rel = grad_close(x, w, dtype)
            errs[name] = dict(max_abs_err=err, max_row_rel_err=rel)
            if not ok:
                raise AssertionError(f"flash backward {model} {dtype} {case} {name}: max err "
                                     f"{err} ({rel:.3e} of its row) outside {TOL[dtype]}")
        del got, want
        reps = 10 if sq * sk <= 2048 * 2048 else 5
        kernel_ms = cuda_time_ms(lambda: fb.flash_attention_bwd(q, k, v, out, do, lse, **kw),
                                 flush, reps=reps)
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
                   body=body, max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   errors=errs, lse_err=lse_err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes, flops=flops,
                   bound_by=bound_by, kernel_tflops=flops / kernel_ms / 1e9,
                   forward_body=fa.body_for(tdt, d), forward_with_lse_ms=with_lse_ms,
                   forward_without_lse_ms=without_lse_ms, forward_lse_turns_ms=lse_turns)
        rows.append(row)
        err_txt = "/".join(f"{e['max_abs_err']:.2e}" for e in errs.values())
        print(f"{model:18s} {dtype:8s} B={b} S={sq:5d}x{sk:5d} H={h:3d} KH={kh:3d} D={d:3d} "
              f"{case:12s} {body} err dq/dk/dv={err_txt} "
              f"kernel={kernel_ms:.4f} ms plain={plain_ms:.4f} ms library (SDPA backward)="
              f"{library_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}) "
              f"{row['kernel_tflops']:.1f} TFLOP/s; forward ({row['forward_body']}) with LSE "
              f"{with_lse_ms:.4f} ms, without {without_lse_ms:.4f} ms; LSE err {lse_err:.1e}",
              flush=True)
        del q, k, v, do, out, lse, plain_lse
    return rows


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
    ``decode_step`` calls with the engine's impl and the scan dispatch).
    Returns (tokens (B, decode_tokens) int32, wall seconds, the last
    step's logits)."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, init_cache

    hosted = engine.models[mid]
    t0 = time.perf_counter()
    b, s = prompt.shape
    kw = dict(impl=engine.impl, moe_dispatch="scan")
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


def profile_task(fn, engine, mid, prompt, what):
    """Device time of one task ``fn(mid, prompt)`` (the profiler's device
    events) against its wall time, and the decode-attention kernels the
    card ran, by name: for a graphed task their main kernels must equal
    the launches the engine counts for its replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.reset_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(mid, prompt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    device_ms = sum(dev_us(e) for e in events) / 1e3
    by_name = {k: sum(e.count for e in events if k in e.key) for k in DECODE_KERNELS}
    main = by_name["decode_attention_kernel"] + by_name["decode_split"]
    replayed = engine.replayed_launches["decode_attention"]
    kernels = sum(e.count for e in events)
    print(f"profile of one {what}: device busy {device_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"({100 * device_ms / wall_ms:.1f} %), {kernels} kernels; decode-attention kernels "
          f"{by_name}, the engine's replayed launches {replayed}", flush=True)
    if engine.replays and main != replayed:
        raise AssertionError(f"{what}: the card ran {main} decode-attention kernels, the "
                             f"engine counted {replayed} launches in its replays")
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
                kernels=kernels, decode_kernels=by_name, replayed_launches=replayed,
                replays=engine.replays)


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


def profile_decode(hosted, prompt, dev, steps=4, cache=None):
    """Device time of a few decode steps by kernel, against their wall time
    (the profiler's own overhead is inside the wall time).  Without a
    ``cache``, a small one after one step on ``prompt[:, 0]``; with one,
    the steps take ``prompt[:, :steps]`` from where it stands."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, init_cache

    first = 0
    if cache is None:
        cache = init_cache(hosted.cfg, 2, steps + 2, device=dev)
        decode_step(hosted.params, cache, prompt[:, 0], hosted.cfg)
        first = 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            decode_step(hosted.params, cache, prompt[:, first + i], hosted.cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the kernels): the operators' own rows carry
    # their kernels' time again
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    total_ms = sum(dev_us(e) for e in events) / 1e3
    attn_ms = sum(dev_us(e) for e in events if any(k in e.key for k in DECODE_KERNELS)) / 1e3
    kernels_per_step = sum(e.count for e in events) / steps
    top = sorted(events, key=dev_us, reverse=True)[:10]
    print(f"  decode_attention kernels: {attn_ms:.3f} ms")
    print(f"profile of {steps} {hosted.cfg.name} decode steps: device busy {total_ms:.2f} ms "
          f"of {wall_ms:.2f} ms wall ({100 * total_ms / wall_ms:.1f} %), "
          f"{kernels_per_step:.0f} kernels per step")
    rows = []
    for e in top:
        rows.append(dict(name=e.key, device_ms=dev_us(e) / 1e3, calls=e.count))
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    print(f"  per step: device {total_ms / steps:.3f} ms, decode attention "
          f"{attn_ms / steps:.3f} ms ({100 * attn_ms / max(total_ms, 1e-9):.1f} % of device time), "
          f"wall {wall_ms / steps:.2f} ms")
    return dict(steps=steps, wall_ms=wall_ms, device_ms=total_ms, attention_ms=attn_ms,
                kernels_per_step=kernels_per_step, top=rows)


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
    from repro_torch.kernels import ssd_scan as ssd

    # the backward's count is zeroed too, and read by phase 6 alone
    da.launches = fa.launches = fb.launches = ssd.launches = gmm.launches = 0
    for mod in (da, fa, fb, ssd, gmm):
        mod.launches_by_body.clear()
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

    # 3. one serving task, as the reference serves it (scan dispatch),
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
    if dec["sorted"]["by_body"]["moe_gmm"] != {"wgmma": 3 * n * dec_steps}:
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
    """Device time of one call of ``fn`` (the profiler's device events)
    against its wall time, which ends in a synchronise; with ``top``, also
    the ``top`` kernels that took the most device time, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(
        getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profile of {what}: device busy {device_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"({100 * device_ms / wall_ms:.1f} %)", flush=True)
    out = dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms)
    if top:
        rows = sorted(((getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
        out["top"] = [dict(ms=ms, count=n, kernel=k) for ms, n, k in rows[::-1][:top]]
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
    and one step's in the warm-up (every one on the split body), no other
    kernel; the tokens, the wall time, the graph's capture."""
    from repro_torch.kernels import decode_attention as da

    cfg = engine.models[0].cfg
    read = counts_zeroed(engine)
    generated, wall = engine.run_task(0, prompt)
    launches, by_body = read(), bodies(engine)
    steps = prompt.shape[1] + engine.decode_tokens
    warm = da.launches
    (graph,) = graph_rows(engine)
    print(f"{cfg.name} serving task (B=2, {prompt.shape[1]}-token prompt, 6 tokens"
          f"{', scan' if moe else ''}): {wall:.3f} s with the capture, {wall / steps * 1e3:.2f} "
          f"ms per decode step; launches {launches} ({warm} decode in the warm-up); by body "
          f"{by_body}", flush=True)
    want = dict(decode_attention=want_decode + want_decode // steps, flash_attention=0,
                ssd_scan=0, moe_gmm=0)
    if launches != want or by_body != on_bodies(want, decode_attention="split") \
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


def train_step_run(cfg, steps):
    """``make_train_step`` (remat, fp32 AdamW moments) on NeMo's width at
    ``cfg``'s depth over the synthetic pipeline: one warm-up step, then
    ``steps`` timed steps, the counts set to 0 just before them and read
    just after."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
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
    probe_leaf = params["layers"]["wq"][0, :64, :64].detach().clone()
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
    peak = torch.cuda.max_memory_allocated()
    moved = float((params["layers"]["wq"][0, :64, :64].detach() - probe_leaf).abs().max())
    out = dict(layers=cfg.n_layers, params=n, steps=steps, wall_s=walls, losses=losses,
               grad_norms=norms, warm_up_loss=warm_loss, launches=launches,
               flash_by_body=fwd_by_body, bwd_launches=bwd_launches, bwd_by_body=bwd_by_body,
               peak_bytes=peak, moved=moved)
    return params, state, step, data, out


def train_full_width():
    """Phase 6: NeMo at full width and 8 of its 40 layers, bf16 params and
    fp32 AdamW moments, B = 2, S = 2048 of the synthetic pipeline, through
    ``make_train_step`` with remat: one warm-up step and five timed steps,
    every flash forward on wgmma and every backward on mma, the counts per
    step, finite losses, moved params, the step time, tokens/s, 6·N·tokens
    over the step time, the peak memory and the device's busy share; then
    one step's loss, grad-norm and per-leaf gradients at 2 layers, kernel
    path against plain path."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models import init_params, next_token_loss

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
    if out["bwd_launches"] != want_bwd or out["bwd_by_body"] != {"mma": want_bwd}:
        raise AssertionError(f"flash backward launches {out['bwd_by_body']}, expected "
                             f"{want_bwd} on mma")
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
    runs = {}
    for impl in ("auto", "ref"):
        loss = next_token_loss(params, {"tokens": toks}, cfg2, impl=impl, remat=True)
        loss.backward()
        grads = {n: p.grad.float() for n, p in params.named_parameters()}
        norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        runs[impl] = (float(loss), norm, grads)
        params.zero_grad(set_to_none=True)
    (la, na, ga), (lr_, nr, gr) = runs["auto"], runs["ref"]
    leaves = {}
    for n, g in gr.items():
        cos = float(torch.nn.functional.cosine_similarity(ga[n].flatten(), g.flatten(), dim=0))
        rel = float((ga[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
        leaves[n] = dict(cosine=cos, max_err_share=rel)
    worst_cos = min(v["cosine"] for v in leaves.values())
    worst_rel = max(v["max_err_share"] for v in leaves.values())
    print(f"{TRAIN_MODEL}@{TRAIN_COMPARE_LAYERS} one step, kernel path against plain path: "
          f"loss {la:.5f} / {lr_:.5f}, grad norm {na:.5f} / {nr:.5f}; per leaf: lowest cosine "
          f"{worst_cos:.5f}, largest max error {worst_rel:.4f} of the leaf's largest", flush=True)
    for n, v in sorted(leaves.items()):
        print(f"  {n}: cosine {v['cosine']:.5f}, max err {v['max_err_share']:.4f}")
    out["compare"] = dict(layers=TRAIN_COMPARE_LAYERS, loss=(la, lr_), grad_norm=(na, nr),
                          leaves=leaves)
    if not (abs(la - lr_) <= TOL["bfloat16"] * abs(lr_) and abs(na - nr) <= TOL["bfloat16"] * nr):
        raise AssertionError("the kernel path's loss or grad norm differs from the plain path's")
    if worst_cos < TRAIN_COS or worst_rel > TRAIN_LEAF_TOL:
        raise AssertionError(f"gradients differ: cosine {worst_cos}, max err {worst_rel}")
    del params, runs, ga, gr, grads, loss, g
    release_models()
    return out


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
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(
            dict(card=card, build=built, kernels=rows, flash=flash_rows, ssd=ssd_rows,
                 gmm=gmm_rows, flash_bwd=bwd_rows, training=training, serving=served, prefill=prefill, planes=planes,
                 qwen3_moe=qwen,
                 deepseek_v2=deepseek, zamba2=zamba, whisper=whisper, qwen2_vl=vlm,
                 reduced=reduced, planner=planner, constants=constants,
                 simulator=simulated, idle_power_w=idle_w,
                 failed=phases.failed, tracebacks=phases.tracebacks), indent=1, default=str))
    if phases.failed or not built:
        die(f"failed phases: {phases.failed}")
    main_row = next(r for r in rows if all(r[k] == MAIN_SHAPE[k] for k in MAIN_SHAPE))
    flash_row = next(r for r in flash_rows if all(r[k] == FLASH_MAIN[k] for k in FLASH_MAIN))
    ssd_row = next(r for r in ssd_rows if all(r[k] == SSD_MAIN[k] for k in SSD_MAIN))
    gmm_row = next(r for r in gmm_rows if all(r[k] == GMM_MAIN[k] for k in GMM_MAIN))
    granite_row = next(r for r in rows if all(r[k] == GRANITE_SHAPE[k] for k in GRANITE_SHAPE))
    bwd_row = next(r for r in bwd_rows if all(r[k] == BWD_MAIN[k] for k in BWD_MAIN))

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
        "flash_attention_bwd": [shape_of(r, ("model", "b", "s", "sk", "h", "kh", "d", "case"))
                                for r in bwd_rows],
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
    }]
    for k in kernels:
        k.update(slice_shapes=slice_rows[k["name"]],
                 launches_by_phase=phase_launches(k["name"]) if k["name"] != "flash_attention_bwd"
                 else {f"6 {TRAIN_MODEL}@{training['layers']}": training["bwd_launches"]})
    kernels[1]["launches_by_phase"][f"6 {TRAIN_MODEL}@{training['layers']} (training)"] = \
        training["launches"]["flash_attention"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
