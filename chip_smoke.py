#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (or any sm_90a card).

    python3 chip_smoke.py [--out DIR]

It needs the checkout around it (``src/repro_torch``), PyTorch with CUDA,
``nvcc`` and one card, and exits non-zero when any of them is missing or
any phase fails.  Phases:

1. the card (name and power limit) and the build of every kernel under
   ``src/repro_torch/csrc`` for sm_90a, one nvcc per source, all at once;
2. each kernel against its plain PyTorch version on the card, at the zoo's
   shapes and the reference tolerances, with its time beside the plain
   version's, one PyTorch library call's and the least time the card could
   take (its bound): decode attention (2), flash attention (2b), the
   SSD scan (2c) and the MoE grouped matmul (2d, group sizes from a seeded
   router's top-k at Qwen3-MoE's and DeepSeek-V2's prefill and decode);
3. the decode path at full width in bf16: a 3-worker ServingCluster on one
   card serving 10 pipeline requests (prompts (2, 64)) over
   mistral-nemo-12b (full depth), mamba2-780m (full) and granite-20b (full
   width, depth cut to fit beside NeMo), with kernel launch counts read
   around the run; then NeMo's logits, kernel path against plain path;
3b. the prefill path at full width in bf16, on phase 3's weights:
   ``make_prefill_step`` over B = 2, S = 2048 seeded tokens for each model,
   with the flash and SSD launch counts read around the runs, finite logits
   and loss, and the last position's logits, kernel path against plain
   path; then NeMo's forward over phase 3's prompt against its decode path,
   within ``LOGIT_BOUND`` with equal argmax;
3c. once phase 3's models are released: Qwen3-MoE at full width and depth
   in bf16: ``make_prefill_step`` over B = 2, S = 2048 twice with the flash
   and grouped-matmul launch counts, the loss, one MoE layer and the whole
   model held kernel path against plain path (with the tokens whose expert
   set differs between the two counted per layer), one serving task
   (``ExecutionEngine.run_task``, scan dispatch) and sorted against scan
   decode from one cache;
3d. the same for DeepSeek-V2 (MLA, shared experts) at full width with its
   depth cut to 4 layers;
4. the reduced fp32 serve example, kernel path against plain path: equal
   assignments and tokens.

It prints, in order: the card line, per-phase results, one JSON line with
every kernel's numbers, and last ``{"ok": true, "device": {...}}``.
``--out DIR`` also writes every measurement and nvcc's ptxas report there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
MAIN_SHAPE = dict(model="mistral-nemo-12b", b=2, h=32, kh=8, d=128, t=13, dtype="bfloat16")
# the prefill phase's shapes: B = 2, S = 2048, bf16
PREFILL_B, PREFILL_S = 2, 2048
FLASH_MAIN = dict(model="mistral-nemo-12b", b=PREFILL_B, s=PREFILL_S, case="causal", dtype="bfloat16")
SSD_MAIN = dict(b=PREFILL_B, t=PREFILL_S, dtype="bfloat16")
# Qwen3-MoE's prefill: B·S·top_k = 32768 rows over 128 experts, 2048 -> 768
GMM_MAIN = dict(model="qwen3 prefill", d_in=2048, d_out=768, dtype="bfloat16")
# what phase 3 hands to phase 3b: the hosted models and NeMo's prompt and logits
SHARED = {}


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
    return {"build_wall_s": wall, "build_s": dict(_build.build_seconds),
            "ptxas": dict(_build.build_logs)}


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


def kernel_vs_plain():
    import torch
    from repro_torch.kernels import decode_attention as da

    dev = torch.device("cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    models = {
        "mistral-nemo-12b": (2, 32, 8, 128),
        "granite-20b": (2, 48, 1, 128),
    }
    shapes = [(m, *s, t) for m, s in models.items() for t in (13, 300, 4096, 32768)]
    # the zoo's other head dims: whisper 64, zamba2 112, MLA 192 (hd + rope)
    shapes += [("whisper-medium", 2, 16, 16, 64, 300), ("zamba2-7b", 2, 32, 32, 112, 300),
               ("deepseek-v2-236b", 2, 128, 128, 192, 300)]
    rows = []
    for model, b, h, kh, d, t in shapes:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q = torch.randn(b, h, d, generator=gen, device=dev, dtype=tdt)
            k = torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=tdt)
            v = torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=tdt)
            ragged = int(torch.randint(1, t + 1, (1,), generator=gen, device=dev))
            errs = {}
            for case, lens in (("full", [t, t]), ("0+ragged", [0, ragged]),
                               ("1+ragged", [1, ragged])):
                n = torch.tensor(lens[:b], dtype=torch.int32, device=dev)
                got = da.decode_attention(q, k, v, n).float()
                torch.cuda.synchronize()
                want = da.decode_attention_plain(q, k, v, n).float()
                errs[case] = float((got - want).abs().max())
                if not torch.allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype]):
                    raise AssertionError(f"{model} {dtype} T={t} lens={lens}: "
                                         f"max err {errs[case]} outside {TOL[dtype]}")
                if lens[0] == 0 and bool(got[0].ne(0).any()):
                    raise AssertionError(f"{model} {dtype} T={t}: empty row is not 0")
            n = torch.full((b,), t, dtype=torch.int32, device=dev)
            kernel_ms = cuda_time_ms(lambda: da.decode_attention(q, k, v, n), flush)
            plain_ms = cuda_time_ms(lambda: da.decode_attention_plain(q, k, v, n), flush)
            lib = library_call(q, k, v, n)
            library_ms = cuda_time_ms(lib, flush)
            lib_err = float((lib()[:, :, 0].float() - da.decode_attention_plain(q, k, v, n).float()).abs().max())
            bound_ms, nbytes, flops, bound_by = decode_bound(b, h, kh, d, [t] * b, dtype, q.element_size())
            row = dict(model=model, b=b, h=h, kh=kh, d=d, t=t, dtype=dtype,
                       max_abs_err=max(errs.values()), errs=errs, kernel_ms=kernel_ms,
                       plain_ms=plain_ms, library_ms=library_ms, library_err=lib_err,
                       bound_ms=bound_ms, bound_us_bytes=nbytes / HBM_BYTES_PER_S * 1e6,
                       bytes=nbytes, flops=flops, bound_by=bound_by,
                       ctas=b * kh * -(-(h // kh) // 32))
            rows.append(row)
            print(f"{model:18s} {dtype:8s} B={b} H={h:3d} KH={kh:3d} D={d:3d} T={t:5d} "
                  f"err={row['max_abs_err']:.2e} kernel={kernel_ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms library={library_ms:.4f} ms "
                  f"bound={bound_ms * 1e3:.2f} us ({bound_by}) ctas={row['ctas']}",
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
    ]
    rows = []
    for model, b, sq, sk, h, kh, d, case, causal, window, q_offset in shapes:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q = torch.randn(b, sq, h, d, generator=gen, device=dev, dtype=tdt)
            k = torch.randn(b, sk, kh, d, generator=gen, device=dev, dtype=tdt)
            v = torch.randn(b, sk, kh, d, generator=gen, device=dev, dtype=tdt)
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
            kernel_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush, reps=reps)
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
                       max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, library_err=lib_err, bound_ms=bound_ms,
                       bytes=nbytes, flops=flops, bound_by=bound_by,
                       kernel_tflops=flops / kernel_ms / 1e9,
                       ctas=-(-sq // 64) * h * b)
            rows.append(row)
            lib_txt = f"{library_ms:.4f} ms" if library_ms is not None else "-"
            print(f"{model:18s} {dtype:8s} B={b} S={sq:5d}x{sk:5d} H={h:3d} KH={kh:3d} D={d:3d} "
                  f"{case:14s} err={err:.2e} kernel={kernel_ms:.4f} ms plain={plain_ms:.4f} ms "
                  f"library={lib_txt} bound={bound_ms:.4f} ms ({bound_by}) "
                  f"{row['kernel_tflops']:.1f} TFLOP/s ctas={row['ctas']}", flush=True)
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
    cfg = ARCHS["mamba2-780m"]
    h, p, n, chunk = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    rows = []
    for b, t in ((2, 2048), (2, 8192), (2, 2000)):
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            x = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(tdt)
            dt = F.softplus(torch.randn(b, t, h, generator=gen, device=dev))
            a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
            bb = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(tdt)
            cc = (torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5).to(tdt)
            y, fs = ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
            torch.cuda.synchronize()
            ye, fse = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk)
            err = float((y.float() - ye.float()).abs().max())
            state_err = float((fs - fse).abs().max())
            if not (torch.allclose(y.float(), ye.float(), **SSD_TOL[dtype])
                    and torch.allclose(fs, fse, **SSD_TOL["float32"])):
                raise AssertionError(f"ssd {dtype} T={t}: max err y {err}, state {state_err} "
                                     f"outside {SSD_TOL[dtype]}")
            bound_ms, nbytes, flops, bound_by = ssd_bound(b, t, h, p, n, chunk, dtype,
                                                          x.element_size())
            row = dict(model="mamba2-780m", b=b, t=t, h=h, p=p, n=n, chunk=chunk, dtype=dtype,
                       max_abs_err=err, state_err=state_err, bound_ms=bound_ms, bytes=nbytes,
                       flops=flops, bound_by=bound_by, library_ms=None, ctas=b * h)
            if t % chunk == 0:  # the ragged row checks the edge and is not timed
                row["kernel_ms"] = cuda_time_ms(lambda: ssd.ssd_scan(x, dt, a, bb, cc, chunk=chunk),
                                                flush, reps=10)
                row["plain_ms"] = cuda_time_ms(
                    lambda: ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk), flush, reps=10)
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
            rows.append(row)
            times = (f"kernel={row['kernel_ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
                     f"{row['kernel_tflops']:.2f} TFLOP/s" if "kernel_ms" in row else "not timed")
            print(f"mamba2-780m        {dtype:8s} B={b} T={t:5d} H={h} P={p} N={n} L={chunk} "
                  f"err y={err:.2e} state={state_err:.2e} {times} library=- "
                  f"bound={bound_ms:.4f} ms ({bound_by}) ctas={b * h}", flush=True)
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
            row = dict(model=model, t=t, e=e, d_in=d_in, d_out=d_out, dtype=dtype,
                       nonempty=sum(1 for n in host_sizes if n > 0),
                       max_rows=max(host_sizes), max_abs_err=err, oracle_err=oracle_err,
                       bound_ms=bound_ms,
                       bytes=nbytes, flops=flops, bound_by=bound_by, library_ms=None)
            if timed:
                reps = 25 if t * d_in * d_out < 2**34 else 10
                row["kernel_ms"] = cuda_time_ms(lambda: gmm.moe_gmm(x, w, sizes), flush, reps=reps)
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
                times = (f"kernel={row['kernel_ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
                         f"library={lib_txt} {row['kernel_tflops']:.1f} TFLOP/s "
                         f"{row['kernel_tb_per_s']:.2f} TB/s")
            else:
                times = "not timed"
            print(f"{model:20s} {dtype:8s} T={t:5d} E={e:3d} ({row['nonempty']} non-empty, "
                  f"largest {row['max_rows']}) {d_in:4d}->{d_out:4d} err={err:.2e} "
                  f"(oracle {oracle_err:.2e}) {times} "
                  f"bound={bound_ms:.4f} ms ({bound_by})", flush=True)
            del x, w
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def serve_full_width():
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.core import ClusterSpec, GB
    from repro_torch.examples import serve_cluster as ex
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving import HostedModel, ServingCluster

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
    sc = ServingCluster(ClusterSpec(n_workers=3, gpu_capacity_bytes=80 * GB), hosted,
                        scheduler="navigator", decode_tokens=decode_tokens, device=dev)
    sc.register_pipeline(spec)
    sc.register_pipeline(summ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.launches = 0
    t0 = time.perf_counter()
    for i, (kind, prompt) in enumerate(requests):
        dfg, entry = (spec, "draft") if kind == 0 else (summ, "perceive")
        sc.submit(dfg, {entry: prompt}, origin=i % 3)
    wall = time.perf_counter() - t0
    launches = da.launches

    # what the requests ran: prefill + decode steps of each task, times its layers
    expected, tokens_out, steps = 0, 0, {}
    for r in sc.results:
        dfg = spec if r.dfg_name == spec.name else summ
        for tid, task in dfg.tasks.items():
            n_in = prompt_len if not dfg.preds[tid] else decode_tokens * len(dfg.preds[tid])
            cfg = cfgs[task.model_id]
            steps[cfg.name] = steps.get(cfg.name, 0) + n_in + decode_tokens
            if cfg.arch_type == "dense":
                expected += cfg.n_layers * (n_in + decode_tokens)
            tokens_out += r.outputs[tid].size
    for r in sc.results:
        print(f"  job {r.job_id} {r.dfg_name:20s} assign={r.assignment} "
              f"wall={r.latency_s:.3f} s")
    peak = torch.cuda.max_memory_allocated()
    summary = dict(
        requests=len(sc.results), wall_s=wall, decoded_tokens=tokens_out,
        decoded_tokens_per_s=tokens_out / wall, steps=steps,
        cache_hit_rate=sc.cache_hit_rate(), workers_used=sc.workers_used(),
        max_memory_allocated=peak, launches=launches, expected_launches=expected,
        granite_layers=granite_layers,
        latencies_s=[r.latency_s for r in sc.results],
        assignments=[r.assignment for r in sc.results],
    )
    print(f"decoded tokens/s: {tokens_out / wall:.1f} ({tokens_out} tokens in {wall:.2f} s)")
    print(f"cache hit rate: {sc.cache_hit_rate():.3f}; workers used: {sc.workers_used()}")
    print(f"torch.cuda.max_memory_allocated: {peak / 1e9:.2f} GB")
    print(f"decode_attention launches: {launches} (expected {expected})")
    if launches != expected or launches == 0:
        raise AssertionError(f"decode_attention launched {launches} times, expected {expected}")

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
    return summary


def profile_decode(hosted, prompt, dev, steps=4):
    """Device time of a few decode steps by kernel, against their wall time
    (the profiler's own overhead is inside the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, init_cache

    cache = init_cache(hosted.cfg, 2, steps + 2, device=dev)
    decode_step(hosted.params, cache, prompt[:, 0], hosted.cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            decode_step(hosted.params, cache, prompt[:, i + 1], hosted.cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the kernels): the operators' own rows carry
    # their kernels' time again
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    total_ms = sum(dev_us(e) for e in events) / 1e3
    attn_ms = sum(dev_us(e) for e in events if "decode_attention" in e.key) / 1e3
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
    for h in models:
        step = make_prefill_step(h.cfg, device=dev)
        f0, s0 = fa.launches, ssd.launches
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
        got = dict(flash=fa.launches - f0, ssd=ssd.launches - s0)
        want = dict(flash=h.cfg.n_layers * calls if dense else 0,
                    ssd=0 if dense else h.cfg.n_layers * calls)
        tokens = PREFILL_B * PREFILL_S
        out[h.cfg.name] = dict(layers=h.cfg.n_layers, wall_s=walls,
                               tokens_per_s=[tokens / w for w in walls],
                               launches=got, expected_launches=want)
        print(f"{h.cfg.name} ({h.cfg.n_layers} layers) prefill B={PREFILL_B} S={PREFILL_S}: "
              f"wall {', '.join(f'{w:.3f}' for w in walls)} s, "
              f"{', '.join(f'{tokens / w:.0f}' for w in walls)} tokens/s; "
              f"launches flash {got['flash']} (expected {want['flash']}), "
              f"ssd {got['ssd']} (expected {want['ssd']})", flush=True)
        if got != want:
            raise AssertionError(f"{h.cfg.name}: launches {got}, expected {want}")
    launches = dict(flash_attention=fa.launches, ssd_scan=ssd.launches,
                    decode_attention=da.launches)
    print(f"prefill launches: {launches}")

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
    return out


# ---------------------------------------------------------------------------
# phases 3c and 3d: the MoE family at full width
# ---------------------------------------------------------------------------
def release_models():
    """Drop every model an earlier phase left, and hand its memory back."""
    import gc
    import torch

    SHARED.clear()
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


def compare_logits(what, x, y):
    err, scale = float((x - y).abs().max()), float(y.abs().max())
    same = bool((x.argmax(-1) == y.argmax(-1)).all())
    print(f"{what}: max |diff| {err:.4e} of {scale:.4e} (ratio {err / scale:.3e}), "
          f"argmax equal: {same}", flush=True)
    return dict(max_abs_diff=err, max_abs_logit=scale, ratio=err / scale, argmax_equal=same)


def counts_zeroed():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ssd_scan as ssd

    da.launches = fa.launches = ssd.launches = gmm.launches = 0
    return lambda: dict(decode_attention=da.launches, flash_attention=fa.launches,
                        ssd_scan=ssd.launches, moe_gmm=gmm.launches)


def moe_full_width(name, layers=None, reason=None):
    """Prefill (twice, with launch counts), the loss, the kernel path against
    the plain path (whole model and one MoE layer), one serving task, and
    sorted against scan decode on one cache, for the MoE model ``name``."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, forward, init_cache, init_params, next_token_loss
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import ExecutionEngine, HostedModel
    from repro_torch.training import make_prefill_step

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
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                                     device=dev)}
    n = cfg.n_layers

    # 1. prefill, the main path: counts set to 0 just before, read just after
    step = make_prefill_step(cfg, device=dev)
    calls, walls = 2, []
    torch.cuda.reset_peak_memory_stats()
    read = counts_zeroed()
    for _ in range(calls):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    launches = read()
    want = dict(decode_attention=0, flash_attention=n * calls, ssd_scan=0,
                moe_gmm=3 * n * calls)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite prefill logits")
    del logits
    tokens = PREFILL_B * PREFILL_S
    out.update(prefill_wall_s=walls, prefill_tokens_per_s=[tokens / w for w in walls],
               prefill_launches=launches, prefill_expected_launches=want,
               prefill_peak_bytes=torch.cuda.max_memory_allocated())
    print(f"{name} prefill B={PREFILL_B} S={PREFILL_S}: wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} s, "
          f"{', '.join(f'{tokens / w:.0f}' for w in walls)} tokens/s; launches {launches} "
          f"(expected {want}); peak {out['prefill_peak_bytes'] / 1e9:.2f} GB", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: prefill launches {launches}, expected {want}")
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

    # 3. one serving task, as the reference serves it (scan dispatch)
    hosted = HostedModel(0, cfg, params, dev)
    engine = ExecutionEngine({0: hosted}, decode_tokens=6, device=dev)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)
    serve = []
    for _ in range(2):
        read = counts_zeroed()
        generated, wall = engine.run_task(0, prompt)
        got = read()
        steps = prompt.shape[1] + 6
        serve.append(dict(wall_s=wall, step_ms=wall / steps * 1e3, launches=got,
                          tokens=generated.tolist()))
        print(f"{name} serving task (B=2, 64-token prompt, 6 tokens, scan): {wall:.3f} s, "
              f"{wall / steps * 1e3:.2f} ms per decode step; launches {got}", flush=True)
        if got["decode_attention"] != n * steps or got["moe_gmm"] != 0:
            raise AssertionError(f"{name}: serving launches {got}")
    out["serve"] = serve

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
        d.update(logits=step_logits.float(), launches=read(), rec=rec)
        d["step_ms"].append(ms)
    for dispatch in ("sorted", "scan"):
        print(f"{name} decode step (B=2, bf16), {dispatch}: {dec[dispatch]['step_ms']} ms; "
              f"launches {dec[dispatch]['launches']}", flush=True)
    if dec["sorted"]["launches"]["moe_gmm"] != 3 * n * dec_steps:
        raise AssertionError(f"{name}: sorted decode launched moe_gmm "
                             f"{dec['sorted']['launches']['moe_gmm']} times")
    dec_flips = flips(dec["sorted"]["rec"], dec["scan"]["rec"])
    dcmp = compare_logits(f"{name} decode logits after {dec_steps} steps, sorted vs scan",
                          dec["sorted"]["logits"], dec["scan"]["logits"])
    print(f"  routing flips per layer and step (of 2 tokens): {sum(dec_flips)} in all")
    dcmp.update(flips=dec_flips)
    out["decode"] = {k: dict(step_ms=v["step_ms"], launches=v["launches"]) for k, v in dec.items()}
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
# phase 4: the reduced fp32 example, kernel path against plain path
# ---------------------------------------------------------------------------
def reduced_example():
    from repro_torch.examples import serve_cluster as ex

    requests = ex.make_requests()
    out = {}
    for sched in ("navigator", "hash"):
        runs = {}
        for impl in ("auto", "ref"):
            sc, _, _ = ex.run(sched, requests, lambda: ex.reduced_hosted("cuda"),
                              device="cuda", impl=impl)
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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phases = Phases()
    built = phases.run("phase 1: build kernels", build_kernels)
    rows = phases.run("phase 2: decode_attention against plain", kernel_vs_plain) if built else None
    flash_rows = phases.run("phase 2b: flash_attention against plain", flash_vs_plain) \
        if built else None
    ssd_rows = phases.run("phase 2c: ssd_scan against plain", ssd_vs_plain) if built else None
    gmm_rows = phases.run("phase 2d: moe_gmm against plain", gmm_vs_plain) if built else None
    served = phases.run("phase 3: serving at full width (bf16)", serve_full_width) if built else None
    prefill = phases.run("phase 3b: prefill at full width (bf16)", prefill_full_width) \
        if built else None
    qwen = phases.run("phase 3c: Qwen3-MoE at full width and depth (bf16)",
                      qwen3_moe_full_width) if built else None
    deepseek = phases.run("phase 3d: DeepSeek-V2 at full width, 4 layers (bf16)",
                          deepseek_v2_cut_depth) if built else None
    release_models()
    reduced = phases.run("phase 4: reduced fp32 example, kernel against plain", reduced_example) \
        if built else None
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(
            dict(card=card, build=built, kernels=rows, flash=flash_rows, ssd=ssd_rows,
                 gmm=gmm_rows, serving=served, prefill=prefill, qwen3_moe=qwen,
                 deepseek_v2=deepseek, reduced=reduced,
                 failed=phases.failed, tracebacks=phases.tracebacks), indent=1, default=str))
    if phases.failed or not built:
        die(f"failed phases: {phases.failed}")
    main_row = next(r for r in rows if all(r[k] == MAIN_SHAPE[k] for k in MAIN_SHAPE))
    flash_row = next(r for r in flash_rows if all(r[k] == FLASH_MAIN[k] for k in FLASH_MAIN))
    ssd_row = next(r for r in ssd_rows if all(r[k] == SSD_MAIN[k] for k in SSD_MAIN))
    gmm_row = next(r for r in gmm_rows if all(r[k] == GMM_MAIN[k] for k in GMM_MAIN))
    kernels = [{
        "name": "decode_attention",
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
    }, {
        "name": "flash_attention",
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
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
