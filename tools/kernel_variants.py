#!/usr/bin/env python3
"""Time variants of one of the port's kernel bodies against the source as
it stands, on one card.

    python3 tools/kernel_variants.py flash_attention \\
        --variant "bkv128=BKV = D <= 64 ? 128 : 64=>BKV = D <= 128 ? 128 : 64"
    python3 tools/kernel_variants.py moe_gmm \\
        --variant "bn256=BN = 128;            // columns=>BN = 256;            // columns"
    python3 tools/kernel_variants.py decode_attention --ctas-per-sm 4 \\
        --variant "st2=DP > 192 ? 2 : 3=>2"
    python3 tools/kernel_variants.py ssd_scan --variant "w8=STATE_THREADS = 128=>STATE_THREADS = 256"
    python3 tools/kernel_variants.py flash_attention_bwd --variant "one_wg=KV_WGS = 2;=>KV_WGS = 1;"
    python3 tools/kernel_variants.py ssd_scan_fused --split 2 --unchecked \
        --variant "no_cs=kk < NP / 16; ++kk) {  // C S_in^T=>kk < 0; ++kk) {"
    python3 tools/kernel_variants.py decode_partials --cluster 8
    python3 tools/kernel_variants.py ssd_scan_rank --pdl

Each ``--variant NAME=OLD=>NEW`` replaces the text OLD, which must occur
exactly once, by NEW in ``src/repro_torch/csrc/<kernel>.cu``
(``OLD=>NEW&&OLD2=>NEW2`` makes several replacements).  Every
variant and the unchanged source ("base") are built with the port's nvcc
flags into ``build/variants/`` (ptxas's warnings and spills for the timed
body's kernels are printed), checked against the kernel's plain PyTorch
version at each shape (decode attention by ``chip_smoke.py``'s phase-2
check, the flash backward's dq, dk and dv by phase 2e's), and timed
through the body the main path runs (flash attention, its backward and
the grouped matmul: wgmma; decode attention: split; the SSD scan:
chunked) at the shapes of the main path, in turns (base,
variants, variants reversed, base), each time the median of 20 calls
between CUDA events with the L2 cache flushed before each call.
``--ctas-per-sm`` sets the CTAs an SM decode attention's split count aims
for (``decode_attention.CTAS_PER_SM``), for every variant alike.  ``ssd_scan_fused`` times the SSD scan's
fused body and ``decode_partials`` the cluster body of the partials of
one tensor-parallel rank's slice, each at one rank's shapes at |model| =
16 (``--split`` and ``--cluster`` fix the fused body's P split and the
cluster body's CTAs a cluster).  ``ssd_scan_rank`` times the chunked
body at those shapes, with the unchanged source's fused body in the same
turns; ``--pdl`` adds the variant "pdl": the chunked body's three
launches joined by programmatic dependent launch ((a) and (b) let the
next launch start at once; (b) waits for (a), and (c) stages its inputs
and forms C B^T, M and M X before it waits for (b) and loads S_in).
``--unchecked`` times variants without holding them to the plain
version (one that leaves out a step, to see what that step costs).  A
variant that does not build, or whose launch the card refuses, is
reported and dropped.  Needs PyTorch with
CUDA, nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (phase 2's decode check)

TOL = 2e-2  # bf16, as chip_smoke.py holds the kernels
# (name, B, S, H, KH, D): NeMo's and DeepSeek-V2's prefill, the largest head dim, whisper's
FLASH_SHAPES = [("nemo", 2, 2048, 32, 8, 128), ("deepseek", 2, 1024, 128, 128, 192),
                ("d256", 2, 2048, 16, 16, 256), ("whisper", 2, 1024, 16, 16, 64)]
# (name, tokens, experts, top_k, d_in, d_out): Qwen3-MoE's and DeepSeek-V2's prefill
# (B = 2, S = 2048) and Qwen3's sorted decode (B = 2)
GMM_SHAPES = [("qwen3 2048->768", 4096, 128, 8, 2048, 768),
              ("qwen3 768->2048", 4096, 128, 8, 768, 2048),
              ("deepseek 5120->1536", 4096, 160, 6, 5120, 1536),
              ("deepseek 1536->5120", 4096, 160, 6, 1536, 5120),
              ("qwen3 decode 2048->768", 2, 128, 8, 2048, 768)]
# (name, B, H, KH, D, T): NeMo's and granite's serving and long caches, DeepSeek-V2's MLA
DECODE_SHAPES = [("nemo T=13", 2, 32, 8, 128, 13), ("granite T=13", 2, 48, 1, 128, 13),
                 ("nemo T=4096", 2, 32, 8, 128, 4096), ("granite T=4096", 2, 48, 1, 128, 4096),
                 ("nemo T=32768", 2, 32, 8, 128, 32768),
                 ("granite T=32768", 2, 48, 1, 128, 32768),
                 ("deepseek T=300", 2, 128, 128, 192, 300)]
# (name, B, S, H, KH, D, causal): the flash backward at phase 2e's training
# shapes: NeMo's, granite's MQA (split over CTAs), whisper's encoder
BWD_SHAPES = [("nemo", 2, 2048, 32, 8, 128, True), ("granite", 2, 2048, 48, 1, 128, True),
              ("whisper", 2, 1500, 16, 16, 64, False)]
# (name, B, T, H, P, N, L): mamba2-780m's prefill (B = 2) and a longer one
SSD_SHAPES = [("mamba2 T=2048", 2, 2048, 48, 64, 128, 128),
              ("mamba2 T=8192", 2, 8192, 48, 64, 128, 128)]
# one tensor-parallel rank at |model| = 16: (name, B, T, H, P, N, L) of its
# SSD heads, and (name, B, H, KH, D, T_loc) of its decode slice
SSD_RANK_SHAPES = [("mamba2 3 heads", 2, 2048, 3, 64, 128, 128),
                   ("zamba2 7 heads", 2, 2048, 7, 64, 64, 128)]
PARTIALS_SHAPES = [("nemo T_loc=2048", 2, 32, 8, 128, 2048),
                   ("granite T_loc=2048", 2, 48, 1, 128, 2048)]
# the kernels of the body each kernel is timed through, as ptxas names them
TIMED = {"flash_attention": ("wgmma",), "moe_gmm": ("wgmma",),
         "flash_attention_bwd": ("bwd_dkdv_wgmma", "bwd_dq_wgmma", "bwd_split_sum"),
         "decode_attention": ("decode_split", "decode_combine"),
         "ssd_scan": ("ssd_chunk", "ssd_state_pass"), "ssd_scan_fused": ("ssd_fused",),
         "ssd_scan_rank": ("ssd_chunk", "ssd_state_pass"), "decode_partials": ("decode_split",)}
# the source and the C entry of a kernel that are not ``<kernel>.cu`` and
# ``<kernel>_launch``
SOURCE = {"ssd_scan_fused": "ssd_scan", "ssd_scan_rank": "ssd_scan"}
ENTRY = {"decode_partials": "decode_partials_cluster_launch",
         "ssd_scan_rank": "ssd_scan_launch"}
# the C entry's integer arguments after its pointers
NINTS = {"flash_attention": 12, "moe_gmm": 6, "decode_attention": 9, "ssd_scan": 9,
         "flash_attention_bwd": 13, "ssd_scan_fused": 7, "ssd_scan_rank": 9,
         "decode_partials": 7}
NPTRS = {"flash_attention": 5, "moe_gmm": 4, "decode_attention": 8, "ssd_scan": 11,
         "flash_attention_bwd": 11, "ssd_scan_fused": 11, "ssd_scan_rank": 11,
         "decode_partials": 5}


def pdl_variant(base: str) -> str:
    """The chunked SSD body with its launches joined by programmatic
    dependent launch (see the module's note); ``ssd_common.cuh``, which
    holds (a), is pasted in so that (a) can let (b) start at once."""
    common = (ROOT / "src" / "repro_torch" / "csrc" / "ssd_common.cuh").read_text()
    common = _edit(common, "const int LP = round16(L), NP = round16(N), PP = round16(P);\n",
                   "asm volatile(\"griddepcontrol.launch_dependents;\");\n"
                   "  const int LP = round16(L), NP = round16(N), PP = round16(P);\n")
    text = _edit(base, '#include "ssd_common.cuh"', common)
    text = _edit(text, "  constexpr int BATCH = 8;\n",
                 "  asm volatile(\"griddepcontrol.launch_dependents;\");\n"
                 "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
                 "  constexpr int BATCH = 8;\n")
    start = text.index("  {\n    const size_t PN = (size_t)P * N;\n    const __nv_bfloat16* hi = s_in")
    end = text.index("// in flight under M and M X\n  }\n", start) + len(
        "// in flight under M and M X\n  }\n")
    load = text[start:end]
    text = text[:start] + text[end:]
    text = _edit(text, "  hopper::cp_async_wait<0>();\n  __syncthreads();  // S_in's parts are staged",
                 "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");  // (b) is done\n"
                 + load + "  hopper::cp_async_wait<0>();\n  __syncthreads();  // S_in's parts are staged")
    text = _edit(text, "// Shared memory (bytes) the chunked body's largest CTA takes.", """\
template <typename K, typename... A>
cudaError_t pdl_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t s, K kernel, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Shared memory (bytes) the chunked body's largest CTA takes.""")
    text = _edit(text, """  kernel<<<grid, threads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a, static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(s_in),
      static_cast<__nv_bfloat16*>(y), Tn, H, P, N, L);
  return cudaGetLastError();""", """  e = pdl_launch(grid, dim3(threads), smem, s, kernel,
      static_cast<const __nv_bfloat16*>(x), dt, a, static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(s_in),
      static_cast<__nv_bfloat16*>(y), Tn, H, P, N, L);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();""")
    return _edit(text, """  ssd_state_pass_kernel<<<dim3((PN + 255) / 256, B * H), 256, 0, s>>>(
      states, decays, init, dtype == 1 ? s_in : states, dtype == 1, keep, fs, nc, H, PN);
  e = cudaGetLastError();""", """  e = pdl_launch(dim3((PN + 255) / 256, B * H), dim3(256), 0, s, ssd_state_pass_kernel,
      states, decays, init, dtype == 1 ? s_in : states, (int)(dtype == 1), keep, fs, nc, H, PN);
  if (e == cudaSuccess) e = cudaGetLastError();""")


def _edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        sys.exit(f"kernel_variants: {old[:60]!r} must occur exactly once")
    return text.replace(old, new)


def build(kernel: str, name: str, text: str) -> tuple:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{kernel}-{name}.cu"
    src.write_text(text)
    lib = out / f"{kernel}-{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"{name}: nvcc failed, dropped:\n{proc.stderr[-3000:]}")
        return name, None, []
    notes, entry = [], ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "entry function" in line:
            entry = line
        if any(k in entry for k in TIMED[kernel]) and ("C75" in line or "spill stores" in line
                                                        or "Used" in line):
            notes.append(line.strip()[:120])
    return name, lib, notes


def median_ms(fn, flush, reps=20):
    import torch

    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def cases(kernel: str, gen, opts):
    """(shape name, inputs, plain output, launch(fn, out)) for each shape."""
    import torch

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if kernel == "ssd_scan_fused":
        from repro_torch.kernels import ssd_scan as ssd

        for name, b, t, h, p, n, chunk in SSD_RANK_SHAPES:
            x = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev))
            a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
            bb, cc = ((torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5)
                      .to(torch.bfloat16) for _ in range(2))
            want = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk)[0].float()
            nc, split = -(-t // chunk), opts.split or 1
            scratch = [torch.empty(s, dtype=torch.float32, device=dev)
                       for s in ((b, h, p, n), (b, nc, h, p, n), (b, nc, h))]

            def launch(fn, out, x=x, dt=dt, a=a, bb=bb, cc=cc, scratch=scratch, chunk=chunk,
                       split=split):
                bs, t, h, p = x.shape
                return fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bb.data_ptr(),
                          cc.data_ptr(), None, out.data_ptr(), *(z.data_ptr() for z in scratch),
                          None, bs, t, h, p, bb.shape[3], chunk, split, stream())
            yield f"{name} split={split}", torch.empty_like(x), want, launch
    elif kernel == "ssd_scan_rank":
        from repro_torch.kernels import ssd_scan as ssd

        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for name, b, t, h, p, n, chunk in SSD_RANK_SHAPES:
            x = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev))
            a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
            bb, cc = ((torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5)
                      .to(torch.bfloat16) for _ in range(2))
            want = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk)[0].float()
            nc = -(-t // chunk)
            split = ssd.fused_split(p, b * h * nc, sms, {
                2: ssd.fused_blocks_per_sm(dev, chunk, p, n, 2)})
            scratch = [torch.empty(s, dtype=torch.float32, device=dev)
                       for s in ((b, h, p, n), (b, nc, h, p, n), (b, nc, h))]
            pairs = torch.empty((b, nc, h, 2, p, n), dtype=torch.bfloat16, device=dev)

            def launch(fn, out, x=x, dt=dt, a=a, bb=bb, cc=cc, scratch=scratch, pairs=pairs,
                       chunk=chunk, split=split):
                bs, t, h, p = x.shape
                ptrs = [z.data_ptr() for z in (x, dt, a, bb, cc)]
                if fn.__name__ == "ssd_scan_fused_launch":  # the fused body, as ssd_scan runs it
                    return fn(*ptrs, None, out.data_ptr(), *(z.data_ptr() for z in scratch),
                              None, bs, t, h, p, bb.shape[3], chunk, split, stream())
                return fn(*ptrs, None, out.data_ptr(), *(z.data_ptr() for z in scratch),
                          pairs.data_ptr(), bs, t, h, p, bb.shape[3], chunk, 1,
                          ssd.BODIES["chunked"], 0, stream())
            yield f"{name} (fused split={split})", torch.empty_like(x), want, launch
    elif kernel == "decode_partials":
        from repro_torch.kernels import decode_attention as da

        for name, b, h, kh, d, t in PARTIALS_SHAPES:
            q = torch.randn(b, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
            k, v = (torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=torch.bfloat16)
                    for _ in range(2))
            n = torch.full((b,), t, dtype=torch.int32, device=dev)
            want = da.decode_attention_plain(q, k, v, n).float()
            splits = opts.cluster or da.cluster_splits(
                b, kh, t, da.sm_count(dev), da.cluster_fits(dev, h // kh, d))
            rec = torch.empty((b, h, d + 4), dtype=torch.float32, device=dev)

            class Out:  # the record, read as the output it stands for
                def float(self, rec=rec, d=d):
                    return rec[..., :d] / rec[..., d + 1:d + 2]

            def launch(fn, out, q=q, k=k, v=v, n=n, splits=splits, rec=rec, t=t, kh=kh):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(), rec.data_ptr(),
                          q.shape[0], q.shape[1], kh, t, q.shape[2], splits,
                          da.slots_per_split(t, splits), stream())
            yield f"{name} cluster of {splits}", Out(), want, launch
    elif kernel == "flash_attention":
        from repro_torch.kernels import flash_attention as fa

        for name, b, s, h, kh, d in FLASH_SHAPES:
            q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev, dtype=torch.bfloat16)
                       for n in (h, kh, kh))
            want = fa.flash_attention_plain(q, k, v).float()

            def launch(fn, out, q=q, k=k, v=v):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                          q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                          1, 0, 0, 0, 1, fa.BODIES["wgmma"], stream())
            yield name, torch.empty_like(q), want, launch
    elif kernel == "decode_attention":
        from repro_torch.kernels import decode_attention as da

        for name, b, h, kh, d, t in DECODE_SHAPES:
            q = torch.randn(b, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
            k, v = (torch.randn(b, t, kh, d, generator=gen, device=dev, dtype=torch.bfloat16)
                    for _ in range(2))
            n = torch.full((b,), t, dtype=torch.int32, device=dev)
            want = da.decode_attention_plain(q, k, v, n).float()
            splits = da.splits_for(b, kh, t, da.sm_count(dev))
            parts = [torch.empty((b, h, splits) + e, dtype=torch.float32, device=dev)
                     for e in ((), (), (d,))]

            def launch(fn, out, q=q, k=k, v=v, n=n, splits=splits, parts=parts, t=t, kh=kh):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(), out.data_ptr(),
                          *(p.data_ptr() for p in parts), q.shape[0], q.shape[1], kh, t,
                          q.shape[2], 1, da.BODIES["split"], splits,
                          da.slots_per_split(t, splits), stream())
            yield f"{name} splits={splits}", torch.empty_like(q), want, launch
    elif kernel == "flash_attention_bwd":
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_attention_bwd as fb

        sms = fb.sm_count(dev)
        for name, b, s, h, kh, d, causal in BWD_SHAPES:
            q, k, v, do = (torch.randn(b, s, n, d, generator=gen, device=dev, dtype=torch.bfloat16)
                           for n in (h, kh, kh, h))
            out, lse = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
            out = out.contiguous()  # the kernel reads o as (B, S, H, D)
            want = [x.float() for x in
                    fb.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)]
            splits = fb.splits_for(b, s, kh, h // kh, sms)
            delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
            part = torch.empty((2, splits) + tuple(k.shape), dtype=torch.float32, device=dev)
            grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))

            def launch(fn, grads, q=q, k=k, v=v, out=out, do=do, lse=lse, delta=delta,
                       part=part, splits=splits, causal=causal):
                b, s, h, d = q.shape
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                          lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in grads),
                          part.data_ptr(), b, s, s, h, k.shape[2], d, int(causal), 0, 0, 0, 1,
                          fb.BODIES["wgmma"], splits, stream())
            yield f"{name} splits={splits}", grads, want, launch
    elif kernel == "ssd_scan":
        from repro_torch.kernels import ssd_scan as ssd

        for name, b, t, h, p, n, chunk in SSD_SHAPES:
            x = (torch.randn(b, t, h, p, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev))
            a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
            bb, cc = ((torch.randn(b, t, h, n, generator=gen, device=dev) * 0.5)
                      .to(torch.bfloat16) for _ in range(2))
            want = ssd.ssd_scan_plain(x, dt, a, bb, cc, chunk=chunk)[0].float()
            nc = -(-t // chunk)
            scratch = [torch.empty(s, dtype=torch.float32, device=dev)
                       for s in ((b, h, p, n), (b, nc, h, p, n), (b, nc, h))]
            scratch.append(torch.empty((b, nc, h, 2, p, n), dtype=torch.bfloat16, device=dev))

            def launch(fn, out, x=x, dt=dt, a=a, bb=bb, cc=cc, scratch=scratch, chunk=chunk):
                bs, t, h, p = x.shape
                return fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bb.data_ptr(),
                          cc.data_ptr(), None, out.data_ptr(), *(z.data_ptr() for z in scratch),
                          bs, t, h, p, bb.shape[3], chunk, 1, ssd.BODIES["chunked"], 0,
                          stream())
            yield name, torch.empty_like(x), want, launch
    else:
        from repro_torch.kernels import moe_gmm as gmm

        for name, tokens, e, top_k, d_in, d_out in GMM_SHAPES:
            idx = torch.randint(0, e, (tokens * top_k,), generator=gen, device=dev)
            sizes = torch.bincount(idx, minlength=e).to(torch.int32)
            t = tokens * top_k
            x = torch.randn(t, d_in, generator=gen, device=dev, dtype=torch.bfloat16)
            w = (torch.randn(e, d_in, d_out, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
            want = gmm.moe_gmm_plain(x, w, sizes).float()

            def launch(fn, out, x=x, w=w, sizes=sizes):
                return fn(x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
                          x.shape[0], w.shape[0], w.shape[1], w.shape[2], 1,
                          gmm.BODIES["wgmma"], stream())
            yield name, x.new_empty((t, d_out)), want, launch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(TIMED))
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=OLD=>NEW")
    ap.add_argument("--ctas-per-sm", type=int, default=None,
                    help="CTAs an SM decode attention's split count aims for")
    ap.add_argument("--split", type=int, default=None, help="ssd_scan_fused: CTAs a chunk")
    ap.add_argument("--pdl", action="store_true",
                    help="ssd_scan_rank: add the variant 'pdl' (programmatic dependent launch)")
    ap.add_argument("--cluster", type=int, default=None,
                    help="decode_partials: CTAs a cluster")
    ap.add_argument("--unchecked", action="store_true",
                    help="time without holding each variant to the plain version")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    if args.ctas_per_sm is not None:
        da.CTAS_PER_SM = args.ctas_per_sm
    base = (_build.CSRC / f"{SOURCE.get(args.kernel, args.kernel)}.cu").read_text()
    texts = {"base": base}
    for spec in args.variant:
        name, _, rules = spec.partition("=")
        text = base
        for rule in rules.split("&&"):
            old, sep, new = rule.partition("=>")
            if not sep or base.count(old) != 1:
                sys.exit(f"kernel_variants: {spec!r}: each text to replace must occur exactly "
                         f"once")
            text = text.replace(old, new)
        texts[name] = text
    if args.pdl:
        texts["pdl"] = pdl_variant(base)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda kv: build(args.kernel, *kv), texts.items()))
    entries = {}
    for name, lib, notes in built:
        if lib is None:
            texts.pop(name)
            continue
        print(f"{name}: built; ptxas on the timed body's kernels: "
              f"{notes or 'no warning, no spill'}")
        fn = getattr(ctypes.CDLL(str(lib)), ENTRY.get(args.kernel, f"{args.kernel}_launch"))
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * NPTRS[args.kernel] + [ctypes.c_int] * NINTS[args.kernel]
                       + [ctypes.c_void_p])
        entries[name] = fn
        if args.kernel == "ssd_scan_rank" and name == "base":  # the fused body, in turns
            fused = ctypes.CDLL(str(lib)).ssd_scan_fused_launch
            fused.restype = ctypes.c_int
            fused.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            entries["fused"] = fused
    if "fused" in entries:
        texts["fused"] = base
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(texts)
    order = names + names[::-1]
    refused = {}  # variant -> the cudaError of a launch the card refused
    for shape, out, want, launch in cases(args.kernel, gen, args):
        times = {n: [] for n in names}
        for n in order:
            if n in refused:
                continue
            rc = launch(entries[n], out)
            if rc != 0:  # e.g. more registers than 384 threads may hold
                refused[n] = rc
                print(f"{n}: launch refused, cudaError {rc}")
                continue
            torch.cuda.synchronize()
            if args.kernel == "flash_attention_bwd":  # phase 2e's check of dq, dk, dv
                checks = [chip_smoke.grad_close(x, w, "bfloat16") for x, w in zip(out, want)]
                ok, err = all(c[0] for c in checks), max(c[1] for c in checks)
            else:
                err = float((out.float() - want).abs().max())
            if args.kernel.startswith("decode_attention"):  # phase 2's check, scaled
                ok = chip_smoke.decode_close(out.float(), want, "bfloat16")
            elif args.kernel != "flash_attention_bwd":
                ok = torch.allclose(out.float(), want, atol=TOL, rtol=TOL)
            if not ok and not args.unchecked:
                raise AssertionError(f"{n} at {shape}: max err {err} outside {TOL}")
            times[n].append(median_ms(lambda: launch(entries[n], out), flush) * 1e3)
        print(f"{shape}: " + ", ".join(f"{n} {' / '.join(f'{t:.1f}' for t in ts)} us"
                                       for n, ts in times.items() if ts), flush=True)


if __name__ == "__main__":
    main()
