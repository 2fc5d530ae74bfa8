#!/usr/bin/env python3
"""Time variants of one of the port's kernel bodies against the source as
it stands, on one card.

    python3 tools/kernel_variants.py flash_attention \\
        --variant "bkv128=BKV = D <= 64 ? 128 : 64=>BKV = D <= 128 ? 128 : 64"
    python3 tools/kernel_variants.py moe_gmm \\
        --variant "bn256=BN = 128;            // columns=>BN = 256;            // columns"
    python3 tools/kernel_variants.py decode_attention --target-ctas 528 \\
        --variant "st2=DP > 192 ? 2 : 3=>2"
    python3 tools/kernel_variants.py ssd_scan --variant "w8=STATE_THREADS = 128=>STATE_THREADS = 256"
    python3 tools/kernel_variants.py flash_attention_bwd --variant "one_wg=KV_WGS = 2;=>KV_WGS = 1;"

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
``--target-ctas`` sets the CTAs decode attention's split count aims for
(``decode_attention.TARGET_CTAS``), for every variant alike.  A variant
that does not build, or whose launch the card refuses, is reported and
dropped.  Needs PyTorch with
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
# the kernels of the body each kernel is timed through, as ptxas names them
TIMED = {"flash_attention": ("wgmma",), "moe_gmm": ("wgmma",),
         "flash_attention_bwd": ("bwd_dkdv_wgmma", "bwd_dq_wgmma", "bwd_split_sum"),
         "decode_attention": ("decode_split", "decode_combine"),
         "ssd_scan": ("ssd_chunk", "ssd_state_pass")}
# the C entry's integer arguments after its pointers
NINTS = {"flash_attention": 12, "moe_gmm": 6, "decode_attention": 9, "ssd_scan": 8,
         "flash_attention_bwd": 13}
NPTRS = {"flash_attention": 5, "moe_gmm": 4, "decode_attention": 8, "ssd_scan": 11,
         "flash_attention_bwd": 11}


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


def cases(kernel: str, gen):
    """(shape name, inputs, plain output, launch(fn, out)) for each shape."""
    import torch

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if kernel == "flash_attention":
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
            splits = da.splits_for(b, kh, t)
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
                          bs, t, h, p, bb.shape[3], chunk, 1, ssd.BODIES["chunked"], stream())
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
    ap.add_argument("--target-ctas", type=int, default=None,
                    help="CTAs decode attention's split count aims for")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    if args.target_ctas is not None:
        da.TARGET_CTAS = args.target_ctas
    base = (_build.CSRC / f"{args.kernel}.cu").read_text()
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
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda kv: build(args.kernel, *kv), texts.items()))
    entries = {}
    for name, lib, notes in built:
        if lib is None:
            texts.pop(name)
            continue
        print(f"{name}: built; ptxas on the timed body's kernels: "
              f"{notes or 'no warning, no spill'}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{args.kernel}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * NPTRS[args.kernel] + [ctypes.c_int] * NINTS[args.kernel]
                       + [ctypes.c_void_p])
        entries[name] = fn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(texts)
    order = names + names[::-1]
    refused = {}  # variant -> the cudaError of a launch the card refused
    for shape, out, want, launch in cases(args.kernel, gen):
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
            if args.kernel == "decode_attention":  # phase 2's check, scaled to the output
                ok = chip_smoke.decode_close(out.float(), want, "bfloat16")
            elif args.kernel != "flash_attention_bwd":
                ok = torch.allclose(out.float(), want, atol=TOL, rtol=TOL)
            if not ok:
                raise AssertionError(f"{n} at {shape}: max err {err} outside {TOL}")
            times[n].append(median_ms(lambda: launch(entries[n], out), flush) * 1e3)
        print(f"{shape}: " + ", ".join(f"{n} {' / '.join(f'{t:.1f}' for t in ts)} us"
                                       for n, ts in times.items() if ts), flush=True)


if __name__ == "__main__":
    main()
