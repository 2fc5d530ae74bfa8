#!/usr/bin/env python3
"""Show that chip_smoke.py's phase 2 catches a fault in the split body of
decode attention, on one card.

    python3 tools/plant_faults.py [--out DIR]

It builds copies of ``src/repro_torch/csrc/decode_attention.cu`` with one
fault planted in each:

* ``skip_split_1``: the second range of cache slots is taken as empty
  (m = -inf, l = 0), so its slots leave the numerator and the denominator
  alike and the output stays a normalised average;
* ``skip_last_split``: the same for the last range;
* ``no_rescale``: the combine sums the ranges without rescaling each one
  to the largest m.

Each copy and the unchanged source ("base") are built with the port's
nvcc flags in a temporary directory, so the checkout is not written. Each
is loaded in place of the decode-attention library and run over phase 2's
inputs (``chip_smoke.decode_inputs``, the same seed) and length cases,
through the body the wrapper picks. Each case is judged by phase 2's check
(``chip_smoke.decode_close``) and, beside it, by the unscaled tolerance
(``allclose`` at ``TOL``). It prints a table of the cases each check
fails and exits non-zero unless base passes every case and every fault
fails phase 2's check in each shape with T >= 4096, in both dtypes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (name, text in the source, what replaces it); each text occurs once
FAULTS = [
    ("skip_split_1", "r.hi = min(r.lo + per_split, len);",
     "r.hi = blockIdx.x == 1 ? r.lo : min(r.lo + per_split, len);"),
    ("skip_last_split", "r.hi = min(r.lo + per_split, len);",
     "r.hi = gridDim.x > 1 && blockIdx.x == gridDim.x - 1 ? r.lo : min(r.lo + per_split, len);"),
    ("no_rescale", "const float w = M == -INFINITY ? 0.f : exp2f(pm[s] - M);",
     "const float w = M == -INFINITY ? 0.f : 1.f;"),
]
LONG = 4096  # every fault must fail phase 2's check at each shape from this T on


def build(name: str, text: str, where: Path) -> Path:
    from repro_torch.kernels import _build

    src = where / f"decode_attention-{name}.cu"
    src.write_text(text)
    lib = where / f"decode_attention-{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    return lib


def judge(lib: Path) -> list:
    """Phase 2's cases through ``lib``: one record per (shape, dtype) with
    the cases each check fails."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    _build._libs["decode_attention"] = ctypes.CDLL(str(lib))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)  # phase 2's seed
    out = []
    for model, b, h, kh, d, t, dtype, q, k, v, ragged in cs.decode_inputs(gen, dev):
        rec = dict(model=model, t=t, dtype=dtype, splits=da.splits_for(b, kh, t),
                   body=da.body_for(getattr(torch, dtype), d, h // kh, da.splits_for(b, kh, t)),
                   fails=[], fails_unscaled=[], max_abs_err=0.0, max_abs_want=0.0)
        for case, lens in cs.decode_lengths(t, ragged):
            n = torch.tensor(lens[:b], dtype=torch.int32, device=dev)
            got = da.decode_attention(q, k, v, n).float()
            want = da.decode_attention_plain(q, k, v, n).float()
            rec["max_abs_err"] = max(rec["max_abs_err"], float((got - want).abs().max()))
            rec["max_abs_want"] = max(rec["max_abs_want"], float(want.abs().max()))
            if not cs.decode_close(got, want, dtype):
                rec["fails"].append(case)
            tol = cs.TOL[dtype]
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                rec["fails_unscaled"].append(case)
        out.append(rec)
        del q, k, v
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="directory for the JSON record")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("plant_faults: no CUDA device")
    from repro_torch.kernels import _build

    base = (_build.CSRC / "decode_attention.cu").read_text()
    texts = {"base": base}
    for name, old, new in FAULTS:
        if base.count(old) != 1:
            sys.exit(f"plant_faults: {name}: the text to replace must occur exactly once")
        texts[name] = base.replace(old, new)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    results, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(texts)) as pool:
            libs = dict(zip(texts, pool.map(lambda kv: build(*kv, Path(tmp)), texts.items())))
        for name, lib in libs.items():
            results[name] = recs = judge(lib)
            print(f"== {name}")
            for r in recs:
                print(f"  {r['model']:18s} {r['dtype']:8s} T={r['t']:5d} {r['body']:6s} "
                      f"splits={r['splits']:3d} max err {r['max_abs_err']:.3e} "
                      f"(max |want| {r['max_abs_want']:.3e}); phase 2 fails {r['fails']}, "
                      f"unscaled check fails {r['fails_unscaled']}", flush=True)
            if name == "base":
                bad += [f"base fails {r['model']} {r['dtype']} T={r['t']}" for r in recs
                        if r["fails"]]
            else:
                bad += [f"{name} passes {r['model']} {r['dtype']} T={r['t']}" for r in recs
                        if r["t"] >= LONG and not r["fails"]]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "plant_faults.json").write_text(json.dumps(results, indent=1))
    if bad:
        sys.exit("plant_faults: " + "; ".join(bad))
    print("plant_faults: base passes every case; every fault fails phase 2's check at every "
          f"shape with T >= {LONG}")


if __name__ == "__main__":
    main()
