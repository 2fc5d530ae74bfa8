#!/usr/bin/env python3
"""Time the flash backward's wgmma body at each number of shares of a KV
head's group (``splits``) against the others, on one card.

    python3 tools/bwd_splits.py

At phase 2e's shapes where the split matters (granite's MQA: 48 query
heads on one KV head; NeMo's G = 4), every split count that divides the
group is timed in turns (the counts in order, then reversed), each time
the median of 10 calls between CUDA events with the L2 cache flushed
before each call, after checking the gradients against the plain
backward by ``chip_smoke.py``'s phase-2e check.  It prints the card,
each count's two readings in ms and the count that
``flash_attention_bwd.splits_for`` picks on this card, which is what the
readings are meant to support.  Needs PyTorch with CUDA, nvcc and a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (phase 2e's check and timing)

# (name, B, S, H, KH, D, causal, split counts)
SHAPES = [("granite", 2, 2048, 48, 1, 128, True, (4, 6, 8, 12, 16, 24)),
          ("nemo", 2, 2048, 32, 8, 128, True, (1, 2, 4))]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("bwd_splits: no CUDA device")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    for name, b, s, h, kh, d, causal, counts in SHAPES:
        q, k, v, do = (torch.randn(b, s, n, d, generator=gen, device=dev, dtype=torch.bfloat16)
                       for n in (h, kh, kh, h))
        out, lse = fa._launch(q, k, v, causal, None, 0, None, True)
        want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)
        times = {n: [] for n in counts}
        for n in list(counts) + list(counts)[::-1]:
            def call(n=n):
                return fb.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, body="wgmma",
                                              splits=n)
            if not times[n]:
                for part, x, w in zip(("dq", "dk", "dv"), call(), want):
                    ok, err, _ = chip_smoke.grad_close(x, w, "bfloat16")
                    if not ok:
                        raise AssertionError(f"{name} splits={n} {part}: max err {err}")
            times[n].append(chip_smoke.cuda_time_ms(call, flush, reps=10))
        pick = fb.splits_for(b, s, kh, h // kh, fb.sm_count(dev))
        print(f"{name} B={b} S={s} H={h} KH={kh} D={d}: splits_for picks {pick}; ms "
              + ", ".join(f"{n}: {' / '.join(f'{t:.4f}' for t in ts)}" for n, ts in times.items()),
              flush=True)


if __name__ == "__main__":
    main()
