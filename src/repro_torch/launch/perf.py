"""§Perf hillclimb, mirroring ``repro.launch.perf``: count the three
selected (arch × shape) pairs again with each candidate optimization and
record hypothesis → change → before → after against the baselines in
results/dryrun/.

Pairs (the reference's selection, EXPERIMENTS.md §Perf):
  P1 deepseek-v2-236b × prefill_32k — most collective-bound
  P2 llama3-405b × decode_32k       — most representative of the paper's
                                      serving/model-residency concern
  P3 granite-20b × prefill_32k      — worst memory-bound roofline fraction

Each step runs through the port's ``run_case`` (its step factories on a
fake 16×16 mesh, counted on H100 denominators).  A step whose option the
port's step factory cannot take raises, saying why; none is skipped.

    PYTHONPATH=src python -m repro_torch.launch.perf [--step NAME]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_case
from repro_torch.launch.roofline import analyze

# (tag, arch, shape, kwargs) — each entry is one hypothesis→change cycle.
STEPS = [
    # P1 iteration 1: EP MoE dispatch.
    ("p1_deepseek_prefill_ep", "deepseek-v2-236b", "prefill_32k",
     dict(moe_dispatch="ep")),
    # P1 iteration 2: + chunked attention (memory term).
    ("p1_deepseek_prefill_ep_chunked", "deepseek-v2-236b", "prefill_32k",
     dict(moe_dispatch="ep", attn_impl="ref_chunked")),
    # P2 iteration 1: scatter-free cache update.
    ("p2_llama3_decode_onehot", "llama3-405b", "decode_32k",
     dict(cache_update="onehot")),
    # P2 iteration 2: weight-stationary serving layout.
    ("p2_llama3_decode_servelayout", "llama3-405b", "decode_32k",
     dict(cache_update="onehot", serve_layout=True)),
    # P2 iteration 3: grouped-GQA decode einsum (no head expansion).
    ("p2_llama3_decode_grouped", "llama3-405b", "decode_32k",
     dict(cache_update="onehot", attn_impl="ref_grouped")),
    # P3 iteration 1: chunked (flash-style) attention.
    ("p3_granite_prefill_chunked", "granite-20b", "prefill_32k",
     dict(attn_impl="ref_chunked")),
]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", default=None)
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for tag, arch, shape, kw in STEPS:
        if args.step and args.step != tag:
            continue
        rec = run_case(arch, shape, multi_pod=False, **kw)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        a = analyze(rec)
        print(
            f"[{tag}] compute={a['compute_s']:.3e}s memory={a['memory_s']:.3e}s "
            f"collective={a['collective_s']:.3e}s dominant={a['dominant']} "
            f"useful={a['useful_ratio']*100:.1f}%",
            flush=True,
        )


if __name__ == "__main__":
    main()
