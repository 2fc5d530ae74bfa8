"""Train a small dense LM on the synthetic pipeline: the port's
counterpart of ``examples/train_small.py``, with its flags and output
lines.  It runs the whole training substrate: data pipeline →
``make_train_step`` (the flash kernels and the backward kernel on a card)
→ AdamW → a checkpoint, saved and restored.

The default config is small (1.1M params); on the CPU 200 steps take
half a minute.  The loss should drop well below ln(vocab) as the model
learns the synthetic repetition structure.

    PYTHONPATH=src python -m repro_torch.examples.train_small --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_small --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.data import DataConfig, make_pipeline
from repro_torch.models import ModelConfig, init_params
from repro_torch.training import checkpoint, make_train_step, optimizer as opt

#: Where the checkpoint goes unless ``--ckpt`` says otherwise (the
#: checkout's build directory, which git ignores).
DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "ckpt" / "train_small"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="tiny-dense",
        arch_type="dense",
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=4,
        n_kv_heads=2,
        d_ff=args.d_model * 4,
        vocab=args.vocab,
        dtype="float32",
    )
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    params = init_params(cfg, torch.Generator(device=args.device).manual_seed(0), args.device)
    state = opt.init(params)
    step = make_train_step(cfg, ocfg, remat=False, device=args.device)

    data = make_pipeline(DataConfig(vocab=args.vocab, seq_len=args.seq, global_batch=args.batch))
    t0 = time.time()
    first = last = None
    for i in range(args.steps):
        params, state, metrics = step(params, state, next(data))
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
        if i % 25 == 0 or i == args.steps - 1:
            print(
                f"step {i:4d}  loss {loss:6.3f}  "
                f"gnorm {float(metrics['grad_norm']):6.2f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"({(time.time()-t0)/(i+1):.2f}s/step)"
            )
    print(f"\nloss {first:.3f} → {last:.3f} (ln V = {math.log(args.vocab):.3f})")

    checkpoint.save(args.ckpt, {"params": params, "opt": state},
                    metadata={"steps": args.steps, "loss": last})
    restored, meta = checkpoint.restore(args.ckpt, {"params": params, "opt": state})
    print(f"checkpoint round-trip OK (saved at step {meta['steps']})")


if __name__ == "__main__":
    main()
