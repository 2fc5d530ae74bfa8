#!/usr/bin/env python3
"""How often the port's bf16 paths pick the same next token, position by
position, on one card, and what a planted fault in an attention kernel
reads there.

    python3 tools/logit_agreement.py [--out DIR] [MODEL ...]
    python3 tools/logit_agreement.py --plant [--out DIR]

For each zoo model (default: zamba2-7b, whisper-medium, mamba2-780m and
mistral-nemo-12b, at full width and depth, weights from ``chip_smoke.py``'s
seed) it runs one prefill at B = 2 (S = 2048; whisper: its 448-token text
context over 1,500 stub frames) on the kernel path (``auto``), on the two
plain paths (``ref_chunked``, all fp32 inside attention, and ``ref``, which
rounds as the JAX oracle does) and, where ``--fp32`` names the model, on an
fp32 evaluation of the same weights (the bf16 weights cast up, the plain
path in fp32).  It prints, for each pair, the share of the B·S positions
whose argmax agrees (``chip_smoke.argmax_share``: an exact tie counts as
agreement), the largest |difference| over all positions and at the last
one against the largest logit there, the median gap between the top two
logits, and each row's agreement and top two logits at the last position.
Over random bf16 weights the paths differ by a few bf16 ulps at every
layer, and 40-80 layers amplify that past the gap between the top two
tokens at many positions.

``--plant`` takes phases 3e-3g of ``chip_smoke.py`` (zamba2-7b,
whisper-medium, qwen2-vl-72b at 32 layers) on their own inputs and reads
the same numbers for the sound kernel path and for the kernel path with a
fault planted in one wrapper (``planted``): the prefill against
``ref_chunked`` with flash attention at fault, and the checked decode
steps against ``ref_grouped`` with decode attention at fault.  The smoke's
``ARGMAX_SHARE`` has to lie between the two.  Needs PyTorch with CUDA,
nvcc and a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (model loading, argmax_share)

MODELS = ("zamba2-7b", "whisper-medium", "mamba2-780m", "mistral-nemo-12b")


def batch_for(cfg, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(8)
    s = chip_smoke.WHISPER_S if cfg.arch_type == "audio" else chip_smoke.PREFILL_S
    batch = {"tokens": torch.randint(0, cfg.vocab, (chip_smoke.PREFILL_B, s), generator=gen,
                                     device=dev)}
    if cfg.arch_type == "audio":
        batch["audio_frames"] = (torch.randn(chip_smoke.PREFILL_B, cfg.n_audio_frames, cfg.d_model,
                                             generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    return batch


def fp32_tree(module):
    """The params as a nested dict, bf16 leaves cast to fp32."""
    out = {k: (v.detach().float() if v.is_floating_point() else v.detach())
           for k, v in module._parameters.items()}
    out.update({k: fp32_tree(m) for k, m in module._modules.items()})
    return out


def pair(x, y, last=lambda t: t[:, -1]):
    """x against y (..., V); ``last`` picks the last position's (or decode
    step's) rows (B, V)."""
    import torch

    top = y.float().topk(2, dim=-1).values
    xl, yl = last(x), last(y)
    return dict(max_abs_diff=float((x.float() - y.float()).abs().max()),
                last_ratio=float((xl.float() - yl.float()).abs().max() / yl.float().abs().max()),
                median_top2_gap=float(torch.median(top[..., 0] - top[..., 1])),
                **chip_smoke.argmax_agreement(x, y, xl, yl))


def show(what, row, rows):
    print(f"{what}: argmax equal at {row['argmax_share']:.4f} of {rows} rows; max |diff| "
          f"{row['max_abs_diff']:.4f}; last ratio {row['last_ratio']:.4f}; median top-2 gap "
          f"{row['median_top2_gap']:.4f}; last rows agree {row['last_agrees']}, top two "
          f"{row['last_top2'][0]} against {row['last_top2'][1]}", flush=True)


def agreement(name, fp32):
    import torch
    from repro_torch.models import ParamTree
    from repro_torch.training import make_prefill_step

    dev = torch.device("cuda")
    cfg, params, _ = chip_smoke.load_full_width(name)
    batch = batch_for(cfg, dev)
    logits = {impl: make_prefill_step(cfg, impl=impl, device=dev)(params, batch).float()
              for impl in ("auto", "ref_chunked", "ref")}
    pairs = [("auto", "ref_chunked"), ("ref", "ref_chunked")]
    if fp32:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
        params32 = ParamTree(fp32_tree(params))
        del params
        logits["fp32"] = make_prefill_step(cfg32, impl="ref_chunked", device=dev)(params32, batch32)
        del params32
        pairs += [("auto", "fp32"), ("ref_chunked", "fp32"), ("ref", "fp32")]
    out = {}
    for a, b in pairs:
        out[f"{a}|{b}"] = row = pair(logits[a], logits[b])
        show(f"{name} {a} vs {b}", row, logits[a].shape[0] * logits[a].shape[1])
    return out


@contextlib.contextmanager
def planted(kernel):
    """A fault in the kernel path's ``kernel`` wrapper while active: each
    causal flash call misses its own key (q_offset - 1), each bidirectional
    one its last 64-key tile, whole or partial (its last key where it has
    one tile); each decode call its last valid slot (cache_len - 1)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    mod = fa if kernel == "flash_attention" else da
    real = getattr(mod, kernel)

    def flash(q, k, v, *, causal=True, window=None, q_offset=0, **kw):
        if causal:
            return real(q, k, v, causal=True, window=window, q_offset=q_offset - 1, **kw)
        t = (k.shape[1] - 1) // 64 * 64 or k.shape[1] - 1
        return real(q, k[:, :t].contiguous(), v[:, :t].contiguous(), causal=False,
                    window=window, q_offset=q_offset, **kw)

    def decode(q, k, v, cache_len, **kw):
        return real(q, k, v, (cache_len - 1).clamp(min=0), **kw)

    setattr(mod, kernel, flash if kernel == "flash_attention" else decode)
    try:
        yield
    finally:
        setattr(mod, kernel, real)


PLANT = {"zamba2-7b": (chip_smoke.zamba2_inputs, None),
         "whisper-medium": (chip_smoke.whisper_inputs, None),
         "qwen2-vl-72b": (chip_smoke.qwen2_vl_inputs, chip_smoke.QWEN2_VL_LAYERS)}


def plant(name):
    """The sound and the faulty kernel path of ``name``'s phase against its
    plain path: the first prefill batch (flash attention at fault) and the
    checked decode steps (decode attention at fault)."""
    import torch
    from repro_torch.training import make_prefill_step

    dev = torch.device("cuda")
    inputs, layers = PLANT[name]
    cfg, params, _ = chip_smoke.load_full_width(name, layers, layers and chip_smoke.QWEN2_VL_CUT)
    prefill, decode = inputs(cfg, params, dev)
    what, batch = next(iter(prefill.items()))
    rows = batch["tokens"].numel()
    plain = make_prefill_step(cfg, impl="ref_chunked", device=dev)(params, batch)
    step = make_prefill_step(cfg, device=dev)
    out = {"prefill": pair(step(params, batch), plain)}
    with planted("flash_attention"):
        out["prefill_flash_fault"] = pair(step(params, batch), plain)
    del plain
    show(f"{name} prefill {what}, sound kernel path", out["prefill"], rows)
    show(f"{name} prefill {what}, flash attention at fault", out["prefill_flash_fault"], rows)
    d = decode()
    args = (cfg, params, d["cache"], d["tokens"], d["start"])
    plain = chip_smoke.decode_logits(*args, "ref_grouped")[0]
    last = lambda t: t[-1]  # noqa: E731  (the last step's rows)
    out["decode"] = pair(chip_smoke.decode_logits(*args, "auto")[0], plain, last)
    with planted("decode_attention"):
        out["decode_fault"] = pair(chip_smoke.decode_logits(*args, "auto")[0], plain, last)
    rows = d["tokens"].numel()
    show(f"{name} decode from pos {d['start']}, sound kernel path", out["decode"], rows)
    show(f"{name} decode from pos {d['start']}, decode attention at fault", out["decode_fault"],
         rows)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=list(MODELS))
    ap.add_argument("--fp32", nargs="*", default=["zamba2-7b", "whisper-medium", "mamba2-780m"],
                    help="models also evaluated in fp32 (their weights cast up must fit)")
    ap.add_argument("--plant", action="store_true",
                    help="the sound and faulty kernel paths of phases 3e-3g instead")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("logit_agreement: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    print(chip_smoke.card_line())
    if args.plant:
        result = {name: plant(name) for name in PLANT}
    else:
        result = {name: agreement(name, name in args.fp32) for name in args.models}
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "logit_agreement.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
