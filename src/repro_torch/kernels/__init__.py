"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch oracles.

* ``decode_attention`` — one-token GQA decode against a KV cache
* ``flash_attention`` — blocked causal/windowed GQA attention for prefill
* ``ssd_scan`` — the Mamba-2 SSD chunked scan for prefill

Use ``repro_torch.kernels.ops`` for the impl-dispatching wrappers.
"""
