"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch oracles.

* ``decode_attention`` — one-token GQA decode against a KV cache
* ``flash_attention`` — blocked causal/windowed GQA attention for prefill
  and training (an autograd Function under grad mode)
* ``flash_attention_bwd`` — its backward (dq, dk, dv from the forward's LSE)
* ``ssd_scan`` — the Mamba-2 SSD chunked scan for prefill
* ``moe_gmm`` — the grouped expert matmul of the sorted MoE dispatch

Use ``repro_torch.kernels.ops`` for the impl-dispatching wrappers.
"""
