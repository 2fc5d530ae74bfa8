"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch oracles.

* ``decode_attention`` — one-token GQA decode against a KV cache
* ``flash_attention`` — blocked causal/windowed GQA attention for prefill
  and training (an autograd Function under grad mode)
* ``flash_attention_bwd`` — its backward (dq, dk, dv from the forward's LSE)
* ``ssd_scan`` — the Mamba-2 SSD chunked scan for prefill and training
  (an autograd Function under grad mode)
* ``ssd_scan_bwd`` — its backward (dx, d(dt), da, db, dc and the initial
  state's gradient from the states the forward keeps)
* ``moe_gmm`` — the grouped expert matmul of the MoE dispatches (an
  autograd Function under grad mode)
* ``moe_gmm_bwd`` — its backward (dx on the forward kernel with w read
  transposed, dw on a kernel of its own)

Use ``repro_torch.kernels.ops`` for the impl-dispatching wrappers.
"""
