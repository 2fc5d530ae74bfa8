"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch oracles.

* ``decode_attention`` — one-token GQA decode against a KV cache

Use ``repro_torch.kernels.ops`` for the impl-dispatching wrappers.
"""
