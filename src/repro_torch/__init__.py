"""PyTorch/CUDA port of the Compass reproduction, held against the JAX
package ``repro``: the Navigator core (copied), the zoo models' decode,
prefill and training paths, the serving engine, the meshes, sharding
rules and launchers over ``torch.distributed``, and hand-written Hopper
kernels under ``csrc/``.

It imports ``torch`` and never ``jax``, and nothing of ``repro``.
"""
