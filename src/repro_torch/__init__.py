"""PyTorch/CUDA port of the Compass reproduction, held against the JAX
package ``repro``: the Navigator core (copied), the zoo models' decode and
prefill paths, the serving engine, and hand-written Hopper kernels under
``csrc/``.

It imports ``torch`` and never ``jax``, and nothing of ``repro``.
"""
