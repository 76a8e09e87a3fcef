"""plutracer-tpu-torch: the path tracer on PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of the JAX package ``plutracer_tpu``, which stays the reference:
the same urn scenes, the same path-tracing semantics and reference quirks
(``plutracer_tpu.semantics``), the same threefry random stream. Plain
PyTorch runs every step on any device; on a CUDA device the closest-hit
queries and the whole bounce loop go through hand-written kernels
(``ops/cuda``, sources in ``csrc/``). This package never imports jax: it
shares only the jax-free front end of the JAX package (``urn``, ``io``,
``native``, ``semantics``).
"""

__version__ = "0.1.0"
