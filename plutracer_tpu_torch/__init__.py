"""plutracer-tpu-torch: the path tracer on PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of the JAX package ``plutracer_tpu``, which stays the reference:
the same urn scenes, the same path-tracing semantics and reference quirks
(``semantics``), the same threefry random stream. Plain PyTorch runs
every step on any device; on a CUDA device the closest-hit queries and
the whole bounce loop go through hand-written kernels (``ops/cuda``,
sources in ``csrc/``). Gradients of pixel losses with respect to the
scene's colours and emission flow through every path (``render``,
``parallel``, ``diff``); ``parallel`` also splits renders and training
over a (tiles, spp) mesh of devices and torch.distributed processes, and
``utils`` and ``tools`` hold the diagnostics (RenderStats, the per-term
radiance split). This package imports neither jax nor anything
of the JAX package: it keeps its own copies of the front end (``urn``,
``io``, ``native``, ``semantics``).
"""

__version__ = "0.1.0"

from plutracer_tpu_torch.semantics import RenderOptions  # noqa: F401
