"""R1: threefry2x32 uniforms on the card, a table of keys a launch.

``uniform_block_words(words, n)`` launches csrc/threefry.cu on the card
of `words`, a (K, 2) int32 table of the keys' uint32 words (their bit
patterns), reading the table where it lies: row k of its (K, n) float32
output is ``uniform`` of key k, bit-equal to ``rng.uniform_block_plain``
(and to jax.random.uniform). It replaces the threefry that XLA fuses
into the JAX package's render_passes (plutracer_tpu/render/integrator.py:
283-284): the pass loop draws all the path uniforms of a launch in one
call, from the launch's words (render/renderer.launch_words, sent by
rng.device_words). The pixel and lens jitter (renderer.py:39-40) are
drawn by R2 from the same hash (csrc/threefry.cuh), inside the
camera-ray kernel. Nothing is copied, so a CUDA graph can capture the
launch (parallel/sharded's train step). Each launch counts once in
utils/profiling's ``launches.r1``.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.rng import _check_count
from plutracer_tpu_torch.utils import profiling

MAX_KEYS = 65535  # the kernel's grid y extent (csrc/threefry.cu: MAX_KEYS)


def uniform_block_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """Launch R1 on the card of `words`, a contiguous (K, 2) int32 table of
    uint32 key words (bit patterns), and its current stream (no copy, no
    synchronisation): (K, n) float32, row k = uniform of key k. One launch
    for every K in 1..MAX_KEYS and 0 < n < 2**32; raises on anything the
    kernel does not take, a CPU table included."""
    if words.dim() != 2 or words.shape[1] != 2 or words.dtype != torch.int32:
        raise ValueError(f"uniform_block_words: words must be a (K, 2) int32 table, got "
                         f"{tuple(words.shape)} {words.dtype}")
    n = int(n)
    _check_count(n)
    if n < 0:
        raise ValueError(f"uniform_block_words: n must be non-negative, got {n}")
    if words.shape[0] > MAX_KEYS:
        raise ValueError(f"uniform_block_words: at most {MAX_KEYS} keys a launch, got "
                         f"{words.shape[0]}")
    if not words.is_cuda or not words.is_contiguous():
        raise ValueError(f"uniform_block_words: words must be contiguous on a CUDA device, got "
                         f"{words.device}")
    from plutracer_tpu_torch.ops.cuda import build

    K, dev = words.shape[0], words.device
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    if K == 0 or n == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("uniform_block_words: the output must be 16-byte aligned")
    lib = build.load().lib
    with build.on_device(dev) as stream:
        rc = lib.plu_threefry_uniform(words.data_ptr(), K, n, out.data_ptr(), stream)
    build.check(rc, "plu_threefry_uniform")
    profiling.count("launches.r1")
    return out
