"""R1: threefry2x32 uniforms on the card, a table of keys a launch.

``uniform_block_cuda(keys, n, device)`` launches csrc/threefry.cu: row k
of its (K, n) float32 output is ``uniform(keys[k], (n,))``, bit-equal to
``rng.uniform_block_plain`` (and to jax.random.uniform). It replaces the
threefry that XLA fuses into the JAX package's render_passes
(plutracer_tpu/render/integrator.py:283-284, renderer.py:39-40): the pass
loop draws all the path uniforms of a launch in one call and its pixel
and lens jitter in another (render/renderer.launch_draws).

The keys arrive as a (K, 2) int64 CPU table of uint32 words, derived on
the host (rng.fold_in_words, rng.split_words) and copied to the card once
a call. ``uniform_block_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.rng import _check_count

MAX_KEYS = 65535  # the kernel's grid y extent (csrc/threefry.cu: MAX_KEYS)


def _device_words(keys: torch.Tensor, device) -> torch.Tensor:
    """(K, 2) uint32 words as int32 bit patterns on `device`."""
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64 or keys.is_cuda:
        raise ValueError(f"uniform_block_cuda: keys must be a (K, 2) int64 CPU table, got "
                         f"{tuple(keys.shape)} {keys.dtype} on {keys.device}")
    if ((keys < 0) | (keys > 0xFFFFFFFF)).any():
        raise ValueError("uniform_block_cuda: key words must lie in [0, 2**32)")
    signed = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
    return signed.to(device).contiguous()


def uniform_block_cuda(keys: torch.Tensor, n: int, device) -> torch.Tensor:
    """Launch R1 on `device` and its current stream (no synchronisation):
    (K, n) float32 on the CUDA `device`, row k = uniform(keys[k], (n,)).
    One launch for every K in 1..MAX_KEYS and 0 < n < 2**32; raises on
    anything else, a CPU device included."""
    from plutracer_tpu_torch.ops.cuda import build

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"uniform_block_cuda: needs a CUDA device, got {dev}")
    n = int(n)
    _check_count(n)
    if n < 0:
        raise ValueError(f"uniform_block_cuda: n must be non-negative, got {n}")
    K = keys.shape[0] if keys.dim() == 2 else -1
    if K > MAX_KEYS:
        raise ValueError(f"uniform_block_cuda: at most {MAX_KEYS} keys a launch, got {K}")
    words = _device_words(keys, dev)
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    if K == 0 or n == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("uniform_block_cuda: the output must be 16-byte aligned")
    lib = build.load().lib
    with build.on_device(dev) as stream:
        rc = lib.plu_threefry_uniform(words.data_ptr(), K, n, out.data_ptr(), stream)
    build.check(rc, "plu_threefry_uniform")
    uniform_block_cuda.launches += 1
    return out


uniform_block_cuda.launches = 0
