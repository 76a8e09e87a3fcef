"""Counter-based threefry2x32 randomness, bit-equal to ``jax.random``.

A port of jax.random's default threefry2x32 generator with the
partitionable bit layout (``jax_threefry_partitionable=True``, the jax 0.9
default): keys are pairs of uint32 words, ``split`` and random bits hash a
64-bit iota split into (hi, lo) words, and 32-bit draws are ``bits1 ^
bits2``. Matching the reference's draws bit for bit lets the port's
images be compared per pixel with the JAX package at the same seed.

torch's uint32 lacks most arithmetic, so every uint32 word is held in an
int64 tensor and masked back to 32 bits after each add or shift.

Keys are tiny int64 CPU tensors of shape (2,) (or (n, 2) from ``split``);
deriving a key never touches the device. ``uniform`` hashes its counters
on the requested device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under key (k1, k2). x1, x2: int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for step in range(5):
        for r in (_ROT0 if step % 2 == 0 else _ROT1):
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(step + 1) % 3]) & _MASK
        b = (b + ks[(step + 2) % 3] + step + 1) & _MASK
    return a, b


def _words(key: torch.Tensor):
    if key.shape != (2,):
        raise ValueError(f"expected a single key of shape (2,), got {tuple(key.shape)}")
    return int(key[0]), int(key[1])


def PRNGKey(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 32-bit non-negative seed: (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must lie in [0, 2**31), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: hash the counter pair (0, data) under key."""
    k1, k2 = _words(key)
    x1 = torch.zeros(1, dtype=torch.int64)
    x2 = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    a, b = threefry2x32(k1, k2, x1, x2)
    return torch.cat([a, b])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable layout): (num, 2) new keys."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64)
    a, b = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([a, b], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32-bit random words (as int64) of the given shape, row-major
    counters, partitionable layout: bits1 ^ bits2."""
    k1, k2 = _words(key)
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("random_bits supports fewer than 2**32 values")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (a ^ b).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1): the top 23
    bits become the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
