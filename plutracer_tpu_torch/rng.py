"""Counter-based threefry2x32 randomness, bit-equal to ``jax.random``.

A port of jax.random's default threefry2x32 generator with the
partitionable bit layout (``jax_threefry_partitionable=True``, the jax 0.9
default): keys are pairs of uint32 words, ``split`` and random bits hash a
64-bit iota split into (hi, lo) words, and 32-bit draws are ``bits1 ^
bits2``. Matching the reference's draws bit for bit lets the port's
images be compared per pixel with the JAX package at the same seed.

Keys are tiny int64 CPU tensors of shape (2,) (or (n, 2) from ``split``),
derived on Python ints (``threefry2x32`` takes ints as well as tensors):
deriving a key issues no tensor op and never touches the device.

Draws: ``uniform_block_words(words, n)`` fills a (K, n) float32 block,
row k being ``uniform`` of key k, from a (K, 2) int32 table of the keys'
uint32 words (their bit patterns) on the device that draws: on a card
one launch of the R1 kernel reading the table where it lies
(csrc/threefry.cu, ops/cuda/rng_kernel.py), on the CPU
``uniform_block_plain``, the same hash on int64 tensors (torch's uint32
lacks most arithmetic, so every uint32 word is held in an int64 tensor
and masked back to 32 bits after each add or shift). Key words reach a
device one way, ``device_words``: on a card one non-blocking copy from
pinned host memory. ``uniform_block(keys, n, device)`` is the block of a
table of keys, its words sent by ``device_words``; ``uniform`` a block
of one key.
"""

from __future__ import annotations

import math
import operator
from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under key (k1, k2): on Python ints, or on int64 tensors holding uint32
    values (ints and tensors broadcast against each other)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for step in range(5):
        for r in (_ROT0 if step % 2 == 0 else _ROT1):
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(step + 1) % 3]) & _MASK
        b = (b + ks[(step + 2) % 3] + step + 1) & _MASK
    return a, b


def key_words(key: torch.Tensor):
    """The (k1, k2) ints of a single key of shape (2,)."""
    if key.shape != (2,):
        raise ValueError(f"expected a single key of shape (2,), got {tuple(key.shape)}")
    return int(key[0]), int(key[1])


def fold_in_words(words, data: int):
    """fold_in on (k1, k2) ints: the hash of the counter pair (0, data)."""
    return threefry2x32(words[0], words[1], 0, int(data) & _MASK)


def split_words(words, num: int = 2):
    """split on (k1, k2) ints: num (k1, k2) pairs, counters (0, i)."""
    return [threefry2x32(words[0], words[1], 0, i) for i in range(num)]


def PRNGKey(seed) -> torch.Tensor:
    """jax.random.PRNGKey(seed): (0, seed mod 2**32) for any integer seed
    (a Python int must fit an int64, as jax converts it to a C long;
    OverflowError beyond); TypeError for a seed that is not an integer."""
    try:
        value = operator.index(seed)
    except TypeError:
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}") from None
    if isinstance(seed, int) and not -2**63 <= value < 2**63:
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, value & _MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: hash the counter pair (0, data) under key. A
    Python int outside [0, 2**32) raises OverflowError, as jax's uint32
    conversion does; other numbers are converted to uint32 words."""
    if isinstance(data, int) and not 0 <= data <= _MASK:
        raise OverflowError(f"Python integer {data} out of bounds for uint32")
    return torch.tensor(fold_in_words(key_words(key), data), dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable layout): (num, 2) new keys."""
    return torch.tensor(split_words(key_words(key), num), dtype=torch.int64).reshape(num, 2)


def _check_count(n: int) -> None:
    if n >= 2**32:
        raise ValueError("a key draws fewer than 2**32 values")


def key_table(keys) -> torch.Tensor:
    """(K, 2) int64 CPU words of a key, a (K, 2) key tensor or a sequence
    of keys or (k1, k2) pairs."""
    if isinstance(keys, torch.Tensor):
        return keys.reshape(-1, 2).to(torch.int64)
    return torch.tensor([key_words(k) if isinstance(k, torch.Tensor) else k for k in keys],
                        dtype=torch.int64).reshape(-1, 2)


def _block_bits(table: torch.Tensor, n: int, device) -> torch.Tensor:
    """(K, n) 32-bit words (as int64) of the (K, 2) key table's rows on
    `device`: row-major counters, partitionable layout, bits1 ^ bits2."""
    _check_count(n)
    table = table.to(device)
    lo = torch.arange(n, dtype=torch.int64, device=device)[None]
    a, b = threefry2x32(table[:, :1], table[:, 1:], torch.zeros_like(lo), lo)
    return a ^ b


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits become the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def random_bits(key: torch.Tensor, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32-bit random words (as int64) of the given shape (plain tensor ops)."""
    return _block_bits(key_table([key]), math.prod(shape), device).reshape(tuple(shape))


def uniform_plain(key: torch.Tensor, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1), on int64
    tensors on `device`."""
    return _bits_to_uniform(random_bits(key, shape, device))


def uniform_block_plain(keys, n: int, device="cpu") -> torch.Tensor:
    """(K, n) float32 on `device`: row k is uniform_plain(keys[k], (n,)).
    The plain version of the R1 kernel, on int64 tensors."""
    return _bits_to_uniform(_block_bits(key_table(keys), n, device))


def device_words(words: np.ndarray, device, out=None) -> torch.Tensor:
    """The int32 array `words` on `device`, the one way key words reach a
    device: on the CPU the tensor over the array itself; on a card one
    non-blocking copy from pinned host memory into `out` (a new tensor
    where None). torch's caching host allocator keeps the pinned block
    until the copy has run, so the host enqueues on without waiting."""
    host = torch.from_numpy(words)
    dev = torch.device(device)
    if dev.type != "cuda":
        return host
    if out is None:
        out = torch.empty(host.shape, dtype=torch.int32, device=dev)
    return out.copy_(host.pin_memory(), non_blocking=True)


def uniform_block(keys, n: int, device="cpu") -> torch.Tensor:
    """(K, n) float32 on `device`: row k is uniform(keys[k], (n,)). A CUDA
    device takes the table's words (device_words) and one R1 launch
    (uniform_block_words; it raises where it cannot launch), the CPU
    uniform_block_plain."""
    dev = torch.device(device)
    if dev.type == "cuda":
        table = key_table(keys).numpy().astype(np.uint32).view(np.int32)
        return uniform_block_words(device_words(table, dev), n)
    if dev.type != "cpu":
        raise ValueError(f"uniform_block: no draw for device {dev}")
    return uniform_block_plain(keys, n, dev)


def uniform_block_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """uniform_block of the keys whose uint32 words are the int32 bit
    patterns of `words`, (K, 2), on words' device: one R1 launch reading
    the table on a card (ops/cuda/rng_kernel.uniform_block_words: no copy,
    so a CUDA graph can capture it), uniform_block_plain on the CPU; any
    other device raises."""
    if words.device.type == "cuda":
        from plutracer_tpu_torch.ops.cuda.rng_kernel import uniform_block_words as launch

        return launch(words, n)
    if words.device.type != "cpu":
        raise ValueError(f"uniform_block_words: no draw for device {words.device}")
    return uniform_block_plain(words.to(torch.int64) & _MASK, n, words.device)


def uniform(key: torch.Tensor, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1): uniform_block
    of the one key."""
    return uniform_block(key_table([key]), math.prod(shape), device).reshape(tuple(shape))
