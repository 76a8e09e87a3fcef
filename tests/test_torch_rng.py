"""plutracer_tpu_torch.rng against jax.random: bit-equal keys and draws.

Tolerance: none. Every key word and every uniform's bit pattern must be
identical, because the port's per-pixel comparisons with the JAX package
rest on drawing the same random numbers at the same seed.
"""

import jax
import numpy as np
import pytest
import torch

from plutracer_tpu_torch import rng

SEEDS = [0, 1, 7, 42, 123456789, 2**31 - 1]


def as_words(jax_key):
    return np.asarray(jax_key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(rng.PRNGKey(seed).numpy(), as_words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split(seed, num):
    got = rng.split(rng.PRNGKey(seed), num).numpy()
    np.testing.assert_array_equal(got, as_words(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    for data in (0, 1, 5, 63, 2**31 + 5):
        got = rng.fold_in(rng.PRNGKey(seed), data).numpy()
        want = as_words(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (7, 12), (33, 2), (4, 3, 2), (1000, 12)])
def test_uniform_bits(shape):
    rs = np.random.RandomState(sum(shape))
    for seed in rs.randint(0, 2**31 - 1, size=3):
        got = rng.uniform(rng.PRNGKey(int(seed)), shape).numpy()
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(int(seed)), shape))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_render_key_schedule():
    """The draws of one render pass: fold_in(key, s), split into 3, (B, 2)
    pixel and lens jitter, then uniform(fold_in(k_path, i), (B, 12)) per
    bounce (renderer.py:36-40,94; integrator.py:283-284)."""
    from plutracer_tpu_torch.render.integrator import draw_uniforms

    B, mb = 96, 8
    jk = jax.random.fold_in(jax.random.PRNGKey(42), 3)
    tk = rng.fold_in(rng.PRNGKey(42), 3)
    jpx, jlens, jpath = jax.random.split(jk, 3)
    tpx, tlens, tpath = rng.split(tk, 3)
    for j, t in ((jpx, tpx), (jlens, tlens)):
        np.testing.assert_array_equal(
            rng.uniform(t, (B, 2)).numpy(), np.asarray(jax.random.uniform(j, (B, 2)))
        )
    want = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(jpath, i), (B, 12)))
                     for i in range(mb)])
    got = draw_uniforms(tpath, B, mb, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (mb, B, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bad_seed_rejected():
    with pytest.raises(ValueError):
        rng.PRNGKey(-1)
