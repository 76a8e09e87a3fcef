"""plutracer_tpu_torch.rng against jax.random: bit-equal keys and draws.

Tolerance: none. Every key word and every uniform's bit pattern must be
identical, because the port's per-pixel comparisons with the JAX package
rest on drawing the same random numbers at the same seed.
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.render.renderer import launch_words
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
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


# seeds jax.random.PRNGKey takes outside [0, 2**31): (0, seed mod 2**32)
WIDE_SEEDS = [-1, -2**31, 2**31, 2**32 + 5, 2**63 - 1, -2**63, np.int64(-1), np.int32(-7),
              np.uint32(2**32 - 1), True]


@pytest.mark.parametrize("seed", WIDE_SEEDS, ids=repr)
def test_prng_key_any_integer_seed(seed):
    np.testing.assert_array_equal(rng.PRNGKey(seed).numpy(), as_words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [2**63, -2**63 - 1, 2**64, 3.0, "7"], ids=repr)
def test_bad_seed_rejected(seed):
    """A seed jax.random.PRNGKey refuses is refused with the same
    exception: a Python int past int64 (OverflowError), or a seed that
    is not an integer (TypeError)."""
    with pytest.raises(Exception) as want:
        jax.random.PRNGKey(seed)
    with pytest.raises(want.type):
        rng.PRNGKey(seed)


@pytest.mark.parametrize("data", [-1, 2**32, 2**32 + 5, -2**31], ids=repr)
def test_fold_in_rejects_data_outside_uint32(data):
    """fold_in's data is a uint32 word: a Python int outside [0, 2**32)
    raises OverflowError, as jax.random.fold_in does."""
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.PRNGKey(0), data)
    with pytest.raises(OverflowError):
        rng.fold_in(rng.PRNGKey(0), data)


@pytest.mark.parametrize("data", [0, 2**31, 2**32 - 1, np.int64(-1), np.uint32(7), True],
                         ids=repr)
def test_fold_in_takes_what_jax_takes(data):
    np.testing.assert_array_equal(
        rng.fold_in(rng.PRNGKey(5), data).numpy(),
        as_words(jax.random.fold_in(jax.random.PRNGKey(5), data)))


# the integer key schedule, the block draw of a launch and R1's dispatch

EDGE_SEEDS = [0, 1, 2**31 - 1]
EDGE_DATA = [0, 2**31, 2**32 - 1]


def tensor_fold_in(key, data):
    """fold_in on int64 tensors (the plain hash), for the integer path."""
    x2 = torch.tensor([int(data) & 0xFFFFFFFF], dtype=torch.int64)
    a, b = rng.threefry2x32(int(key[0]), int(key[1]), torch.zeros_like(x2), x2)
    return torch.cat([a, b])


def tensor_split(key, num):
    lo = torch.arange(num, dtype=torch.int64)
    a, b = rng.threefry2x32(int(key[0]), int(key[1]), torch.zeros_like(lo), lo)
    return torch.stack([a, b], -1)


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_integer_keys_equal_tensor_hash_and_jax(seed):
    """PRNGKey, fold_in and split on Python ints equal the int64 tensor
    hash and jax.random, at the edge seeds and data words."""
    key, jkey = rng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert key.dtype == torch.int64 and key.device.type == "cpu"
    np.testing.assert_array_equal(key.numpy(), as_words(jkey))
    for data in EDGE_DATA:
        got = rng.fold_in(key, data)
        assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
        assert torch.equal(got, tensor_fold_in(key, data))
        np.testing.assert_array_equal(got.numpy(), as_words(jax.random.fold_in(jkey, data)))
        assert rng.fold_in_words(rng.key_words(key), data) == tuple(got.tolist())
    for num in (1, 3):
        got = rng.split(key, num)
        assert got.dtype == torch.int64 and tuple(got.shape) == (num, 2)
        assert torch.equal(got, tensor_split(key, num))
        np.testing.assert_array_equal(got.numpy(), as_words(jax.random.split(jkey, num)))


def launch_keys(seed=42, strata=(5, 6, 7)):
    """The stratum keys of a launch: fold_in(key, j), as words and as JAX keys."""
    base = rng.PRNGKey(seed)
    words = [rng.fold_in_words(rng.key_words(base), j) for j in strata]
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(seed), j) for j in strata]
    return words, jkeys


def launch_parts(words, S, mb):
    """A launch_words block's R1 key table ((S * mb, 2) int32) and R2 rows
    ((S, 5) int32), as tensors."""
    w = torch.from_numpy(words)
    return w[:2 * S * mb].view(S * mb, 2), w[2 * S * mb:].view(S, -1)


@pytest.mark.parametrize("S", [1, 4, 16])
def test_launch_words_are_jax_key_schedule(S):
    """launch_words of S strata (keys fold_in(PRNGKey(seed), j), cells out
    of order, max_bounces 8): R1's rows, bounce-major, are JAX's
    fold_in(k_path_j, i) at row i * S + j, and R2's row j is the cell and
    k_px_j, k_lens_j, with (k_px, k_lens, k_path) = split(key_j, 3), every
    word as its int32 bit pattern."""
    mb = 8
    strata = list(range(3, 3 + S))[::-1]
    words, jkeys = launch_keys(seed=2**31 + S, strata=range(S))
    got = launch_words(words, strata, mb)
    assert got.dtype == np.int32 and got.shape == (2 * S * mb + 5 * S,)
    r1, r2 = launch_parts(got, S, mb)
    trips = [jax.random.split(jk, 3) for jk in jkeys]
    for i in range(mb):
        for j, (_, _, k_path) in enumerate(trips):
            assert (r1[i * S + j].numpy().view(np.uint32)
                    == np.asarray(jax.random.fold_in(k_path, i))).all(), (i, j)
    for j, (k_px, k_lens, _) in enumerate(trips):
        assert r2[j].numpy().view(np.uint32).tolist() == [
            strata[j], *np.asarray(k_px).tolist(), *np.asarray(k_lens).tolist()]


@pytest.mark.parametrize("B", [37, 1000])
def test_launch_block_equals_per_stratum_draws_and_jax(B):
    """The path uniforms of a launch of S = 3 strata (max_bounces 8), one
    uniform_block_words call on its launch_words' R1 rows, equal each
    stratum's draw_uniforms concatenated along the rays, and JAX's
    uniform(fold_in(k_path, i), (B, 12)) per bounce."""
    from plutracer_tpu_torch.render.integrator import draw_uniforms

    mb = 8
    words, jkeys = launch_keys()
    r1, _ = launch_parts(launch_words(words, [0, 1, 2], mb), 3, mb)
    u = rng.uniform_block_words(r1, 12 * B).reshape(mb, 3 * B, 12)
    assert u.dtype == torch.float32 and u.is_contiguous()
    per = [draw_uniforms(rng.split(torch.tensor(w), 3)[2], B, mb, "cpu") for w in words]
    assert torch.equal(u, torch.cat(per, 1))
    want = np.concatenate([
        np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.split(jk, 3)[2], i),
                                                (B, 12))) for i in range(mb)])
        for jk in jkeys], 1)
    np.testing.assert_array_equal(u.numpy().view(np.int32), want.view(np.int32))


def test_launch_jitter_equals_sample_position_draws():
    """The jitter of a launch, drawn from its launch_words' R2 rows: the
    uniforms of row j's key words are uniform(k_px_j, (B, 2)) and
    uniform(k_lens_j, (B, 2)), as JAX draws them, and the plain twin
    (camera_rays_table_plain) turns them into the positions (cell +
    u*0.999)/n of each stratum drawn alone, ray for ray, bit for bit."""
    from plutracer_tpu_torch.ops.camera import generate_rays
    from plutracer_tpu_torch.render.renderer import camera_rays_table_plain, over, pixel_centers
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    B, n = 48, 3
    words, jkeys = launch_keys()
    strata = [4, 5, 6]
    _, r2 = launch_parts(launch_words(words, strata, 0), 3, 0)
    px0 = pixel_centers(8, 6)
    cam = compile_scene(load_scene_file(str(REPO / "scenes" / "dof.urn"), ["/res", "8x6"]),
                        device="cpu").camera
    o, d = camera_rays_table_plain(cam, px0, r2, n)
    for j, (w, jk) in enumerate(zip(words, jkeys)):
        k_px, k_lens, _ = rng.split(torch.tensor(w), 3)
        j_px, j_lens, _ = jax.random.split(jk, 3)
        for cols, key, jkey in ((slice(1, 3), k_px, j_px), (slice(3, 5), k_lens, j_lens)):
            jit = rng.uniform_block_words(r2[j:j + 1, cols].contiguous(), 2 * B).reshape(B, 2)
            assert torch.equal(jit, rng.uniform_plain(key, (B, 2)))
            np.testing.assert_array_equal(jit.numpy(), np.asarray(jax.random.uniform(jkey, (B, 2))))
        cell = torch.tensor([strata[j] % n, strata[j] // n], dtype=torch.float32)
        px = px0 + over(cell + rng.uniform_plain(k_px, (B, 2)) * 0.999, n)
        lens = over(cell + rng.uniform_plain(k_lens, (B, 2)) * 0.999, n)
        wo, wd = generate_rays(cam, px, lens)
        assert torch.equal(o[j * B:(j + 1) * B], wo) and torch.equal(d[j * B:(j + 1) * B], wd)


def test_uniform_block_plain_rows_and_guards():
    """uniform_block on the CPU is the plain block: row k equals
    uniform_plain(keys[k]); an empty table gives (0, n); a count of 2**32
    words and a device other than the CPU and CUDA are refused."""
    keys = rng.split(rng.PRNGKey(3), 4)
    got = rng.uniform_block(keys, 27)
    assert tuple(got.shape) == (4, 27)
    for k in range(4):
        assert torch.equal(got[k], rng.uniform_plain(keys[k], (27,)))
    assert tuple(rng.uniform_block([], 5).shape) == (0, 5)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        rng.uniform_block_plain(keys, 2**32)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        rng.random_bits(rng.PRNGKey(0), (2**16, 2**16))
    with pytest.raises(ValueError, match="device"):
        rng.uniform_block(keys, 4, "meta")


def test_kernel_wrapper_refuses_the_cpu():
    """R1's wrapper checks the table and the count, and launches on CUDA
    devices only; nothing is launched here."""
    from plutracer_tpu_torch.ops.cuda.rng_kernel import uniform_block_words

    from plutracer_tpu_torch.utils import profiling

    words = torch.zeros((2, 2), dtype=torch.int32)
    with profiling.recording():
        before = profiling.counter("launches.r1")
        with pytest.raises(ValueError, match="CUDA"):
            uniform_block_words(words, 8)
        with pytest.raises(ValueError, match="2\\*\\*32"):
            uniform_block_words(words, 2**32)
        with pytest.raises(ValueError, match="at most"):
            uniform_block_words(torch.zeros((65536, 2), dtype=torch.int32), 8)
        with pytest.raises(ValueError, match="int32 table"):
            uniform_block_words(words.to(torch.int64), 8)
        assert profiling.counter("launches.r1") == before


def test_cpu_draws_never_import_the_kernel_module():
    """A fresh interpreter: rng.uniform, draw_uniforms and a tiny render on
    the CPU leave the kernel module (and the build module) unimported."""
    code = (
        "import sys\n"
        "from plutracer_tpu_torch import rng\n"
        "from plutracer_tpu_torch.render.integrator import draw_uniforms\n"
        "from plutracer_tpu_torch.render.renderer import render\n"
        "from plutracer_tpu_torch.scene import compile_scene, load_scene_file\n"
        "rng.uniform(rng.PRNGKey(0), (5, 2), 'cpu')\n"
        "draw_uniforms(rng.PRNGKey(1), 7, 8, 'cpu')\n"
        "s = compile_scene(load_scene_file('scenes/demo-box.urn', ['/res', '4x3']), device='cpu')\n"
        "render(s, 4, 3, 1, rng.PRNGKey(2))\n"
        "bad = [m for m in ('plutracer_tpu_torch.ops.cuda.rng_kernel',"
        " 'plutracer_tpu_torch.ops.cuda.build') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('NO_KERNEL')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NO_KERNEL" in proc.stdout
