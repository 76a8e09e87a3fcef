"""The pass loop's camera stage (R2's contract) on the CPU.

``renderer.camera_rays_plain`` is the plain version of R2
(csrc/camera.cu) and its oracle: from a launch's jitter keys (k_px,
k_lens), handed back by ``renderer.launch_draws``, it draws the pixel and
lens jitter (``jitter_plain``) and makes the rays (``jittered_rays``);
``renderer.launch_rays`` sends a CUDA launch to R2 and a CPU one to the
plain version. The pass loop makes one launch_draws call (one R1 launch)
and one launch_rays call a launch. R2 itself runs only on a card
(tests/test_torch_cuda.py ``test_r2_*``); here a fake library stands in
for it, as in tests/test_torch_launch.py.

Tolerances: the jitter words equal jax.random.uniform's bit for bit (one
integer hash); camera_rays_plain equals torch.cat of the per-stratum
_camera_rays bit for bit (each ray's elementwise operations are the
same). Against the JAX package's camera stage of _trace_stratum: o within
tests/test_torch_ops.py's default (rtol 1e-5, atol 1e-5) and d within
rtol 1e-5, atol 1e-6, test_generate_rays' tolerances (XLA's CPU norm and
trigonometry round apart from torch's by an ulp).
"""

import pathlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plutracer_tpu.ops.camera import generate_rays as jax_generate_rays
from plutracer_tpu.render.renderer import pixel_centers as jax_pixel_centers
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.cuda import build, camera_kernel
from plutracer_tpu_torch.render import renderer
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from plutracer_tpu_torch.utils import profiling
from test_torch_launch import CARD, OTHER, Cards, FakeLibrary, HostAsCard
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 13, 7  # 91 pixels: no whole vector of any width


def scene(name, device="cpu"):
    return compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"),
                                         ["/res", f"{W}x{H}"]), device=device)


def stratum_words(S, seed=3):
    """The keys of a launch of S strata: fold_in(PRNGKey(seed), j) as ints."""
    return [rng.fold_in_words(rng.key_words(rng.PRNGKey(seed)), j) for j in range(S)]


def launch(S, seed=3):
    """A launch's jitter keys [(k_px, k_lens)] * S, as launch_draws hands
    them back."""
    keys, _ = renderer.launch_draws(stratum_words(S, seed), W * H, 0, "cpu")
    return keys


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", ["demo-box", "dof"])
@pytest.mark.parametrize("S,order", [(1, "in order"), (4, "in order"), (16, "in order"),
                                     (4, "shuffled"), (16, "shuffled")])
def test_plain_equals_per_stratum_rays(name, S, order):
    """camera_rays_plain over a launch of S strata equals torch.cat of
    _camera_rays a stratum, bit for bit, for cells in any order (a
    pinhole camera and a thin lens)."""
    s, n = scene(name), 4 if S < 16 else 5
    strata = list(range(S)) if order == "in order" else random.Random(S).sample(range(n * n), S)
    px0, keys = renderer.pixel_centers(W, H), launch(S)
    o, d = renderer.camera_rays_plain(s.camera, px0, keys, strata, n)
    jit = renderer.jitter_plain(keys, W * H, "cpu")
    oo, dd = zip(*(renderer._camera_rays(s, px0, jit, j, c, n) for j, c in enumerate(strata)))
    assert o.shape == d.shape == (S * W * H, 3)
    assert bits_equal(o, torch.cat(oo)) and bits_equal(d, torch.cat(dd))
    # the jitter-taking stage, and launch_rays on the CPU, are the plain version
    jo, jd = renderer.jittered_rays(s.camera, px0, jit, strata, n)
    assert bits_equal(jo, o) and bits_equal(jd, d)
    lo, ld = renderer.launch_rays(s, px0, keys, strata, n)
    assert bits_equal(lo, o) and bits_equal(ld, d)


@pytest.mark.parametrize("name", ["demo-box", "dof"])
@pytest.mark.parametrize("S", [1, 3, 16])
def test_launch_rays_match_jax_camera_stage(name, S):
    """launch_draws' keys + launch_rays (keys to rays) against the JAX
    package's camera stage of _trace_stratum (renderer.py:36-43): k_px,
    k_lens, _ = split(key, 3), px = px0 + (cell + uniform(k_px, (B, 2)) *
    0.999) / n, the lens likewise, generate_rays; keys
    fold_in(PRNGKey(seed), j) from numpy seeds, the cells out of order, the
    image's B pixels and a ragged prefix of them."""
    s = scene(name)
    js = jax_compile(jax_load(str(REPO / "scenes" / f"{name}.urn"), ["/res", f"{W}x{H}"]))
    n = 4
    strata = random.Random(S).sample(range(n * n), S)
    for seed, B in zip(np.random.default_rng(13).integers(0, 2**31, size=2).tolist(),
                       (W * H, 37)):
        px0, jpx0 = renderer.pixel_centers(W, H)[:B], jax_pixel_centers(W, H)[:B]
        keys, _ = renderer.launch_draws(stratum_words(S, seed), B, 0, "cpu")
        o, d = renderer.launch_rays(s, px0, keys, strata, n)
        want = []
        for j, c in enumerate(strata):
            k_px, k_lens, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), j), 3)
            cell = jnp.asarray([c % n, c // n], jnp.float32)
            px = jpx0 + (cell + jax.random.uniform(k_px, (B, 2)) * 0.999) / n
            lens = (cell + jax.random.uniform(k_lens, (B, 2)) * 0.999) / n
            want.append(jax_generate_rays(js.camera, px, lens))
        jo, jd = (np.concatenate([np.asarray(w[i]) for w in want]) for i in (0, 1))
        assert o.shape == d.shape == (S * B, 3)
        np.testing.assert_allclose(o.numpy(), jo, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [W * H, 1, 37])
def test_plain_jitter_equals_jax_uniform(B):
    """The plain version's jitter words: jitter_plain of launch_draws' keys
    is jax.random.uniform(k_px, (B, 2)) and jax.random.uniform(k_lens,
    (B, 2)) of each stratum's split(fold_in(PRNGKey(seed), j), 3), bit for
    bit; the keys are split_words of the stratum's key."""
    words = stratum_words(3, seed=11)
    keys, _ = renderer.launch_draws(words, B, 0, "cpu")
    assert keys == [tuple(rng.split_words(w, 3)[:2]) for w in words]
    jit = renderer.jitter_plain(keys, B, "cpu")
    assert jit.dtype == torch.float32 and tuple(jit.shape) == (2, 3, B, 2)
    for j in range(3):
        k_px, k_lens, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(11), j), 3)
        for row, key in ((0, k_px), (1, k_lens)):
            want = np.asarray(jax.random.uniform(key, (B, 2)))
            np.testing.assert_array_equal(jit[row, j].numpy().view(np.int32),
                                          want.view(np.int32))


def test_launch_rays_refuses_other_devices():
    s, keys = scene("demo-box"), launch(1)
    with pytest.raises(ValueError, match="no camera rays for device meta"):
        renderer.launch_rays(s, renderer.pixel_centers(W, H).to("meta"), keys, [0], 2)


class RecordingLibrary(FakeLibrary):
    """The fake library, also keeping each R2 call's arguments."""

    def __init__(self, cards):
        super().__init__(cards)
        self.r2_args = []

    def __getattr__(self, name):
        call = super().__getattr__(name)

        def recorded(*args):
            if name == "plu_camera_rays":
                self.r2_args.append(args)
            return call(*args)

        return recorded


@pytest.fixture
def card_env(monkeypatch):
    cards = Cards()
    lib = RecordingLibrary(cards)
    monkeypatch.setattr(torch.cuda, "device", cards.device)
    monkeypatch.setattr(torch.cuda, "current_stream", cards.current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: cards.current.index)
    monkeypatch.setattr(build, "load", lambda: type("Lib", (), {"lib": lib})())
    monkeypatch.setattr(build, "_ARRIVALS", {})
    with HostAsCard():
        yield cards, lib


def no_eager_camera(*_args, **_kw):
    raise AssertionError("an eager camera op ran on a card launch")


@pytest.mark.parametrize("pairs", [[(s, s) for s in range(20)],
                                   [(j, s) for j, s in enumerate([5, 1, 3])]], ids=str)
def test_stratum_launches_one_r2_call_a_launch(card_env, monkeypatch, pairs):
    """On tensors that report a card, stratum_launches makes one R1 call
    (the path uniforms) and one R2 call a launch, inside build.on_device
    with the tensors' card current, with the launch's cells and jitter
    key words by value (split_words of each stratum's key), no eager
    camera op and no jitter drawn; the rays R2 wrote go to the path
    kernel."""
    cards, lib = card_env
    s = scene("demo-box").to(CARD)
    px0 = renderer.pixel_centers(W, H).to(CARD)
    for name in ("generate_rays", "camera_rays_plain", "jittered_rays", "jitter_plain",
                 "_camera_rays", "_sample_positions"):
        monkeypatch.setattr(renderer, name, no_eager_camera)
    seen = []

    def radiance(scene_, o, d, u, options):
        seen.append((o, d))
        return torch.zeros((o.shape[0], 3), device=o.device)

    monkeypatch.setattr(renderer, "radiance_of_uniforms", radiance)
    per = renderer.strata_per_launch(s, DEFAULT_OPTIONS, W * H)
    assert per == renderer.MAX_STRATA == camera_kernel.MAX_STRATA
    counted = lambda: (profiling.counter("launches.r2"), profiling.counter("device_entries"))
    with profiling.recording():
        before = counted()
        out = list(renderer.stratum_launches(s, rng.PRNGKey(0), pairs, px0, 5, DEFAULT_OPTIONS))
        after = counted()
    launches = -(-len(pairs) // per)
    assert len(out) == len(seen) == launches
    assert [name for name, _, _ in lib.calls] == (
        ["plu_threefry_uniform", "plu_camera_rays"] * launches)
    assert all(current == CARD for _, current, _ in lib.calls) and cards.stack == [OTHER]
    assert after[0] - before[0] == launches
    assert after[1] - before[1] == 2 * launches
    base = rng.key_words(rng.PRNGKey(0))
    for i, args in enumerate(lib.r2_args):
        group = pairs[i * per:(i + 1) * per]
        S = len(group)
        assert list(args[2].cell)[:S] == [st for _, st in group] and args[3:6] == (S, W * H, 5)
        words = [w for j, _ in group
                 for k in rng.split_words(rng.fold_in_words(base, j), 3)[:2] for w in k]
        assert list(args[2].key)[:4 * S] == words
        o, d = seen[i]
        assert (o.data_ptr(), d.data_ptr()) == (args[6], args[7])  # R2's rays, not copies
        assert o.shape == d.shape == (S * W * H, 3)


def test_stratum_rays_one_r2_call(card_env, monkeypatch):
    """_stratum_rays (the train step's, render_pass's and term_dump's
    rays) on a card: one R2 call of one stratum, no eager camera op."""
    _, lib = card_env
    s = scene("dof").to(CARD)
    monkeypatch.setattr(renderer, "generate_rays", no_eager_camera)
    o, d, u = renderer._stratum_rays(s, renderer.pixel_centers(W, H).to(CARD), rng.PRNGKey(1), 6,
                                     3, DEFAULT_OPTIONS)
    assert [name for name, _, _ in lib.calls] == ["plu_threefry_uniform", "plu_camera_rays"]
    args = lib.r2_args[-1]
    k_px, k_lens, _ = rng.split_words(rng.key_words(rng.PRNGKey(1)), 3)
    assert args[2].cell[0] == 6 and args[3:6] == (1, W * H, 3)
    assert list(args[2].key)[:4] == [*k_px, *k_lens]
    assert o.shape == d.shape == (W * H, 3) and u.shape == (DEFAULT_OPTIONS.max_bounces, W * H, 12)


def test_r2_wrapper_checks(card_env):
    """R2's wrapper refuses CPU tensors, a launch of no or more than 16
    strata, a key list of another length or shape, key words outside
    uint32 and pixel positions of another type, before any launch."""
    _, lib = card_env
    s = scene("demo-box")
    px0, keys = renderer.pixel_centers(W, H), launch(2)
    run = camera_kernel.camera_rays_cuda
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        run(s.camera, px0, keys, [0, 1], 2)
    cs, cpx = s.to(CARD), px0.to(CARD)
    with pytest.raises(ValueError, match="1 to 16 strata"):
        run(cs.camera, cpx, [], [], 2)
    with pytest.raises(ValueError, match="1 to 16 strata"):
        run(cs.camera, cpx, launch(17), list(range(17)), 5)
    with pytest.raises(ValueError, match="2 jitter key pairs for 3 strata"):
        run(cs.camera, cpx, keys, [0, 1, 2], 2)
    with pytest.raises(ValueError, match="pairs of two words"):
        run(cs.camera, cpx, [keys[0], keys[1][:1]], [0, 1], 2)
    (px_key, lens_key) = keys[1]
    for bad in (2**32, -1, 1.0):
        with pytest.raises(ValueError, match=r"ints in \[0, 2\*\*32\)"):
            run(cs.camera, cpx, [keys[0], (px_key, (lens_key[0], bad))], [0, 1], 2)
    with pytest.raises(ValueError, match="px0 must be a contiguous float32"):
        run(cs.camera, cpx.double(), keys, [0, 1], 2)
    assert lib.calls == []  # refused before any launch
    run(cs.camera, cpx, keys, [0, 1], 2)
    assert [name for name, _, _ in lib.calls] == ["plu_camera_rays"]


def test_camera_table_built_once_a_camera():
    """The camera table: the layout csrc/camera.cu reads, built once a
    camera and again when a camera tensor changes."""
    cam = scene("dof").camera
    table = camera_kernel.camera_table(cam)
    want = torch.cat([cam.pos, cam.look, cam.right, cam.up, cam.inv_image_size,
                      cam.w.reshape(1), cam.lens_radius.reshape(1), cam.focal_distance.reshape(1)])
    assert torch.equal(table, want) and table.dtype == torch.float32
    assert camera_kernel.camera_table(cam) is table
    cam.lens_radius.mul_(2.0)
    again = camera_kernel.camera_table(cam)
    assert again is not table and again[15] == 2.0 * table[15]
