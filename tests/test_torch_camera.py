"""The pass loop's camera stage (R2's contract) on the CPU.

``renderer.camera_rays_table_plain`` is the plain twin of R2
(csrc/camera.cu) and its oracle: from a launch's R2 rows (each stratum's
cell and jitter keys (k_px, k_lens), the second part of
``renderer.launch_words``' block) it draws the pixel and lens jitter and
makes the rays; ``renderer.launch_rays_table`` sends a CUDA launch to R2
and a CPU one to the twin. A pass-loop launch copies its words to the
card once and makes one R1 and one R2 launch, each reading a view of
that buffer. R2 itself runs only on a card (tests/test_torch_cuda.py
``test_r2_*``); here a fake library stands in for it, as in
tests/test_torch_launch.py.

Tolerances: the jitter words equal jax.random.uniform's bit for bit (one
integer hash); the twin over S strata equals its S one-stratum launches
bit for bit (each ray's elementwise operations are the same). Against
the JAX package's camera stage of _trace_stratum: o within
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


def stratum_keys(S, seed=3):
    """The keys of a launch of S strata: fold_in(PRNGKey(seed), j) as ints."""
    return [rng.fold_in_words(rng.key_words(rng.PRNGKey(seed)), j) for j in range(S)]


def rows(strata, seed=3):
    """The (S, 5) int32 R2 rows of a launch of the cells `strata`, stratum
    j keyed fold_in(PRNGKey(seed), j): launch_words with no bounces."""
    words = renderer.launch_words(stratum_keys(len(strata), seed), strata, 0)
    return torch.from_numpy(words).view(len(strata), -1)


def jax_camera_stage(js, jpx0, seed, strata, n):
    """The JAX package's camera stage of _trace_stratum (renderer.py:36-43)
    for stratum j keyed fold_in(PRNGKey(seed), j) at cell strata[j]: k_px,
    k_lens, _ = split(key, 3), px = px0 + (cell + uniform(k_px, (B, 2)) *
    0.999) / n, the lens likewise, generate_rays; the strata's o and d
    concatenated."""
    B, want = jpx0.shape[0], []
    for j, c in enumerate(strata):
        k_px, k_lens, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), j), 3)
        cell = jnp.asarray([c % n, c // n], jnp.float32)
        px = jpx0 + (cell + jax.random.uniform(k_px, (B, 2)) * 0.999) / n
        lens = (cell + jax.random.uniform(k_lens, (B, 2)) * 0.999) / n
        want.append(jax_generate_rays(js.camera, px, lens))
    return (np.concatenate([np.asarray(w[i]) for w in want]) for i in (0, 1))


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", ["demo-box", "dof"])
@pytest.mark.parametrize("S,order", [(1, "in order"), (4, "in order"), (16, "in order"),
                                     (4, "shuffled"), (16, "shuffled")])
def test_plain_equals_per_stratum_rays(name, S, order):
    """camera_rays_table_plain over a launch of S strata equals torch.cat
    of its S one-stratum launches (one row each), bit for bit, for cells in
    any order (a pinhole camera and a thin lens); launch_rays_table on the
    CPU is the twin."""
    s, n = scene(name), 4 if S < 16 else 5
    strata = list(range(S)) if order == "in order" else random.Random(S).sample(range(n * n), S)
    px0, table = renderer.pixel_centers(W, H), rows(strata)
    o, d = renderer.camera_rays_table_plain(s.camera, px0, table, n)
    oo, dd = zip(*(renderer.camera_rays_table_plain(s.camera, px0, table[j:j + 1], n)
                   for j in range(S)))
    assert o.shape == d.shape == (S * W * H, 3)
    assert bits_equal(o, torch.cat(oo)) and bits_equal(d, torch.cat(dd))
    lo, ld = renderer.launch_rays_table(s, px0, table, n)
    assert bits_equal(lo, o) and bits_equal(ld, d)


@pytest.mark.parametrize("name", ["demo-box", "dof"])
@pytest.mark.parametrize("S", [1, 3, 16])
def test_launch_rays_match_jax_camera_stage(name, S):
    """launch_words' R2 rows + launch_rays_table (keys to rays) against the
    JAX package's camera stage of _trace_stratum; keys
    fold_in(PRNGKey(seed), j) from numpy seeds, the cells out of order, the
    image's B pixels and a ragged prefix of them."""
    s = scene(name)
    js = jax_compile(jax_load(str(REPO / "scenes" / f"{name}.urn"), ["/res", f"{W}x{H}"]))
    n = 4
    strata = random.Random(S).sample(range(n * n), S)
    for seed, B in zip(np.random.default_rng(13).integers(0, 2**31, size=2).tolist(),
                       (W * H, 37)):
        px0, jpx0 = renderer.pixel_centers(W, H)[:B], jax_pixel_centers(W, H)[:B]
        o, d = renderer.launch_rays_table(s, px0, rows(strata, seed), n)
        jo, jd = jax_camera_stage(js, jpx0, seed, strata, n)
        assert o.shape == d.shape == (S * B, 3)
        np.testing.assert_allclose(o.numpy(), jo, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [W * H, 1, 37])
def test_plain_jitter_equals_jax_uniform(B):
    """The twin's jitter words: a launch's R2 rows hold each stratum's
    split(fold_in(PRNGKey(seed), j), 3)[:2] as JAX derives them, and the
    uniforms of their key words (uniform_block_words, what the twin draws)
    are jax.random.uniform(k_px, (B, 2)) and jax.random.uniform(k_lens,
    (B, 2)), bit for bit."""
    table = rows([0, 1, 2], seed=11)
    for j in range(3):
        k_px, k_lens, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(11), j), 3)
        for cols, key in ((slice(1, 3), k_px), (slice(3, 5), k_lens)):
            words = table[j:j + 1, cols].contiguous()
            assert (words.numpy().view(np.uint32) == np.asarray(key)).all()
            got = rng.uniform_block_words(words, 2 * B).reshape(B, 2)
            want = np.asarray(jax.random.uniform(key, (B, 2)))
            np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_launch_rays_refuses_other_devices():
    s = scene("demo-box")
    with pytest.raises(ValueError, match="no camera rays for device meta"):
        renderer.launch_rays_table(s, renderer.pixel_centers(W, H).to("meta"), rows([0]), 2)


class RecordingLibrary(FakeLibrary):
    """The fake library, also keeping each R1 and R2 call's arguments."""

    def __init__(self, cards):
        super().__init__(cards)
        self.args = {"plu_threefry_uniform": [], "plu_camera_rays_table": []}

    def __getattr__(self, name):
        call = super().__getattr__(name)

        def recorded(*args):
            if name in self.args:
                self.args[name].append(args)
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
    with HostAsCard() as mode:
        lib.copies = mode.copies
        yield cards, lib


def no_eager_camera(*_args, **_kw):
    raise AssertionError("an eager camera op ran on a card launch")


def the_copied_words(lib, k):
    """The buffer of the k-th copy from pinned memory: (its words, where it
    lies)."""
    dst, src, non_blocking = lib.copies[k]
    assert non_blocking and torch.equal(dst, src.as_subclass(torch.Tensor))
    return dst.as_subclass(torch.Tensor), dst.data_ptr()


@pytest.mark.parametrize("pairs", [[(s, s) for s in range(20)],
                                   [(j, s) for j, s in enumerate([5, 1, 3])]], ids=str)
def test_stratum_launches_one_r2_call_a_launch(card_env, monkeypatch, pairs):
    """On tensors that report a card, stratum_launches makes one copy of
    the launch's words from pinned memory, then one R1 call (the path
    uniforms) and one R2 call a launch, inside build.on_device with the
    tensors' card current, each reading its part of that buffer (R2: each
    stratum's cell and split_words of its key), no eager camera op and no
    jitter drawn; the rays R2 wrote go to the path kernel."""
    cards, lib = card_env
    s = scene("demo-box").to(CARD)
    px0 = renderer.pixel_centers(W, H).to(CARD)
    for name in ("generate_rays", "camera_rays_table_plain"):
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
    assert len(out) == len(seen) == len(lib.copies) == launches
    assert [name for name, _, _ in lib.calls] == (
        ["plu_threefry_uniform", "plu_camera_rays_table"] * launches)
    assert all(current == CARD for _, current, _ in lib.calls) and cards.stack == [OTHER]
    assert after[0] - before[0] == launches
    assert after[1] - before[1] == 2 * launches
    base, mb = rng.key_words(rng.PRNGKey(0)), DEFAULT_OPTIONS.max_bounces
    for i, args in enumerate(lib.args["plu_camera_rays_table"]):
        group = pairs[i * per:(i + 1) * per]
        S = len(group)
        words, at = the_copied_words(lib, i)
        assert words.numpy().tolist() == renderer.launch_words(
            [rng.fold_in_words(base, j) for j, _ in group], [st for _, st in group], mb).tolist()
        assert lib.args["plu_threefry_uniform"][i][:2] == (at, S * mb)
        assert args[2] == at + 4 * 2 * S * mb and args[3:6] == (S, W * H, 5)
        r2_rows = words[2 * S * mb:].view(S, 5)
        assert r2_rows[:, 0].tolist() == [st for _, st in group]
        keys = [w for j, _ in group
                for k in rng.split_words(rng.fold_in_words(base, j), 3)[:2] for w in k]
        assert (r2_rows[:, 1:].numpy().view(np.uint32).reshape(-1) == keys).all()
        o, d = seen[i]
        assert (o.data_ptr(), d.data_ptr()) == (args[6], args[7])  # R2's rays, not copies
        assert o.shape == d.shape == (S * W * H, 3)


def test_pass_loop_launch_one_pinned_copy(card_env):
    """A pass-loop launch on a card (render_passes, 3 strata in one launch)
    makes exactly one host-to-device copy, non-blocking from pinned
    memory, of its launch_words block; R1 reads a (3 * max_bounces, 2)
    view at its start and R2 a (3, 5) view of the rest."""
    _, lib = card_env
    s = scene("demo-box").to(CARD)
    mb = DEFAULT_OPTIONS.max_bounces
    renderer.render_passes(s, rng.PRNGKey(2), 0, W, H, 2, 3)
    assert len(lib.copies) == 1
    words, at = the_copied_words(lib, 0)
    base = rng.key_words(rng.PRNGKey(2))
    want = renderer.launch_words([rng.fold_in_words(base, j) for j in range(3)], [0, 1, 2], mb)
    assert words.shape == (2 * 3 * mb + 3 * 5,) and words.numpy().tolist() == want.tolist()
    (r1,), (r2,) = lib.args["plu_threefry_uniform"], lib.args["plu_camera_rays_table"]
    assert r1[:2] == (at, 3 * mb) and r2[2:4] == (at + 4 * 2 * 3 * mb, 3)


def test_stratum_rays_one_r2_call(card_env, monkeypatch):
    """_stratum_rays (render_pass's and term_dump's rays) on a card: one R1
    and one R2 call of one stratum reading its words, no eager camera
    op."""
    _, lib = card_env
    s = scene("dof").to(CARD)
    monkeypatch.setattr(renderer, "generate_rays", no_eager_camera)
    o, d, u = renderer._stratum_rays(s, renderer.pixel_centers(W, H).to(CARD), rng.PRNGKey(1), 6,
                                     3, DEFAULT_OPTIONS)
    assert [name for name, _, _ in lib.calls] == ["plu_threefry_uniform", "plu_camera_rays_table"]
    words, at = the_copied_words(lib, 0)
    args, mb = lib.args["plu_camera_rays_table"][-1], DEFAULT_OPTIONS.max_bounces
    k_px, k_lens, _ = rng.split_words(rng.key_words(rng.PRNGKey(1)), 3)
    assert args[2] == at + 4 * 2 * mb and args[3:6] == (1, W * H, 3)
    assert words[2 * mb:].numpy().view(np.uint32).tolist() == [6, *k_px, *k_lens]
    assert o.shape == d.shape == (W * H, 3) and u.shape == (mb, W * H, 12)


@pytest.mark.parametrize("name", ["demo-box", "dof"])
@pytest.mark.parametrize("S,order", [(1, "in order"), (4, "shuffled"), (16, "shuffled")])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_table_plain_equals_camera_rays_plain(name, S, order, seed):
    """R2's plain twin (camera_rays_table_plain: the cells and key words
    read from a tensor, as the kernel reads them on the card) against the
    JAX package's camera stage of the same keys and cells (key words at
    and past 2**31 included); launch_rays_table on the CPU is the twin."""
    s, n = scene(name), 5
    js = jax_compile(jax_load(str(REPO / "scenes" / f"{name}.urn"), ["/res", f"{W}x{H}"]))
    strata = list(range(S)) if order == "in order" else random.Random(S).sample(range(n * n), S)
    px0, table = renderer.pixel_centers(W, H), rows(strata, seed)
    o, d = renderer.camera_rays_table_plain(s.camera, px0, table, n)
    jo, jd = jax_camera_stage(js, jax_pixel_centers(W, H), seed, strata, n)
    np.testing.assert_allclose(o.numpy(), jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-6)
    lo, ld = renderer.launch_rays_table(s, px0, table, n)
    assert bits_equal(lo, o) and bits_equal(ld, d)


def test_r2_table_wrapper_checks(card_env):
    """R2's wrapper refuses CPU tensors, a table of another shape or dtype,
    or on another card, a launch of more than 16 strata and pixel
    positions of another type, before any launch; a sound call is one
    launch of plu_camera_rays_table with the table's pointer."""
    _, lib = card_env
    s = scene("dof")
    px0, table = renderer.pixel_centers(W, H), rows([0, 3])
    run = camera_kernel.camera_rays_table_cuda
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        run(s.camera, px0, table, 2)
    cs, cpx, ct = s.to(CARD), px0.to(CARD), table.to(CARD)
    with pytest.raises(ValueError, match=r"must be \(S, 5\)"):
        run(cs.camera, cpx, ct[:, :4].contiguous(), 2)
    with pytest.raises(ValueError, match="contiguous int32"):
        run(cs.camera, cpx, ct.to(torch.int64), 2)
    with pytest.raises(ValueError, match="1 to 16 strata"):
        run(cs.camera, cpx, ct.repeat(9, 1), 5)
    with pytest.raises(ValueError, match="px0 must be a contiguous float32"):
        run(cs.camera, cpx.double(), ct, 2)
    assert lib.calls == []
    o, d = run(cs.camera, cpx, ct, 2)
    assert [name for name, _, _ in lib.calls] == ["plu_camera_rays_table"]
    assert lib.args["plu_camera_rays_table"][0][2] == ct.data_ptr()
    assert o.shape == d.shape == (2 * W * H, 3)


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
