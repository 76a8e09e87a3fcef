"""The port's wavefront loop (render/wavefront.py) against the plain
ray_color_plain, a host loop and the JAX package: bit-equality under every
reorder, the Morton and sort keys, every ray written once, and the K3/K4
launchers' refusals on the CPU. Split from tests/test_torch_stream.py,
whose helpers it uses.

Bounds:
- the wavefront loop over plain_bounce vs ray_color_plain: bit-equal
  (the same per-ray operations, only the row order differs);
- the Morton key vs JAX's _morton_key: bit-equal (integer work);
- the port's wavefront vs JAX's _ray_color_stream_wavefront: the
  knife-edge bound of tests/test_torch_stream.py (knife_edge_close).
"""

import jax
import numpy as np
import pytest
import torch

from plutracer_tpu.ops.pallas import integrator_kernel as jik
from plutracer_tpu.semantics import DEFAULT_OPTIONS as JAX_OPTIONS
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.ops.cuda.stream_kernel import onebounce_cuda, ray_color_stream_cuda
from plutracer_tpu_torch.ops.tables import pack_tables
from plutracer_tpu_torch.render.integrator import (
    draw_uniforms,
    kernel_tier,
    ray_color,
    ray_color_plain,
)
from plutracer_tpu_torch.render.renderer import pixel_centers
from plutracer_tpu_torch.render.wavefront import (
    SORTS,
    Wave,
    carry_of,
    morton_key,
    ray_color_wavefront,
    scene_bounds,
    sort_keys,
    state_of,
)
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from test_torch_stream import KEY, WAVEFRONT_BOUNCES, knife_edge_close, setup
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)


@pytest.mark.parametrize("sort", SORTS)
def test_wavefront_bit_equal_to_ray_color(sort):
    s = compile_scene(load_scene_file("scenes/mesh0.urn", ["/res", "16x16"]), device="cpu")
    g = torch.Generator().manual_seed(3)
    px = pixel_centers(16, 16) + torch.rand((256, 2), generator=g)
    o, d = generate_rays(s.camera, px, torch.rand((256, 2), generator=g))
    u = draw_uniforms(rng.PRNGKey(KEY), 256, DEFAULT_OPTIONS.max_bounces, "cpu")
    ref = ray_color_plain(s, o, d, u, DEFAULT_OPTIONS)
    assert (ref > 0).any(-1).float().mean() > 0.1
    opts = DEFAULT_OPTIONS.replace(stream_wavefront=True, stream_sort=sort)
    assert kernel_tier(s, opts) == "k4"
    out = ray_color_wavefront(s, o, d, u, opts)
    assert torch.equal(out, ref), f"{(out != ref).any(-1).sum().item()} lanes differ"


def test_morton_key_bit_equal_to_jax():
    r = np.random.default_rng(5)
    p = r.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    lo = np.array([-2.0, -1.5, -2.5], np.float32)
    hi = np.array([2.0, 1.0, 2.5], np.float32)
    p[:4] = [lo, hi, lo - 1.0, hi + 1.0]  # box corners and clipping
    want = np.asarray(jik._morton_key(p, lo, hi))
    got = morton_key(torch.from_numpy(p), torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wavefront_matches_jax_wavefront():
    js, ts, o, d = setup("sphere-grid")
    o, d = o.copy(), d.copy()
    kw = dict(stream_wavefront=True, stream_sort="morton", max_bounces=WAVEFRONT_BOUNCES)
    opts = DEFAULT_OPTIONS.replace(**kw)
    ref = np.asarray(jik.ray_color_pallas(js, o, d, jax.random.PRNGKey(KEY), JAX_OPTIONS.replace(**kw),
                                          interpret=True))
    out = ray_color(ts, torch.from_numpy(o), torch.from_numpy(d), rng.PRNGKey(KEY),
                   opts.replace(integrator_backend="kernel")).numpy()
    knife_edge_close(out, ref, "sphere-grid wavefront")


def test_stream_launchers_reject_cpu_and_grad():
    s = compile_scene(load_scene_file("scenes/sphere-grid.urn", ["/res", "4x4"]), device="cpu")
    o = torch.zeros((16, 3))
    d = torch.ones((16, 3))
    u = torch.rand((DEFAULT_OPTIONS.max_bounces, 16, 12))
    wave = Wave.start(s, o, d, u, "morton", DEFAULT_OPTIONS.max_bounces)
    tables = pack_tables(s)
    with pytest.raises(ValueError, match="CUDA"):
        ray_color_stream_cuda(s, o, d, u, DEFAULT_OPTIONS)
    with pytest.raises(ValueError, match="CUDA"):
        onebounce_cuda(s, tables, wave, 0, None, DEFAULT_OPTIONS)
    with pytest.raises(ValueError, match="permutation"):
        onebounce_cuda(s, tables, wave, 1, None, DEFAULT_OPTIONS)
    with pytest.raises(NotImplementedError):
        ray_color_stream_cuda(s, o.requires_grad_(), d, u, DEFAULT_OPTIONS)
    wave.carry.requires_grad_()
    with pytest.raises(NotImplementedError):
        onebounce_cuda(s, tables, wave, 0, None, DEFAULT_OPTIONS)
    assert ray_color_stream_cuda.launches == 0 and onebounce_cuda.launches == 0


def wavefront_inputs(name="mesh0", res=16, seed=3):
    s = compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", f"{res}x{res}"]), device="cpu")
    g = torch.Generator().manual_seed(seed)
    n = res * res
    px = pixel_centers(res, res) + torch.rand((n, 2), generator=g)
    o, d = generate_rays(s.camera, px, torch.rand((n, 2), generator=g))
    return s, o, d, draw_uniforms(rng.PRNGKey(KEY), n, DEFAULT_OPTIONS.max_bounces, "cpu")


@pytest.mark.parametrize("sort", SORTS[1:])
def test_sort_keys_equal_jax_keys(sort):
    """The next bounce's keys (what K4 writes; the plain sort_keys) on a
    carry of live and dead lanes: morton, JAX's _morton_key of the origin;
    morton5, its octant bits ahead of that code >> 3; compact, 0 and 1;
    a dead lane (alive 0, or t >= T_MAX) 2^30 (compact 1)."""
    s, o, d, u = wavefront_inputs()
    r = np.random.default_rng(2)
    lo, hi = scene_bounds(s)
    B = o.shape[0]
    carry = carry_of(ray_color_state(s, o, d, u))
    carry[:, 0:3] = torch.from_numpy(r.uniform(-4.0, 4.0, (B, 3)).astype(np.float32))
    carry[:, 13] = torch.from_numpy((r.uniform(size=B) < 0.8).astype(np.float32))
    carry[::7, 15] = 2.0e5  # a missed extension: dead though alive
    live = (carry[:, 13] != 0) & (carry[:, 15] < 1.0e5)
    code = np.asarray(jik._morton_key(carry[:, 0:3].numpy(), lo.numpy(), hi.numpy()))
    oct_ = ((carry[:, 3:6] >= 0).numpy().astype(np.int32) * np.array([4, 2, 1])).sum(1)
    want = {"morton": code, "morton5": (oct_ << 27) | (code >> 3),
            "compact": np.zeros(B, np.int32)}[sort]
    want = np.where(live.numpy(), want, 1 if sort == "compact" else 2**30)
    got = sort_keys(carry, sort, lo, hi)
    assert got.dtype == torch.int32 and 0 < live.float().mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)


def ray_color_state(s, o, d, u):
    """The state after ray_color_plain's first vertex (a carry with live, dead
    and missed lanes)."""
    from plutracer_tpu_torch.ops.intersect import intersect_lite
    from plutracer_tpu_torch.render.integrator import PathState, plain_bounce

    B = o.shape[0]
    found, prim, t = intersect_lite(s, o, d)
    state = PathState(o, d, torch.ones_like(o), torch.zeros_like(o), torch.zeros(B, dtype=torch.bool),
                      torch.ones(B, dtype=torch.bool), prim, t)
    return plain_bounce(s, pack_tables(s), state, u[0], 0, DEFAULT_OPTIONS)


def host_loop(s, o, d, u, options):
    """The wavefront loop as the host ran it before the lane-major carry
    (the JAX package's _ray_color_stream_wavefront): a (B, 16) carry
    gathered through each permutation on the host, the uniforms gathered
    at the lanes' rays, and the radiance scattered back at the end."""
    from plutracer_tpu_torch.ops.intersect import intersect_lite
    from plutracer_tpu_torch.render.integrator import PathState, plain_bounce

    B = o.shape[0]
    found, prim, t = intersect_lite(s, o, d)
    carry = carry_of(PathState(o, d, torch.ones_like(o), torch.zeros_like(o),
                               torch.zeros(B, dtype=torch.bool), torch.ones(B, dtype=torch.bool),
                               prim, t))
    orig = torch.arange(B)
    lo, hi = scene_bounds(s)
    tables = pack_tables(s)
    for i in range(options.max_bounces):
        if i > 0 and options.stream_sort != "none":
            live = (carry[:, 13] != 0.0) & (carry[:, 15] < 1.0e5)
            if options.stream_sort == "compact":  # the cumsum partition
                li = live.long()
                pos = torch.where(live, torch.cumsum(li, 0) - 1, li.sum() + torch.cumsum(1 - li, 0) - 1)
                perm = torch.empty(B, dtype=torch.long).scatter_(0, pos, torch.arange(B))
            else:
                perm = torch.argsort(sort_keys(carry, options.stream_sort, lo, hi), stable=True)
            carry, orig = carry[perm], orig[perm]
        carry = carry_of(plain_bounce(s, tables, state_of(carry), u[i][orig], i, options))
    L = torch.empty((B, 3))
    L[orig] = carry[:, 9:12]
    return L


@pytest.mark.parametrize("sort", SORTS)
def test_radiance_at_its_ray_equals_the_host_scatter(sort):
    """Radiance written at each ray's index when its path ends equals the
    host loop's gathers and final scatter, bit for bit."""
    s, o, d, u = wavefront_inputs(seed=5)
    opts = DEFAULT_OPTIONS.replace(stream_wavefront=True, stream_sort=sort)
    assert torch.equal(ray_color_wavefront(s, o, d, u, opts), host_loop(s, o, d, u, opts))


@pytest.mark.parametrize("sort", ["none", "morton"])
def test_wavefront_writes_every_ray_once(sort):
    """Rays far outside the scene pointing away all miss at bounce 0, and
    camera rays end over several launches: the radiance starts NaN and
    every ray is written; the launches end exactly B rays."""
    s, o, d, u = wavefront_inputs(res=8)
    mb = DEFAULT_OPTIONS.max_bounces
    opts = DEFAULT_OPTIONS.replace(stream_wavefront=True, stream_sort=sort)
    for rays, all_dead in (((o - 1.0e6 * d, -d), True), ((o, d), False)):
        out = torch.full_like(o, float("nan"))
        waves = []
        got = ray_color_wavefront(s, *rays, u, opts, out=out, wave_out=waves)
        counts = waves[0].counts
        assert got is out and not torch.isnan(out).any()
        assert int(counts[mb:].sum()) == o.shape[0]
        if all_dead:
            assert int(counts[0]) == 0 and int(counts[mb]) == o.shape[0]
            assert torch.equal(out, torch.zeros_like(out))
        else:
            assert torch.equal(out, ray_color_plain(s, o, d, u, DEFAULT_OPTIONS))
