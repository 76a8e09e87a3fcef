"""The port's plain integrator (ray_color_plain fed explicit uniforms) against the
JAX integrator, and the K2 wrapper and backend routing.

The uniforms come from the port's rng and are first asserted equal to the
JAX draws, so both packages make the same sampling decisions. Bounds are
those of tests/test_megakernel.py (there: Pallas megakernel vs XLA): per
lane |log1p(a) - log1p(b)| > 1e-3 on at most 2% of lanes (float32
reassociation flips isolated knife-edge lanes, e.g. a refracted ray's near
root at 0), and log1p means within 0.02. K2 itself is held to the plain
ray_color_plain on a card in tests/test_torch_cuda.py.

Both packages' render.ray_color(scene, o, d, key[, options, terms]) take
the same positional arguments (the key from each package's PRNGKey of
one seed): the same bounds, and on the CPU the port's is ray_color_plain
on draw_uniforms(key)'s uniforms bit for bit. mesh0 takes 3% of lanes,
tests/test_torch_stream.py's allowance for it (the triangle self-hit
knife edge, which XLA's FMA-contracted arithmetic and unfused float32
decide differently): measured 2.55% at 24x24, key 7.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from plutracer_tpu import render as jax_render_pkg
from plutracer_tpu.ops.camera import generate_rays as jax_generate_rays
from plutracer_tpu.ops.pallas.integrator_kernel import ray_color_pallas
from plutracer_tpu.render.integrator import ray_color as jax_ray_color
from plutracer_tpu.render.renderer import pixel_centers as jax_pixel_centers
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu.semantics import DEFAULT_OPTIONS as JAX_OPTIONS
from plutracer_tpu_torch import render as render_pkg
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_cuda, ray_color_kernel
from plutracer_tpu_torch.render.integrator import (
    draw_uniforms,
    kernel_tier,
    megakernel_eligible,
    ray_color_plain,
    resolve_integrator_backend,
)
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

XLA = JAX_OPTIONS.replace(integrator_backend="xla")
SCENES = ["demo-box", "dof", "textured0"]


def setup(name, res, seed=7):
    """Both scenes, jittered camera rays (numpy) and the JAX key."""
    args = ["/res", f"{res}x{res}"]
    js = jax_compile(jax_load(f"scenes/{name}.urn", args))
    ts = compile_scene(load_scene_file(f"scenes/{name}.urn", args), device="cpu")
    px0 = jax_pixel_centers(res, res)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    o, d = jax_generate_rays(js.camera, px0 + jax.random.uniform(k1, px0.shape),
                             jax.random.uniform(k2, px0.shape))
    return js, ts, np.asarray(o), np.asarray(d), seed


def assert_knife_edge_close(out, ref, name, allowance=0.02):
    assert np.isfinite(out).all()
    a = np.log1p(np.maximum(out, 0.0))
    b = np.log1p(np.maximum(ref, 0.0))
    diff = np.abs(a - b)
    assert (diff > 1e-3).mean() <= allowance, (
        f"{name}: {(diff > 1e-3).mean():.2%} lanes differ > 1e-3; max={diff.max():.2e}")
    assert abs(a.mean() - b.mean()) <= 0.02, f"{name}: log1p mean {a.mean():.4f} vs {b.mean():.4f}"


def port_uniforms(js_key_seed, B):
    """The port's draws for one batch, asserted bit-equal to the JAX draws."""
    u = draw_uniforms(rng.PRNGKey(js_key_seed), B, DEFAULT_OPTIONS.max_bounces, "cpu")
    key = jax.random.PRNGKey(js_key_seed)
    want = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (B, 12)))
                     for i in range(DEFAULT_OPTIONS.max_bounces)])
    np.testing.assert_array_equal(u.numpy(), want)
    return u


@pytest.mark.parametrize("name", SCENES)
def test_plain_matches_jax_xla(name):
    js, ts, o, d, seed = setup(name, 32)
    u = port_uniforms(seed, o.shape[0])
    ref = np.asarray(jax_ray_color(js, o, d, jax.random.PRNGKey(seed), XLA))
    out = ray_color_plain(ts, torch.from_numpy(o), torch.from_numpy(d), u, DEFAULT_OPTIONS).numpy()
    assert_knife_edge_close(out, ref, name)


@pytest.mark.parametrize("name,allowance", [("demo-box", 0.02), ("mesh0", 0.03)])
def test_ray_color_takes_jax_call(name, allowance):
    """render.ray_color(scene, o, d, key) of both packages, the same
    positional arguments: within the bounds above, and the port's equal to
    ray_color_plain on the key's uniforms."""
    js, ts, o, d, seed = setup(name, 24)
    ref = np.asarray(jax_render_pkg.ray_color(js, o, d, jax.random.PRNGKey(seed)))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    out = render_pkg.ray_color(ts, to, td, rng.PRNGKey(seed))
    assert_knife_edge_close(out.numpy(), ref, name, allowance)
    u = draw_uniforms(rng.PRNGKey(seed), o.shape[0], DEFAULT_OPTIONS.max_bounces, "cpu")
    assert torch.equal(out, ray_color_plain(ts, to, td, u, DEFAULT_OPTIONS))


def test_ray_color_terms_take_jax_call():
    """ray_color(scene, o, d, key, options, True) of both packages on
    demo-box: the radiance and each (bounce, site) term within the bounds
    above."""
    js, ts, o, d, seed = setup("demo-box", 24)
    ref_L, ref_terms = jax_render_pkg.ray_color(js, o, d, jax.random.PRNGKey(seed),
                                                JAX_OPTIONS, True)
    L, terms = render_pkg.ray_color(ts, torch.from_numpy(o), torch.from_numpy(d),
                                    rng.PRNGKey(seed), DEFAULT_OPTIONS, True)
    assert terms.shape == ref_terms.shape == (DEFAULT_OPTIONS.max_bounces, 3, o.shape[0], 3)
    assert_knife_edge_close(L.numpy(), np.asarray(ref_L), "demo-box terms=True radiance")
    for site in range(3):
        assert_knife_edge_close(terms[:, site].numpy(), np.asarray(ref_terms)[:, site],
                                f"demo-box term {site}")


@pytest.mark.parametrize("name", SCENES)
def test_plain_matches_jax_pallas_interpret(name):
    js, ts, o, d, seed = setup(name, 16)
    u = port_uniforms(seed, o.shape[0])
    ref = np.asarray(ray_color_pallas(js, o, d, jax.random.PRNGKey(seed), JAX_OPTIONS,
                                      interpret=True))
    # the K2 wrapper on CPU tensors is its plain version
    out = ray_color_kernel(ts, torch.from_numpy(o), torch.from_numpy(d), u, DEFAULT_OPTIONS).numpy()
    assert_knife_edge_close(out, ref, name)


@pytest.mark.parametrize("quirks", ["textbook", "reference"])
def test_plain_matches_jax_quirk_switches(quirks):
    """The MIS, pdf and emission-gate switches, flipped together."""
    flip = quirks == "textbook"
    quirks = dict(swapped_light_mis_weight=not flip, origin_distance_pdf=not flip,
                  shading_normal_le_gate=not flip)
    opts = DEFAULT_OPTIONS.replace(**quirks)
    js, ts, o, d, seed = setup("demo-box", 24, seed=3)
    u = draw_uniforms(rng.PRNGKey(seed), o.shape[0], opts.max_bounces, "cpu")
    ref = np.asarray(jax_ray_color(js, o, d, jax.random.PRNGKey(seed),
                                   XLA.replace(**quirks)))
    out = ray_color_plain(ts, torch.from_numpy(o), torch.from_numpy(d), u, opts).numpy()
    assert_knife_edge_close(out, ref, quirks)


def test_backend_routing():
    demo = compile_scene(load_scene_file("scenes/demo-box.urn", ["/res", "8x8"]), device="cpu")
    grid = compile_scene(load_scene_file("scenes/sphere-grid.urn", ["/res", "8x8"]), device="cpu")
    assert megakernel_eligible(demo, DEFAULT_OPTIONS)
    assert megakernel_eligible(grid, DEFAULT_OPTIONS)  # P = 122 > 64: the stream tier
    assert kernel_tier(demo, DEFAULT_OPTIONS) == "k2"
    assert kernel_tier(grid, DEFAULT_OPTIONS) == "k3"
    assert kernel_tier(grid, DEFAULT_OPTIONS.replace(stream_wavefront=True)) == "k4"
    assert resolve_integrator_backend(demo, DEFAULT_OPTIONS, "cuda") == "kernel"
    assert resolve_integrator_backend(grid, DEFAULT_OPTIONS, "cuda") == "kernel"
    assert resolve_integrator_backend(demo, DEFAULT_OPTIONS, "cpu") == "plain"
    forced = DEFAULT_OPTIONS.replace(integrator_backend="kernel")
    assert resolve_integrator_backend(demo, forced, "cpu") == "kernel"
    # an atlas past the JAX package's 4,096-texel VMEM cap: the kernels
    # read the atlas from device memory, so it takes the kernel path
    big_atlas = dataclasses.replace(grid, atlas=torch.zeros((4096 + 1, 3)))
    assert megakernel_eligible(big_atlas, DEFAULT_OPTIONS)
    assert resolve_integrator_backend(big_atlas, DEFAULT_OPTIONS, "cuda") == "kernel"
    # beyond a gate that still stands: the kernels take float32 only
    f64 = DEFAULT_OPTIONS.replace(dtype="float64")
    assert not megakernel_eligible(demo, f64)
    assert resolve_integrator_backend(demo, f64, "cuda") == "plain"
    with pytest.raises(ValueError, match="do not take"):
        resolve_integrator_backend(demo, f64.replace(integrator_backend="kernel"), "cuda")
    with pytest.raises(ValueError):
        resolve_integrator_backend(demo, DEFAULT_OPTIONS.replace(integrator_backend="xla"), "cpu")


def test_cuda_launcher_rejects_cpu_and_grad():
    s = compile_scene(load_scene_file("scenes/demo-box.urn", ["/res", "4x4"]), device="cpu")
    o = torch.zeros((16, 3))
    d = torch.ones((16, 3))
    u = torch.rand((DEFAULT_OPTIONS.max_bounces, 16, 12))
    with pytest.raises(ValueError, match="CUDA"):
        ray_color_cuda(s, o, d, u, DEFAULT_OPTIONS)
    with pytest.raises(NotImplementedError):
        ray_color_cuda(s, o.requires_grad_(), d, u, DEFAULT_OPTIONS)
