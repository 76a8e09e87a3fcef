"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file
imports no jax (the machine with the card has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances: K1 exact (winners and t bit for bit: the kernel and its plain
version perform the same IEEE float32 operations, built without FMA
contraction). K2 against the plain ray_color with the same uniforms:
tests/test_megakernel.py's knife-edge bound (at most 2% of lanes with
|log1p(a) - log1p(b)| > 1e-3, log1p means within 0.02). Renders against
the goldens: tests/test_golden.py's bounds, with the p99 allowance for
mesh0 stated at that test.
"""

import pathlib

import numpy as np
import pytest
import torch

from plutracer_tpu.io.bmp import read_bmp
from plutracer_tpu.semantics import DEFAULT_OPTIONS, TEXTBOOK_OPTIONS
from plutracer_tpu_torch import cli, rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_cuda, ray_color_kernel
from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
    closest_hit,
    closest_hit_cuda,
    closest_hit_plain,
)
from plutracer_tpu_torch.render.integrator import draw_uniforms, ray_color
from plutracer_tpu_torch.render.renderer import pixel_centers, render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file

REPO = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene_and_rays(name, res, dev):
    s = compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"),
                                      ["/res", f"{res}x{res}"]), device=dev)
    g = torch.Generator(device="cpu").manual_seed(res)
    px = pixel_centers(res, res, dev) + torch.rand((res * res, 2), generator=g).to(dev)
    o, d = generate_rays(s.camera, px, torch.rand((res * res, 2), generator=g).to(dev))
    return s, o, d


@pytest.mark.parametrize("name", ["demo-box", "dof", "sphere-grid", "mesh0"])
def test_k1_bit_equal_to_plain(dev, name):
    """Camera rays and random rays from inside the scene; mesh0's table
    (1296 rows) spans several shared-memory tiles."""
    s, o, d = scene_and_rays(name, 64, dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    lo, hi = s.prim_a.min(0).values - 1.0, s.prim_b.max(0).values + 1.0
    o2 = lo + (hi - lo) * torch.rand((4096, 3), generator=g).to(dev)
    d2 = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g).to(dev), dim=-1)
    for ro, rd in ((o, d), (o2, d2)):
        before = closest_hit_cuda.launches
        f, p, t = closest_hit(s.prims_packed, ro, rd)
        assert closest_hit_cuda.launches == before + 1
        pf, pp, pt = closest_hit_plain(s.prims_packed, ro, rd)
        assert f.float().mean() > 0.1
        assert torch.equal(f, pf) and torch.equal(p, pp) and torch.equal(t, pt)


@pytest.mark.parametrize("name", ["demo-box", "dof", "textured0"])
@pytest.mark.parametrize("options", [DEFAULT_OPTIONS, TEXTBOOK_OPTIONS], ids=["reference", "textbook"])
def test_k2_matches_plain(dev, name, options):
    s, o, d = scene_and_rays(name, 96, dev)
    u = draw_uniforms(rng.PRNGKey(5), o.shape[0], options.max_bounces, dev)
    before = ray_color_cuda.launches
    out = ray_color_kernel(s, o, d, u, options)
    assert ray_color_cuda.launches == before + 1
    ref = ray_color(s, o, d, u, options)
    assert torch.isfinite(out).all()
    a, b = torch.log1p(out.clamp(min=0.0)), torch.log1p(ref.clamp(min=0.0))
    assert ((a - b).abs() > 1e-3).float().mean().item() <= 0.02
    assert abs(a.mean().item() - b.mean().item()) <= 0.02


def test_uniforms_on_card_equal_cpu(dev):
    key = rng.fold_in(rng.PRNGKey(42), 17)
    assert torch.equal(draw_uniforms(key, 4097, 8, dev).cpu(), draw_uniforms(key, 4097, 8, "cpu"))


# p99 bound per scene: tests/test_golden.py's 0.05, except mesh0. A ray
# leaving a triangle starts ON it (zero origin offset, as the reference
# traces), so its own-triangle t is rounding noise around 0 and the
# self-hit is a coin flip that XLA's FMA-contracted arithmetic (which made
# the goldens) and unfused float32 decide differently on 1-1.5% of rays.
# Measured for the port's plain path on the CPU, mesh0 64x48 N=2 seed 42:
# p99 0.0667, mean 0.0042 against the golden (ROADMAP, faults).
@pytest.mark.parametrize("name,p99_bound", [("demo-box", 0.05), ("textured0", 0.05),
                                            ("sphere-grid", 0.05), ("mesh0", 0.1)])
def test_render_golden_on_card(dev, name, p99_bound):
    """K1 + K2 (demo-box, textured0) and the plain integrator with K1
    answering its queries (sphere-grid, mesh0: P > 64)."""
    s = compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"), ["/res", "64x48"]),
                      device=dev)
    img = render(s, 64, 48, 2, rng.PRNGKey(42)).cpu().numpy()
    golden = np.load(REPO / "tests" / "goldens" / f"repo-{name}.npz")["linear"].astype(np.float32)
    assert img.shape == golden.shape and np.isfinite(img).all()
    diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(golden, 0.0)))
    assert np.quantile(diff, 0.99) < p99_bound and diff.mean() < 0.01, (
        f"{name}: p99 {np.quantile(diff, 0.99)} mean {diff.mean()}")


def test_cli_on_card(dev, tmp_path):
    out = tmp_path / "out.bmp"
    before = ray_color_cuda.launches
    res = cli.run([str(REPO / "scenes" / "demo-box.urn"), "/res", "64x48", "/smp", "2",
                   "/o", str(out), "/seed", "1"])
    assert res.integrator == "kernel" and ray_color_cuda.launches == before + 4
    assert torch.isfinite(res.linear).all()
    assert read_bmp(str(out)).shape == (48, 64, 3)
