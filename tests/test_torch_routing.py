"""The port's routing layer against the JAX package: which engine answers
a closest-hit query (ops/intersect.query_lite by
options.intersect_backend) and which engine runs a path
(render/integrator.megakernel_eligible, kernel_tier).

Tolerances:
- winners (found, prim) of the three backends ("pallas": K1's plain
  version, "bvh": the walk's plain version, "xla": intersect_lite) equal on
  every ray, and equal to the JAX package's query_lite under "xla" and
  "bvh" on the same numpy rays; t bit-equal across the port's backends on
  every hit (K1's and the walk's row tests are one arithmetic, and
  intersect_lite's is the same on these scenes), and within 1e-4 relative
  of JAX's, the allowance tests/test_torch_bvh.py states for XLA's
  FMA-contracted sphere root;
- plain radiance under the three backends bit-equal on the CPU: the
  winners are equal, and "pallas" and "bvh" recompute t at the winner with
  intersect_lite's own per-primitive test;
- the gradient under "bvh" (and "pallas") bit-equal to the one under
  "xla" (tests/test_torch_grad.py holds that one against jax.grad);
- the 256x256 atlas fetch bit-equal to the JAX package's (nearest texel,
  the same float32 operations);
- the plain render of the scenes past the TPU caps against the JAX
  package's goldens: tests/test_golden.py's bounds.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plutracer_tpu.ops import intersect as jax_intersect
from plutracer_tpu.ops import tables as jax_tables
from plutracer_tpu.ops import texture as jax_texture
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu.semantics import DEFAULT_OPTIONS as JAX_OPTIONS
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.io.bmp import read_bmp
from plutracer_tpu_torch.ops import intersect, tables, texture
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.parallel.sharded import apply_params, get_params
from plutracer_tpu_torch.render.integrator import (
    K2_SMEM_MAX,
    MAX_P,
    draw_uniforms,
    k2_smem_bytes,
    kernel_tier,
    megakernel_eligible,
    ray_color_plain,
    resolve_integrator_backend,
)
from plutracer_tpu_torch.render.renderer import pixel_centers, render, render_pass
from plutracer_tpu_torch.scene import compile as compile_mod
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.compile import MAX_TABLE_ROWS
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from plutracer_tpu_torch.tools.swirl_texture import swirl
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

BACKENDS = ("pallas", "bvh", "xla")
QUERY_SCENES = ("demo-box", "sphere-grid", "mesh0")
# the tiers of the scenes in scenes/ as the JAX package routes them (P <=
# 64: K2, else K3), and of the scenes past its TPU caps: textured256 (a
# 65,536-texel atlas), tables (20 materials, 10 textures, 12 lights)
TIERS = {"demo-box": "k2", "dof": "k2", "textured0": "k2", "sphere-grid": "k3",
         "mesh0": "k3", "mesh1": "k3", "mesh2": "k3", "mesh-tex": "k3",
         "textured256": "k2", "tables": "k2"}


def opts(backend, **kw):
    return DEFAULT_OPTIONS.replace(intersect_backend=backend, **kw)


def load(name, res=16):
    return compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", f"{res}x{res}"]),
                         device="cpu")


def rays(s, res=16, seed=0):
    """Camera rays of a res x res image, and rays from inside the scene's
    root box with directions of random length (phantom sphere hits of
    non-unit rays; origins between surfaces)."""
    g = torch.Generator().manual_seed(seed)
    px = pixel_centers(res, res) + torch.rand((res * res, 2), generator=g)
    o, d = generate_rays(s.camera, px, torch.rand((res * res, 2), generator=g))
    r = np.random.default_rng(seed)
    lo, hi = s.bvh.node_min[0].numpy(), s.bvh.node_max[0].numpy()
    io = lo + (hi - lo) * r.uniform(size=(res * res, 3))
    idir = r.normal(size=(res * res, 3))
    idir *= r.uniform(0.5, 1.5, (res * res, 1)) / np.linalg.norm(idir, axis=-1, keepdims=True)
    return (torch.cat([o, torch.from_numpy(io.astype(np.float32))]),
            torch.cat([d, torch.from_numpy(idir.astype(np.float32))]))


@pytest.mark.parametrize("name", QUERY_SCENES)
def test_query_backends_agree(name):
    """The three backends on CPU rays: found and prim equal on every
    ray, t bit-equal on every hit, and t >= T_MAX on every miss."""
    s = load(name)
    o, d = rays(s)
    got = {b: intersect.query_lite(s, o, d, opts(b)) for b in BACKENDS}
    want = got["xla"]
    assert want[0].float().mean() > 0.2
    for b in ("pallas", "bvh"):
        f, p, t = got[b]
        assert torch.equal(f, want[0]), f"{b}: found differs on {(f != want[0]).sum()} rays"
        assert torch.equal(p, want[1]), f"{b}: prim differs on {(p != want[1]).sum()} rays"
        assert torch.equal(t[f], want[2][f]), b
        assert (t[~f] >= intersect.T_MAX).all(), b


@pytest.mark.parametrize("backend", ["xla", "bvh"])
@pytest.mark.parametrize("name", QUERY_SCENES)
def test_query_matches_jax(name, backend):
    """The port's query under each backend against the JAX package's
    query_lite under `backend` on the same numpy rays."""
    js = jax_compile(jax_load(f"scenes/{name}.urn", ["/res", "16x16"]))
    s = load(name)
    o, d = rays(s)
    query = jax.jit(lambda sc, o, d: jax_intersect.query_lite(
        sc, o, d, JAX_OPTIONS.replace(intersect_backend=backend)))
    jf, jp, jt = (np.asarray(x) for x in query(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy())))
    for ours in BACKENDS:
        f, p, t = (x.numpy() for x in intersect.query_lite(s, o, d, opts(ours)))
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(p[jf], jp[jf])
        np.testing.assert_allclose(t[jf], jt[jf], rtol=1e-4)


@pytest.mark.parametrize("name", ["sphere-grid", "mesh0"])
def test_plain_radiance_equal_across_backends(name):
    """Plain ray_color_plain at 16x12, one stratum, the same uniforms: bit-equal
    under the three backends."""
    s = compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", "16x12"]), device="cpu")
    g = torch.Generator().manual_seed(1)
    px = pixel_centers(16, 12) + torch.rand((192, 2), generator=g)
    o, d = generate_rays(s.camera, px, torch.rand((192, 2), generator=g))
    u = draw_uniforms(rng.PRNGKey(3), 192, DEFAULT_OPTIONS.max_bounces, "cpu")
    out = {b: ray_color_plain(s, o, d, u, opts(b)) for b in BACKENDS}
    assert (out["xla"] > 0).any(-1).float().mean() > 0.2
    for b in ("pallas", "bvh"):
        diff = (out[b] != out["xla"]).any(-1)
        assert not diff.any(), f"{b}: {int(diff.sum())} lanes differ from xla"


@pytest.mark.parametrize("backend", ["bvh", "pallas"])
def test_grad_through_kernel_backends(backend):
    """The port's test_grad_through_bvh_backend: the gradient of an
    image loss (one pass of demo-box 12x12, n = 2) under `backend` is
    finite, nonzero and equal to the one under "xla"."""
    s = load("demo-box", 12)

    def grads(b):
        params = {k: v.clone().requires_grad_() for k, v in get_params(s).items()}
        img = render_pass(apply_params(s, params), rng.PRNGKey(0), 1, 12, 12, 2, opts(b))
        loss = torch.sum(img * img) / img.numel()
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    got, want = grads(backend), grads("xla")
    assert any(g.abs().max() > 0 for g in got.values())
    for f in got:
        assert torch.isfinite(got[f]).all(), f
        assert torch.equal(got[f], want[f]), f"{f}: {(got[f] - want[f]).abs().max()}"


def cloud_shapes():
    """A shape-only stand-in for sphere_cloud(1_100_000) with one area
    light (compiling it takes tens of seconds; chip_smoke.py does)."""
    z = lambda *shape: torch.empty(shape)
    P = 1_100_000
    return types.SimpleNamespace(prim_type=z(P), mat_type=z(1), tex_type=z(1), light_type=z(2),
                                 atlas=z(1, 3), prims_packed=z(-(-P // 8) * 8, 24))


@pytest.mark.parametrize("name", [*TIERS, "sphere-cloud-1.1M"])
def test_routing_table(name):
    """Eligibility and tier: every scene in scenes/ keeps the JAX tier;
    the scenes past the TPU caps take the kernels (the atlas and tables
    scenes K2, the 2^20+ sphere cloud K3, K4 under stream_wavefront)."""
    s = cloud_shapes() if name.startswith("sphere-cloud") else load(name, 8)
    want = TIERS.get(name, "k3")
    assert megakernel_eligible(s, DEFAULT_OPTIONS)
    assert kernel_tier(s, DEFAULT_OPTIONS) == want
    assert kernel_tier(s, DEFAULT_OPTIONS.replace(stream_wavefront=True)) == \
        ("k2" if want == "k2" else "k4")
    if name == "textured256":
        assert s.atlas.shape[0] == 256 * 256
    if name == "tables":
        shape = (s.mat_type.shape[0], s.tex_type.shape[0], s.light_type.shape[0])
        assert shape == (20, 10, 12) and s.num_prims <= MAX_P
        assert k2_smem_bytes(s) <= K2_SMEM_MAX
    if not name.startswith("sphere-cloud"):
        assert resolve_integrator_backend(s, DEFAULT_OPTIONS, "cuda") == "kernel"
        assert resolve_integrator_backend(s, DEFAULT_OPTIONS, "cpu") == "plain"


@pytest.mark.parametrize("name", ["textured256", "tables"])
def test_beyond_cap_scene_matches_golden(name):
    """The port's plain render of each scene past the TPU caps against the
    JAX package's golden (tools/make_goldens.py: 64x48, n = 2, seed 42)
    within tests/test_golden.py's bounds (p99 of |log1p| < 0.05, mean <
    0.01; measured p99 2e-4 and 3e-4)."""
    golden = np.load(f"tests/goldens/repo-{name}.npz")["linear"].astype(np.float32)
    h, w = golden.shape[:2]
    s = compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", f"{w}x{h}"]), device="cpu")
    img = render(s, w, h, 2, rng.PRNGKey(42)).numpy()
    assert img.shape == golden.shape and np.isfinite(img).all()
    diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(golden, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01


@pytest.mark.parametrize("backend", ["cuda", "Pallas", "brute", ""])
def test_unknown_intersect_backend_raises(backend):
    """A name that is not one of the JAX package's four raises, in the
    query and in the integrator."""
    s = load("demo-box", 4)
    o, d = rays(s, 4)
    with pytest.raises(ValueError, match="intersect_backend"):
        intersect.query_lite(s, o, d, opts(backend))
    u = draw_uniforms(rng.PRNGKey(0), o.shape[0], DEFAULT_OPTIONS.max_bounces, "cpu")
    with pytest.raises(ValueError, match="intersect_backend"):
        ray_color_plain(s, o, d, u, opts(backend))


def gate_case(case):
    s = load("demo-box", 4)
    if case == "float64":
        return s, DEFAULT_OPTIONS.replace(dtype="float64"), False
    if case == "no packed table":
        return dataclasses.replace(s, prims_packed=None), DEFAULT_OPTIONS, False
    if case == "no light":
        return dataclasses.replace(s, light_type=s.light_type[:0]), DEFAULT_OPTIONS, False
    if case == "rows at the limit":
        return types.SimpleNamespace(**{**vars(cloud_shapes()),
                                        "prim_type": torch.empty(MAX_TABLE_ROWS)}), \
            DEFAULT_OPTIONS, True
    if case == "rows past the limit":
        return types.SimpleNamespace(**{**vars(cloud_shapes()),
                                        "prim_type": torch.empty(MAX_TABLE_ROWS + 1)}), \
            DEFAULT_OPTIONS, False
    if case == "atlas past the limit":
        return dataclasses.replace(s, atlas=torch.empty((MAX_TABLE_ROWS + 1, 3))), \
            DEFAULT_OPTIONS, False
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["float64", "no packed table", "no light", "rows at the limit",
                                  "rows past the limit", "atlas past the limit"])
def test_every_kept_gate_is_reached(case):
    """Each gate megakernel_eligible keeps refuses a scene (and the
    row limit takes one at its edge); a refused scene renders on the
    plain path, and a forced kernel path raises."""
    s, o, eligible = gate_case(case)
    assert megakernel_eligible(s, o) == eligible
    if not eligible:
        assert resolve_integrator_backend(s, o, "cuda") == "plain"
        with pytest.raises(ValueError, match="do not take"):
            resolve_integrator_backend(s, o.replace(integrator_backend="kernel"), "cuda")


@pytest.mark.parametrize("extra,want", [(0, "k2"), (1, "k3")])
def test_k2_shared_memory_budget(extra, want):
    """K2 takes a scene of P <= 64 while its tables fit K2_SMEM_MAX
    bytes of shared memory (the 48 KB a block takes without opting in):
    unused materials fill demo-box's tables to the budget (K2) and one
    row past it (K3)."""
    s = load("demo-box", 4)
    fill = (K2_SMEM_MAX - k2_smem_bytes(s)) // (4 * 12)  # a material row is 12 floats
    grow = lambda x, n: torch.cat([x, x[:1].expand(n, *x.shape[1:])])
    big = dataclasses.replace(s, **{f: grow(getattr(s, f), fill + extra) for f in
                                    ("mat_type", "mat_color", "mat_tex", "mat_eta", "mat_k")})
    assert K2_SMEM_MAX == 48 * 1024
    assert tuple(x.shape[1] for x in tables.pack_tables(big)) == tuple(tables.TABLE_W)
    assert (k2_smem_bytes(big) <= K2_SMEM_MAX) == (extra == 0)
    assert k2_smem_bytes(big) > K2_SMEM_MAX - 48  # filled to within one material row
    assert megakernel_eligible(big, DEFAULT_OPTIONS)
    assert kernel_tier(big, DEFAULT_OPTIONS) == want


def test_compile_refuses_rows_past_the_limit(monkeypatch):
    """compile_scene raises where the float32 row ids stop being exact
    (the limit lowered so that a small scene reaches it)."""
    desc = load_scene_file("scenes/demo-box.urn", ["/res", "4x4"])
    monkeypatch.setattr(compile_mod, "MAX_TABLE_ROWS", len(desc.prims) - 1)
    with pytest.raises(ValueError, match="primitives"):
        compile_scene(desc, device="cpu")
    monkeypatch.setattr(compile_mod, "MAX_TABLE_ROWS", 4096)
    compile_scene(desc, device="cpu")
    with pytest.raises(ValueError, match="atlas texels"):
        compile_scene(load_scene_file("scenes/textured256.urn", ["/res", "4x4"]), device="cpu")


def test_atlas_fetch_matches_jax():
    """The port's eval_color_rows on the 65,536-texel atlas against the
    JAX package's on the same uv rows (wrapped past [0, 1)), bit-equal;
    and scenes/swirl256.bmp is the swirl its generator draws."""
    name, args = "scenes/textured256.urn", ["/res", "8x8"]
    js, s = jax_compile(jax_load(name, args)), load_scene_file(name, args)
    s = compile_scene(s, device="cpu")
    assert s.atlas.shape == (65536, 3) and np.array_equal(np.asarray(js.atlas), s.atlas.numpy())
    g = np.random.default_rng(0)
    n = 4096
    uv = g.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    mat = np.repeat(np.arange(s.mat_type.shape[0], dtype=np.int32), n // s.mat_type.shape[0] + 1)[:n]
    tt, jt = tables.pack_tables(s), jax_tables.pack_tables(js)
    mrows = tables.gather_mat(tt, torch.from_numpy(mat))
    trows = tables.gather_tex(tt, torch.clamp(mrows.tex, min=0))
    ours = texture.eval_color_rows(s.atlas, mrows, trows, torch.from_numpy(uv), True).numpy()
    jm = jax_tables.gather_mat(jt, jnp.asarray(mat))
    jtr = jax_tables.gather_tex(jt, jnp.maximum(jm.tex, 0))
    theirs = np.asarray(jax_texture.eval_color_rows(js.atlas, jm, jtr, jnp.asarray(uv), True))
    np.testing.assert_array_equal(ours, theirs)
    assert len(np.unique(ours.reshape(-1, 3), axis=0)) > 1000  # many texels read
    img = read_bmp("scenes/swirl256.bmp")
    np.testing.assert_array_equal(img, np.floor(swirl(256) * 255.0) / 255.0)
