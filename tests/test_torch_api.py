"""The port's scene-level API against the JAX package's: ops/geometry,
the scene-level light, texture, sampling and tonemap functions, the
scene-level closest hit (intersect_prim_t, hit_detail, intersect_closest,
query_closest and its gradient), the reference-topology bvh_closest,
estimate_direct and cli.pathlib_stem.

Inputs are numpy draws from fixed seeds over demo-box, tables (6 area and
6 point lights, an image atlas), mesh0 and (the port's own tests) a
256-sphere cloud, at most
512 rays: rays from the camera towards points of the scene's root box
(most of them hit), and rays from inside the root box with directions of
random length (phantom sphere hits of non-unit rays). Each package's
calls for a scene run once and are shared by the parametrised cases
(``jax_side``: one jitted program a scene; ``port_side``); no render or
train step is compiled.

Tolerances, stated again at each assertion: bit for bit where both
packages run the same float32 operations (the geometry, sampling and
tonemap calls, which JAX runs eagerly, op by op); 1e-6 relative where
XLA contracts a product into a sum (a matmul; the scene-level functions,
jitted); t within 1e-4 relative where the sphere root's cancellation
amplifies that contraction; the bounds of tests/test_torch_ops.py where
a transcendental (sin, cos, arccos) or a grazing cosine enters. Across
the port's own query engines ("xla", "pallas" = K1's plain version,
"bvh" = the K3 query's plain version) the results are bit-equal: the
winners are equal and t is one arithmetic.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plutracer_tpu import cli as jcli
from plutracer_tpu.ops import bsdf as jbsdf
from plutracer_tpu.ops import geometry as jgeometry
from plutracer_tpu.ops import intersect as jintersect
from plutracer_tpu.ops import lights as jlights
from plutracer_tpu.ops import sampling as jsampling
from plutracer_tpu.ops import texture as jtexture
from plutracer_tpu.ops import tonemap as jtonemap
from plutracer_tpu.ops.bvh import bvh_closest as jax_bvh_closest
from plutracer_tpu.render.integrator import estimate_direct as jax_estimate_direct
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu.scene import types as jtypes
from plutracer_tpu.semantics import DEFAULT_OPTIONS as JAX_OPTIONS
from plutracer_tpu_torch import cli, rng
from plutracer_tpu_torch.ops import bsdf, geometry, intersect, lights, sampling, tables
from plutracer_tpu_torch.ops import texture, tonemap
from plutracer_tpu_torch.ops.bvh import bvh_closest
from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_plain, walk_closest_plain
from plutracer_tpu_torch.render.integrator import estimate_direct
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.loader import sphere_cloud
from plutracer_tpu_torch.scene.types import PRIM_SPHERE, PrimDesc, SceneDesc
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

SCENES = ("demo-box", "tables", "mesh0", "cloud")
# the scenes the JAX package runs each group of functions on (tracing and
# compiling a scene's program is most of this file's time): the texture
# and light functions on tables (checker, grid and atlas textures; area
# and point lights) and mesh0 (sphere, box and triangle rows),
# query_closest with its gradient on demo-box and mesh0, estimate_direct
# on tables (12 lights, 20 materials); intersect_prim_t,
# intersect_closest, hit_detail and bvh_closest on each of JAX_SCENES (the
# cloud's tests are the port's own: its engines, walk and brute force)
JAX_SCENES = ("demo-box", "tables", "mesh0")
TABLE_SCENES = ("tables", "mesh0")
QUERY_SCENES = ("demo-box", "mesh0")
DIRECT_SCENES = ("tables",)
B = 256  # rays of each kind: B from the camera, B from inside the root box
ENGINES = ("xla", "pallas", "bvh")
TRANSCENDENTAL = dict(rtol=1e-4, atol=2e-4)  # tests/test_torch_ops.py's uv bound


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def n(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def bits(got, want):
    """Bit for bit (both sides run the same float32 operations)."""
    np.testing.assert_array_equal(n(got), n(want))


def rel(got, want, rtol):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=0)


def sums_close(got, want, scale):
    """Sums of three products against XLA's contracted ones: within 1e-6
    relative, and within 1e-6 of `scale` (the largest product) where the
    terms cancel."""
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6 * scale)


def jax_desc(desc):
    """The JAX package's SceneDesc with the same fields as the port's."""
    conv = lambda cls, xs: [cls(**vars(x)) for x in xs]
    top = {k: v for k, v in vars(desc).items()
           if k not in ("prims", "materials", "textures", "lights")}
    return jtypes.SceneDesc(**top, prims=conv(jtypes.PrimDesc, desc.prims),
                            materials=conv(jtypes.MaterialDesc, desc.materials),
                            textures=conv(jtypes.TextureDesc, desc.textures),
                            lights=conv(jtypes.LightDesc, desc.lights))


@functools.cache
def scenes(name):
    """(the port's scene on the CPU, the JAX package's) at 16x16."""
    if name == "cloud":
        desc = sphere_cloud(256, seed=0)
        return compile_scene(desc, device="cpu"), jax_compile(jax_desc(desc))
    args = ["/res", "16x16"]
    return (compile_scene(load_scene_file(f"scenes/{name}.urn", args), device="cpu"),
            jax_compile(jax_load(f"scenes/{name}.urn", args)))


@functools.cache
def inputs(name, seed=0):
    """numpy inputs: camera rays towards points of the root box, interior
    rays of random length, per-ray uniforms and table ids, and unit
    directions from the ray origins towards each ray's primitive (`wp`)
    and light (`wl`: its carrier's centre, or its position)."""
    s, _ = scenes(name)
    r = np.random.default_rng(seed)
    lo, hi = s.bvh.node_min[0].numpy(), s.bvh.node_max[0].numpy()
    cam = s.camera.pos.numpy()
    aim = lo + (hi - lo) * r.uniform(size=(B, 3))
    cd = aim - cam
    cd /= np.linalg.norm(cd, axis=-1, keepdims=True)
    io = lo + (hi - lo) * r.uniform(size=(B, 3))
    idir = r.normal(size=(B, 3))
    idir *= r.uniform(0.5, 1.5, (B, 1)) / np.linalg.norm(idir, axis=-1, keepdims=True)
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    N = 2 * B
    x = dict(
        o=f32(np.concatenate([np.broadcast_to(cam, (B, 3)), io])),
        d=f32(np.concatenate([cd, idir])),
        u=f32(r.uniform(size=(N, 8))),
        pi=r.integers(0, s.num_prims, N).astype(np.int32),
        li=r.integers(0, s.num_lights, N).astype(np.int32),
        mi=r.integers(0, s.mat_type.shape[0], N).astype(np.int32),
        uv=f32(r.uniform(-3.0, 3.0, (N, 2))),
        n=f32(r.normal(size=(N, 3))),
    )
    a, b, c = (getattr(s, f).numpy() for f in ("prim_a", "prim_b", "prim_c"))
    ptype = s.prim_type.numpy()[:, None]
    centre = np.where(ptype == 0, a, np.where(ptype == 1, (a + b) / 2, (a + b + c) / 3))
    lprim = s.light_prim.numpy()[x["li"]]
    towards = {"wp": centre[x["pi"]],
               "wl": np.where(lprim[:, None] >= 0, centre[np.maximum(lprim, 0)],
                              s.light_pos.numpy()[x["li"]])}
    for k, aim in towards.items():
        w = aim - x["o"]
        x[k] = f32(w / np.linalg.norm(w, axis=-1, keepdims=True))
    return x


def hit_inputs(name):
    """The port's primary hit of the camera and interior rays, and what
    estimate_direct takes at it (frame, material type, albedo, the
    outgoing direction), as numpy arrays that both packages are fed."""
    s, _ = scenes(name)
    x = inputs(name)
    h = intersect.query_closest(s, t(x["o"]), t(x["d"]), DEFAULT_OPTIONS)
    fr = bsdf.make_frame(h.norm, h.dpdu)
    mat = tables.gather_prim(tables.pack_tables(s), h.prim).material
    mtype = tables.gather_mat(tables.pack_tables(s), mat).mtype
    albedo = texture.eval_color(s, mat, h.uv)
    return dict(hit=[n(v) for v in h], frame=[n(v) for v in fr], mtype=n(mtype),
                albedo=n(albedo), wwo=-x["d"], closest=[n(h.t), n(h.prim), n(h.found)])


def jax_program(name):
    """The JAX package's functions on the scene's inputs, as one program:
    the texture and light functions on TABLE_SCENES, query_closest and its
    gradient on QUERY_SCENES, estimate_direct on DIRECT_SCENES, the rest
    on every scene."""
    _, js = scenes(name)

    def program(js, x, hi):
        o, d, u = x["o"], x["d"], x["u"]
        out = {}
        if name in TABLE_SCENES:
            out["eval_color"] = jtexture.eval_color(js, x["mi"], x["uv"])
            out["sample_surface"] = jlights.sample_surface(js, x["pi"], u[:, 0:2], u[:, 2],
                                                           u[:, 3])
            out["surface_pdf"] = jlights.surface_pdf(js, x["pi"], o, x["wp"], JAX_OPTIONS)
            out["sample_light"] = jlights.sample_light(js, x["li"], o, u[:, 0:2], u[:, 2],
                                                       u[:, 3], JAX_OPTIONS)
            out["light_pdf"] = jlights.light_pdf(js, x["li"], o, x["wl"], JAX_OPTIONS)
            out["emitted"] = jlights.emitted(js, x["pi"], x["n"], d)
        out["intersect_prim_t"] = jintersect.intersect_prim_t(js, x["pi"], o, d)
        out["intersect_closest"] = jintersect.intersect_closest(js, o, d)
        out["hit_detail"] = jintersect.hit_detail(js, o, d, *hi["closest"])
        out["bvh_closest"] = jax_bvh_closest(js, js.bvh, o, d)
        for engine in ("xla", "bvh") if name in QUERY_SCENES else ():
            opts = JAX_OPTIONS.replace(intersect_backend=engine)

            def p_sum(a, b):
                h = jintersect.query_closest(dataclasses.replace(js, prim_a=a, prim_b=b), o, d,
                                             opts)
                return jnp.sum(h.p), h

            (_, h), g = jax.value_and_grad(p_sum, argnums=(0, 1), has_aux=True)(js.prim_a,
                                                                                js.prim_b)
            out[f"query_closest {engine}"] = (h, g)
        if name in DIRECT_SCENES:
            hit, frame = jintersect.Hit(*hi["hit"]), jbsdf.Frame(*hi["frame"])
            for gate in (False, True):
                opts = JAX_OPTIONS.replace(shading_normal_le_gate=gate)
                out[f"estimate_direct {gate}"] = jax_estimate_direct(
                    js, hit, frame, hi["mtype"], hi["albedo"], hi["wwo"], x["li"], u, opts)
        return out

    args = (js, jax.tree.map(j, inputs(name)), jax.tree.map(j, hit_inputs(name)))
    return jax.jit(program).lower(*args), args


# LLVM's -O0 for the JAX programs: a third less compile time, which is most
# of this file's CPU time (their HLO passes still run)
O0 = {"xla_backend_optimization_level": 0}


@functools.cache
def jax_results():
    """Every scene's JAX program, traced one after another and compiled
    together (XLA compiles outside the interpreter lock: most of this
    file's time is these compiles), then run. {scene: outputs (numpy)}."""
    lowered = {name: jax_program(name) for name in JAX_SCENES}
    with ThreadPoolExecutor(len(JAX_SCENES)) as ex:
        compiled = dict(zip(JAX_SCENES, ex.map(lambda name: lowered[name][0].compile(O0),
                                               JAX_SCENES)))
    return {name: jax.tree.map(np.asarray, compiled[name](*lowered[name][1]))
            for name in JAX_SCENES}


def jax_side(name):
    return jax_results()[name]


# ---------------------------------------------------------------------------
# ops/geometry, sampling, tonemap, cli: no scene
# ---------------------------------------------------------------------------


def geometry_inputs(seed=1):
    r = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    lo = f32(r.uniform(-2.0, 1.0, (64, 3)))
    m = f32(np.eye(4))
    m[:3, :3] = r.normal(size=(3, 3))
    m[:3, 3] = r.normal(size=3)
    return dict(o=f32(r.uniform(-4.0, 4.0, (64, 3))), d=f32(r.normal(size=(64, 3))),
                tt=f32(r.uniform(0.0, 5.0, 64)), lo=lo, hi=lo + f32(r.uniform(0.1, 2.0, (64, 3))),
                lo2=f32(r.uniform(-2.0, 1.0, (64, 3))), m=m)


def test_ray_at_and_transform():
    g = geometry_inputs()
    o, d, m = g["o"], g["d"], g["m"]
    bits(geometry.ray_at(t(o), t(d), t(g["tt"])), jgeometry.ray_at(j(o), j(d), j(g["tt"])))
    bits(geometry.ray_at(t(o), t(d), 2.5), jgeometry.ray_at(j(o), j(d), 2.5))
    # float32 sums of products against XLA's matmul (contracted): 1e-6
    scale = np.abs(m).max() * max(np.abs(o).max(), np.abs(d).max())
    for got, want in zip(geometry.ray_transform(t(o), t(d), t(m)),
                         jgeometry.ray_transform(j(o), j(d), j(m))):
        sums_close(got, want, scale)
    # tests/test_geometry.py's case: a z rotation and a translation
    rz = t([[0.0, -1, 0, 1], [1, 0, 0, 2], [0, 0, 1, 3], [0, 0, 0, 1]])
    o2, d2 = geometry.ray_transform(t([1.0, 0, 0]), t([0.0, 1, 0]), rz)
    bits(o2, np.float32([1, 3, 3]))
    bits(d2, np.float32([-1, 0, 0]))


@pytest.mark.parametrize("method", ["add_point", "union", "contains", "inside_of", "transform",
                                    "hit", "hit_retint", "center", "extents", "surface_area"])
def test_aabb(method):
    g = geometry_inputs()
    ours, theirs = geometry.Aabb(t(g["lo"]), t(g["hi"])), jgeometry.Aabb(j(g["lo"]), j(g["hi"]))
    other = lambda A, f: A(f(g["lo2"]), f(g["lo2"] + 1.5))
    args = {
        "add_point": lambda f, A: (f(g["o"]),),
        "union": lambda f, A: (other(A, f),),
        "contains": lambda f, A: (f(g["o"] * 0.4),),
        "inside_of": lambda f, A: (A(f(g["lo2"][0] - 1.0), f(g["lo2"][0] + 1.0)),),
        "transform": lambda f, A: (f(g["m"]),),
        "hit": lambda f, A: (f(g["o"]), f(g["d"])),
        "hit_retint": lambda f, A: (f(g["o"]), f(g["d"])),
    }.get(method, lambda f, A: ())
    got = getattr(ours, method)(*args(t, geometry.Aabb))
    want = getattr(theirs, method)(*args(j, jgeometry.Aabb))
    for a, b in zip(jax.tree.leaves(tuple(got) if isinstance(got, tuple) else got),
                    jax.tree.leaves(tuple(want) if isinstance(want, tuple) else want)):
        if method == "transform":
            # sums of products, contracted by XLA: 1e-6
            sums_close(a, b, np.abs(g["m"]).max() * np.abs(g["hi"]).max())
        else:
            bits(a, b)  # the same float32 operations
    if method in ("contains", "inside_of", "hit"):
        assert 0 < n(got).mean() < 1, method  # both outcomes occur


def test_aabb_empty_takes_its_device():
    e = geometry.Aabb.empty(torch.device("cpu"))
    bits(e.lo, jgeometry.Aabb.empty().lo)
    bits(e.hi, jgeometry.Aabb.empty().hi)
    with pytest.raises(TypeError):
        geometry.Aabb.empty()  # no default device


def test_sampling():
    u = np.random.default_rng(2).uniform(size=(512, 2)).astype(np.float32)
    # sin/cos of the azimuth: the bound of tests/test_torch_ops.py's
    # sampling pins (rtol 1e-5, atol 2e-6)
    np.testing.assert_allclose(n(sampling.uniform_hemisphere_sample(t(u))),
                               n(jsampling.uniform_hemisphere_sample(j(u))), rtol=1e-5, atol=2e-6)
    # the constant pdfs: the same Python floats
    assert sampling.uniform_hemisphere_pdf() == jsampling.uniform_hemisphere_pdf()
    assert sampling.uniform_sphere_pdf() == jsampling.uniform_sphere_pdf()
    bits(sampling.cosine_hemisphere_pdf(t(u[:, 0])), jsampling.cosine_hemisphere_pdf(j(u[:, 0])))


@pytest.mark.parametrize("count,jitter", [(1, True), (3, True), (8, True), (5, False)])
def test_stratified_offsets(count, jitter):
    """The threefry draw is bit-equal to jax.random.uniform, and the cell
    arithmetic the same float32 operations: bit for bit."""
    got = sampling.stratified_offsets(rng.PRNGKey(5), count, jitter)
    want = jsampling.stratified_offsets(jax.random.PRNGKey(5), count, jitter)
    assert got.shape == (count * count, 2) and got.device == rng.PRNGKey(5).device
    bits(got, want)


def test_reinhard():
    c = np.random.default_rng(3).exponential(2.0, (16, 12, 3)).astype(np.float32)
    c[0, 0] = 0.0
    assert tonemap.postprocess_image is tonemap.reinhard  # one body under both names
    # the power 1/2.2: tests/test_torch_ops.py's tonemap bound
    np.testing.assert_allclose(n(tonemap.reinhard(t(c))), n(jtonemap.reinhard(j(c))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["scenes/demo-box.urn", "/a/b.c/scene.v2.urn", "plain", "x/"])
def test_pathlib_stem(path):
    assert cli.pathlib_stem(path) == jcli.pathlib_stem(path)


# ---------------------------------------------------------------------------
# scene-level functions against the JAX package
# ---------------------------------------------------------------------------


@functools.cache
def port_side(name):
    """The port's functions on the scene's inputs, once: those jax_program
    runs, and query_closest (with the gradient of sum(hit.p)) and
    estimate_direct under each of the port's engines on every scene."""
    s, _ = scenes(name)
    x = inputs(name)
    o, d, u = t(x["o"]), t(x["d"]), t(x["u"])
    out = {}
    if name in TABLE_SCENES:
        out["eval_color"] = texture.eval_color(s, t(x["mi"]), t(x["uv"]))
        out["sample_surface"] = lights.sample_surface(s, t(x["pi"]), u[:, 0:2], u[:, 2], u[:, 3])
        out["surface_pdf"] = lights.surface_pdf(s, t(x["pi"]), o, t(x["wp"]), DEFAULT_OPTIONS)
        out["sample_light"] = lights.sample_light(s, t(x["li"]), o, u[:, 0:2], u[:, 2], u[:, 3],
                                                  DEFAULT_OPTIONS)
        out["light_pdf"] = lights.light_pdf(s, t(x["li"]), o, t(x["wl"]), DEFAULT_OPTIONS)
        out["emitted"] = lights.emitted(s, t(x["pi"]), t(x["n"]), d)
    out["intersect_prim_t"] = intersect.intersect_prim_t(s, t(x["pi"]), o, d)
    out["intersect_closest"] = intersect.intersect_closest(s, o, d)
    out["bvh_closest"] = bvh_closest(s, s.bvh, o, d, count=True)
    for engine in ENGINES:
        a = s.prim_a.clone().requires_grad_(True)
        b = s.prim_b.clone().requires_grad_(True)
        h = intersect.query_closest(dataclasses.replace(s, prim_a=a, prim_b=b), o, d,
                                    DEFAULT_OPTIONS.replace(intersect_backend=engine))
        out[f"query_closest {engine}"] = (h, torch.autograd.grad(h.p.sum(), (a, b)))
    hi = hit_inputs(name)
    hit = intersect.Hit(*(t(v) for v in hi["hit"]))
    fr = bsdf.Frame(*(t(v) for v in hi["frame"]))
    for gate in (False, True):
        for engine in ENGINES:
            opts = DEFAULT_OPTIONS.replace(shading_normal_le_gate=gate, intersect_backend=engine)
            out[f"estimate_direct {gate} {engine}"] = estimate_direct(
                s, hit, fr, t(hi["mtype"]), t(hi["albedo"]), t(hi["wwo"]), t(x["li"]), u, opts)
    return out


def hit_close(got, want):
    """A Hit's winner and t against the JAX package's: found and prim
    exactly; t within 1e-4 relative on hits, the allowance
    tests/test_torch_bvh.py states for XLA's contracted sphere root
    (qb - sqrt(det) cancels on grazing rays and far spheres: 5.5e-5
    measured on a 256-sphere cloud seen from its camera), and p, which
    inherits t's error, within 1e-4 of the largest t."""
    bits(got.found, want.found)
    m = n(want.found)
    assert m.mean() > 0.2  # most of the camera rays hit
    bits(n(got.prim)[m], want.prim[m])
    rel(n(got.t)[m], want.t[m], 1e-4)
    np.testing.assert_allclose(n(got.p)[m], want.p[m], rtol=1e-4, atol=1e-4 * want.t[m].max())


@pytest.mark.parametrize("name", TABLE_SCENES)
def test_eval_color_matches_jax(name):
    """Checker and grid textures, constant colours and (tables) the image
    atlas: the same float32 operations and texel gathers, bit for bit."""
    bits(port_side(name)["eval_color"], jax_side(name)["eval_color"])


@pytest.mark.parametrize("name", TABLE_SCENES)
def test_scene_level_lights_match_jax(name):
    """sample_surface, surface_pdf, sample_light, light_pdf and emitted over
    the _rows functions. Tolerances: the sampled points and directions
    (sin, cos, XLA-contracted sums) within tests/test_torch_ops.py's light
    bounds (rtol 1e-4, atol 1e-5), as the sampled light's pdf; the pdfs of
    the rays aimed at the carriers within 1e-3 relative (dist^2 / (|cos|
    area): a grazing cosine amplifies the contracted hit's error, 5e-4 on
    one mesh0 lane); the flags and emitted radiance (a select of table
    entries) exactly."""
    got, want = port_side(name), jax_side(name)
    tol = dict(rtol=1e-4, atol=1e-5)
    for a, b in zip(got["sample_surface"], want["sample_surface"]):
        np.testing.assert_allclose(n(a), b, **tol)
    for k in ("surface_pdf", "light_pdf"):
        np.testing.assert_allclose(n(got[k]), want[k], rtol=1e-3, atol=1e-5)
        assert (want[k] > 0).mean() > 0.2, k  # rays aimed at the carrier reach it
    ls, jls = got["sample_light"], want["sample_light"]
    for field in ("Li", "wi", "pdf"):
        np.testing.assert_allclose(n(getattr(ls, field)), getattr(jls, field), **tol)
    bits(ls.is_delta, jls.is_delta)
    bits(got["emitted"], want["emitted"])


@pytest.mark.parametrize("name", JAX_SCENES)
def test_intersect_prim_t_and_closest_match_jax(name):
    """intersect_prim_t within 1e-4 relative (hit_close's allowance for
    XLA's contracted sphere root; the misses' sentinel exactly);
    intersect_closest by hit_close's rule; hit_detail at the port's
    winners and t against the JAX package's at the same: p within 1e-6
    relative (o + d t, contracted by XLA), norm, uv and dpdu within
    tests/test_torch_ops.py's hit-detail bounds (arccos and sin at the
    sphere poles; the triangle's normalised edges)."""
    got, want = port_side(name), jax_side(name)
    # t of one row a ray: the misses' sentinel exactly, the hits within
    # hit_close's 1e-4 relative (XLA's contracted sphere root)
    rel(got["intersect_prim_t"], want["intersect_prim_t"], 1e-4)
    hit_close(got["intersect_closest"], want["intersect_closest"])
    s, _ = scenes(name)
    x = inputs(name)
    h = got["intersect_closest"]
    again = intersect.hit_detail(s, t(x["o"]), t(x["d"]), h.t, h.prim, h.found)
    for a, b in zip(again, h):
        bits(a, b)  # intersect_closest is intersect_lite then hit_detail
    jd, m = want["hit_detail"], n(h.found)
    np.testing.assert_allclose(n(h.p)[m], jd.p[m], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(h.norm)[m], jd.norm[m], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(h.uv)[m], jd.uv[m], **TRANSCENDENTAL)
    np.testing.assert_allclose(n(h.dpdu)[m], jd.dpdu[m], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("engine", ["xla", "bvh"])
@pytest.mark.parametrize("name", QUERY_SCENES)
def test_query_closest_matches_jax(name, engine):
    """query_closest under `engine` against the JAX package's: the hit by
    hit_close's rule, and the gradient of sum(hit.p) with respect to
    prim_a and prim_b against jax.grad within 1e-5 of the largest entry.
    The gradients compared take the same route on both sides: under "xla"
    through intersect_lite's own t, under "bvh" through t recomputed at
    the winner (JAX: bvh_closest then intersect_prim_t; the port: the
    walk's plain version then differentiable_t)."""
    (h, grads), (jh, jgrads) = port_side(name)[f"query_closest {engine}"], \
        jax_side(name)[f"query_closest {engine}"]
    hit_close(h, jh)
    for g, jg in zip(grads, jgrads):
        scale = np.abs(jg).max()
        assert scale > 0
        np.testing.assert_allclose(n(g), jg, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name", SCENES)
def test_query_closest_engines_agree(name):
    """The port's three engines: the hit bit for bit on every field, and
    the gradient bit-equal between "pallas" and "bvh" (both recompute t at
    the same winner with the same arithmetic)."""
    got = port_side(name)
    (h0, g0) = got["query_closest pallas"]
    for engine in ("xla", "bvh"):
        h, g = got[f"query_closest {engine}"]
        m = n(h0.found)
        bits(h.found, h0.found)
        for a, b in zip(h[1:], h0[1:]):
            bits(n(a)[m], n(b)[m])
        if engine == "bvh":
            for a, b in zip(g, g0):
                bits(a, b)


@pytest.mark.parametrize("name", SCENES)
def test_bvh_closest(name):
    """bvh_closest over the reference's tree against the walk's plain
    version and K1's plain version: found and prim equal, t bit-equal on
    hits (all three test a row with the same float32 operations; the
    phantom sphere hits of the interior rays are kept by all three, culled
    by the leaf's parent box); a miss reports t _BIG."""
    s, _ = scenes(name)
    x = inputs(name)
    o, d = t(x["o"]), t(x["d"])
    f, p, tt, steps = port_side(name)["bvh_closest"]
    assert steps > 1
    for other in (closest_hit_plain(s.prims_packed, o, d),
                  walk_closest_plain(s.prims_packed, s.walk_nodes, s.walk_rows, o, d)):
        bits(f, other[0])
        bits(p[f], other[1][f])
        bits(tt[f], other[2][f])
    assert n(f).mean() > 0.2
    bits(tt[~f], np.full(int((~f).sum()), intersect._BIG, np.float32))


@pytest.mark.parametrize("name", JAX_SCENES)
def test_bvh_closest_matches_jax(name):
    """bvh_closest against the JAX package's on the same rays: found and
    prim equal, t within 1e-4 relative (tests/test_torch_bvh.py's allowance
    for XLA's contracted sphere root)."""
    f, p, tt, _ = port_side(name)["bvh_closest"]
    jf, jp, jt = jax_side(name)["bvh_closest"]
    bits(f, jf)
    bits(n(p)[jf], jp[jf])
    np.testing.assert_allclose(n(tt)[jf], jt[jf], rtol=1e-4)


def phantom_case(centres):
    """Unit spheres at (x, 0, 0) for x in `centres`, and a ray with |d| = 2
    whose sphere test (written for unit rays) reports a hit on the sphere
    at x = 10, though its LINE passes 3.2 from that centre and misses the
    sphere's own box."""
    desc = SceneDesc()
    for x in centres:
        desc.add_prim(PrimDesc(PRIM_SPHERE, a=np.float32([x, 0, 0]), b=np.float32([1, 0, 0])))
    return (compile_scene(desc, device="cpu"), torch.tensor([[6.0, 0.0, 0.0]]),
            torch.tensor([[1.2, 0.0, 1.6]]))


@pytest.mark.parametrize("centres", [(10.0,), (0.0, 10.0)])
def test_bvh_closest_keeps_a_phantom_sphere_hit(centres):
    """bvh_closest tests a leaf's primitive without the leaf's box
    (bvh_tree.cpp:40-42): the phantom hit stands where the ray's line
    crosses the leaf's parent box (the root of two spheres), or where the
    leaf is the root (one sphere). So do the brute force (its parent-box
    cull; none for a lone primitive) and the walk: a walk child that is
    one reference leaf holds its row's cull box (scene/compile.walk_tables),
    not the sphere's own box, which the line misses. Bit for bit."""
    s, o, d = phantom_case(centres)
    k = centres.index(10.0)
    f, p, tt = bvh_closest(s, s.bvh, o, d)
    assert bool(f[0]) and int(p[0]) == k
    c = s.prim_a[k]
    closest = ((c - o[0]) * d[0]).sum() / (d[0] * d[0]).sum()
    assert float(torch.linalg.norm(o[0] + closest * d[0] - c)) > 3.0  # the line misses it
    assert not bool(geometry.Aabb(c - 1.0, c + 1.0).hit(o, d)[0])  # a leaf box test culls it
    for other in (closest_hit_plain(s.prims_packed, o, d),
                  walk_closest_plain(s.prims_packed, s.walk_nodes, s.walk_rows, o, d)):
        bits(f, other[0])
        bits(p, other[1])
        bits(tt, other[2])


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_estimate_direct_engines_agree(name, gate):
    """estimate_direct at the primary hit with shading_normal_le_gate on
    and off under the port's three engines: bit-equal (the same winners,
    and the nee ray's t is one arithmetic), finite, and lit somewhere."""
    got = port_side(name)
    ref = got[f"estimate_direct {gate} xla"]
    for engine in ("pallas", "bvh"):
        bits(got[f"estimate_direct {gate} {engine}"], ref)
    assert np.isfinite(n(ref)).all()
    assert (n(ref) > 0).any()


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("name", DIRECT_SCENES)
def test_estimate_direct_matches_jax(name, gate):
    """estimate_direct with the gate on and off, the same inputs fed to
    both packages, against the JAX package's (its "xla" engine on the
    CPU): within rtol 1e-4, atol 1e-5 (tests/test_torch_ops.py's light and
    BSDF bounds: sin, cos and XLA's contracted sums in the light sample,
    the pdfs and the MIS weights)."""
    got = port_side(name)[f"estimate_direct {gate} xla"]
    np.testing.assert_allclose(n(got), jax_side(name)[f"estimate_direct {gate}"],
                               rtol=1e-4, atol=1e-5)
