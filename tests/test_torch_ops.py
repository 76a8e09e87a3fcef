"""Per-function pins of plutracer_tpu_torch.ops against the JAX ops.

Inputs are drawn with numpy from fixed seeds over real scene tables (the
pattern of tests/test_kernel_crosspin.py) and fed to both packages.
Tolerance: rtol 1e-5 / atol 1e-5 on float outputs, exact on integer,
boolean and table outputs. XLA fuses and reassociates float32 math on the
CPU (FMA contraction), so results differ by a few ulp; transcendental
chains (arccos at the sphere poles) get the looser uv bounds of
test_kernel_crosspin.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plutracer_tpu.ops import bsdf as jbsdf
from plutracer_tpu.ops import camera as jcamera
from plutracer_tpu.ops import intersect as jint
from plutracer_tpu.ops import lights as jlights
from plutracer_tpu.ops import sampling as jsampling
from plutracer_tpu.ops import tables as jtables
from plutracer_tpu.ops import texture as jtexture
from plutracer_tpu.ops import tonemap as jtonemap
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu.semantics import DEFAULT_OPTIONS as JAX_OPTIONS
from plutracer_tpu_torch.ops import (bsdf, camera, intersect, lights, safemath, sampling, tables,
                                    texture, tonemap)
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

B = 2048
SCENES = ["demo-box", "dof", "textured0", "mesh0"]
TOL = dict(rtol=1e-5, atol=1e-5)


def both(name):
    args = ["/res", "24x24"]
    return (jax_compile(jax_load(f"scenes/{name}.urn", args)),
            compile_scene(load_scene_file(f"scenes/{name}.urn", args), device="cpu"))


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def rand_state(scene, seed):
    rs = np.random.RandomState(seed)
    P, L, M = scene.num_prims, scene.num_lights, scene.mat_type.shape[0]
    o = rs.uniform(-8.0, 8.0, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(
        o=o, d=d,
        pi=rs.randint(0, P, B).astype(np.int32),
        li=rs.randint(0, L, B).astype(np.int32),
        mi=rs.randint(0, M, B).astype(np.int32),
        u=rs.uniform(size=(B, 12)).astype(np.float32),
        n=(lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True))(
            rs.normal(size=(B, 3)).astype(np.float32)),
        dpdu=rs.normal(size=(B, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("fn", ["concentric_disk_sample", "uniform_sphere_sample",
                                "cosine_hemisphere_sample"])
def test_sampling(fn):
    u = np.random.RandomState(0).uniform(size=(B, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.0], [0.0, 0.5]]  # centre, axes
    close(getattr(sampling, fn)(t(u)), getattr(jsampling, fn)(j(u)), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("name", ["demo-box", "dof"])
def test_generate_rays(name):
    js, ts = both(name)
    rs = np.random.RandomState(1)
    px = rs.uniform(0, 24, (B, 2)).astype(np.float32)
    lens = rs.uniform(size=(B, 2)).astype(np.float32)
    (o, d), (jo, jd) = camera.generate_rays(ts.camera, t(px), t(lens)), jcamera.generate_rays(js.camera, j(px), j(lens))
    close(o, jo)
    close(d, jd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_pack_tables_exact(name):
    js, ts = both(name)
    for a, b in zip(tables.pack_tables(ts), jtables.pack_tables(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", SCENES)
def test_prim_t(name):
    """sphere_t / box_t / triangle_t through prim_t_rows, and the scene-level
    brute force intersect_lite (winners exact). t bit for bit, the sqrt
    being rounded to nearest on both sides, except intersect_lite's on
    mesh0, whose triangle hits XLA contracts into FMAs (5 of 345 hits
    differ, within 1e-6 relative)."""
    js, ts = both(name)
    st = rand_state(ts, 2)
    rows_t = tables.gather_prim(tables.pack_tables(ts), t(st["pi"]))
    rows_j = jtables.gather_prim(jtables.pack_tables(js), j(st["pi"]))
    got = intersect.prim_t_rows(t(st["o"]), t(st["d"]), rows_t)
    want = jint.prim_t_rows(j(st["o"]), j(st["d"]), rows_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f, p, tt = intersect.intersect_lite(ts, t(st["o"]), t(st["d"]))
    jf, jp, jt = jint.intersect_lite(js, j(st["o"]), j(st["d"]))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    m = np.asarray(jf)
    np.testing.assert_array_equal(p.numpy()[m], np.asarray(jp)[m])
    close(tt.numpy()[m], np.asarray(jt)[m], rtol=1e-6 if name == "mesh0" else 0.0, atol=0)


@pytest.mark.parametrize("name", SCENES)
def test_hit_detail_rows(name):
    js, ts = both(name)
    st = rand_state(ts, 3)
    rows_t = tables.gather_prim(tables.pack_tables(ts), t(st["pi"]))
    rows_j = jtables.gather_prim(jtables.pack_tables(js), j(st["pi"]))
    # aim each ray at its assigned primitive's centre so most of them hit
    r = np.asarray(rows_j.rows)
    ptype = r[:, 0:1]
    centre = np.where(ptype == 0, r[:, 1:4], np.where(
        ptype == 1, (r[:, 1:4] + r[:, 4:7]) * 0.5, (r[:, 1:4] + r[:, 4:7] + r[:, 7:10]) / 3.0))
    d = (centre - st["o"]).astype(np.float32)
    st["d"] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tt = jint.prim_t_rows(j(st["o"]), j(st["d"]), rows_j)
    found = np.asarray(tt) < jint.T_MAX
    assert found.mean() > 0.25
    tv = np.asarray(tt)
    got = intersect.hit_detail_rows(t(st["o"]), t(st["d"]), t(tv), t(st["pi"]), t(found), rows_t)
    want = jint.hit_detail_rows(j(st["o"]), j(st["d"]), j(tv), j(st["pi"]), j(found), rows_j)
    m = found
    close(got.p.numpy()[m], np.asarray(want.p)[m])
    close(got.norm.numpy()[m], np.asarray(want.norm)[m], rtol=1e-4, atol=1e-5)
    close(got.uv.numpy()[m], np.asarray(want.uv)[m], rtol=1e-4, atol=2e-4)
    close(got.dpdu.numpy()[m], np.asarray(want.dpdu)[m], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("nso", [False, True])
def test_bsdf_sample_and_pdfs(name, nso):
    js, ts = both(name)
    st = rand_state(ts, 4)
    mr_t = tables.gather_mat(tables.pack_tables(ts), t(st["mi"]))
    mr_j = jtables.gather_mat(jtables.pack_tables(js), j(st["mi"]))
    fr_t = bsdf.make_frame(t(st["n"]), t(st["dpdu"]))
    fr_j = jbsdf.make_frame(j(st["n"]), j(st["dpdu"]))
    wwo = -st["d"]
    u = st["u"]
    got = bsdf.bsdf_sample(fr_t, mr_t.mtype, mr_t.color, mr_t.eta, mr_t.k, t(wwo),
                           t(u[:, 0]), t(u[:, 1:3]), non_specular_only=nso)
    want = jbsdf.bsdf_sample(fr_j, mr_j.mtype, mr_j.color, mr_j.eta, mr_j.k, j(wwo),
                             j(u[:, 0]), j(u[:, 1:3]), non_specular_only=nso)
    close(got.f, want.f, rtol=1e-4, atol=1e-5)
    close(got.wwi, want.wwi, rtol=1e-4, atol=1e-5)
    close(got.pdf, want.pdf, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.is_specular.numpy(), np.asarray(want.is_specular))
    wi = st["o"] / np.linalg.norm(st["o"], axis=-1, keepdims=True)
    close(bsdf.bsdf_pdf_nee(fr_t, mr_t.mtype, t(wwo), t(wi)),
          jbsdf.bsdf_pdf_nee(fr_j, mr_j.mtype, j(wwo), j(wi)))
    close(bsdf.bsdf_F_nee(mr_t.mtype, mr_t.color, t(st["n"]), t(wwo), t(wi)),
          jbsdf.bsdf_F_nee(mr_j.mtype, mr_j.color, j(st["n"]), j(wwo), j(wi)))


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("origin_pdf", [False, True])
def test_lights(name, origin_pdf):
    """sample_light_rows, light_pdf_rows and emitted_rows (dof carries a
    point light, the others area lights)."""
    js, ts = both(name)
    st = rand_state(ts, 5)
    opts = DEFAULT_OPTIONS.replace(origin_distance_pdf=origin_pdf)
    jopts = JAX_OPTIONS.replace(origin_distance_pdf=origin_pdf)
    tt, jt = tables.pack_tables(ts), jtables.pack_tables(js)
    lr_t, lr_j = tables.gather_light(tt, t(st["li"])), jtables.gather_light(jt, j(st["li"]))
    car_t = tables.gather_prim(tt, torch.clamp(lr_t.prim, min=0))
    car_j = jtables.gather_prim(jt, jnp.maximum(lr_j.prim, 0))
    u = st["u"]
    got = lights.sample_light_rows(lr_t, car_t, t(st["o"]), t(u[:, 0:2]), t(u[:, 2]), t(u[:, 3]), opts)
    want = jlights.sample_light_rows(lr_j, car_j, j(st["o"]), j(u[:, 0:2]), j(u[:, 2]), j(u[:, 3]), jopts)
    close(got.Li, want.Li, rtol=1e-4, atol=1e-5)
    close(got.wi, want.wi, rtol=1e-4, atol=1e-5)
    close(got.pdf, want.pdf, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(want.is_delta))
    close(lights.light_pdf_rows(lr_t, car_t, t(st["o"]), t(st["d"]), opts),
          jlights.light_pdf_rows(lr_j, car_j, j(st["o"]), j(st["d"]), jopts), rtol=1e-4, atol=1e-5)
    pr_t, pr_j = tables.gather_prim(tt, t(st["pi"])), jtables.gather_prim(jt, j(st["pi"]))
    own_t = tables.gather_light(tt, torch.clamp(pr_t.light, min=0))
    own_j = jtables.gather_light(jt, jnp.maximum(pr_j.light, 0))
    close(lights.emitted_rows(pr_t, own_t, t(st["n"]), t(st["d"])),
          jlights.emitted_rows(pr_j, own_j, j(st["n"]), j(st["d"])), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["demo-box", "textured0"])
def test_eval_color_rows(name):
    """Checker and grid (demo-box) and the image atlas (textured0)."""
    js, ts = both(name)
    st = rand_state(ts, 6)
    tt, jt = tables.pack_tables(ts), jtables.pack_tables(js)
    mr_t, mr_j = tables.gather_mat(tt, t(st["mi"])), jtables.gather_mat(jt, j(st["mi"]))
    tr_t = tables.gather_tex(tt, torch.clamp(mr_t.tex, min=0))
    tr_j = jtables.gather_tex(jt, jnp.maximum(mr_j.tex, 0))
    uv = np.random.RandomState(7).uniform(-3.0, 3.0, (B, 2)).astype(np.float32)
    has_images = ts.atlas.shape[0] > 1
    close(texture.eval_color_rows(ts.atlas, mr_t, tr_t, t(uv), has_images),
          jtexture.eval_color_rows(js.atlas, mr_j, tr_j, j(uv), has_images), rtol=1e-5, atol=1e-6)


def test_tonemap():
    c = np.random.RandomState(8).exponential(2.0, (64, 48, 3)).astype(np.float32)
    c[0, 0] = 0.0  # black maps to black
    close(tonemap.postprocess_image(t(c)), jtonemap.postprocess_image(j(c)), rtol=1e-5, atol=1e-6)


def test_sqrt_rounded_to_nearest():
    """safemath.sqrt and safe_sqrt on CPU tensors: bit-equal to XLA's sqrt
    and to the float64 root rounded to float32 on 1,000,000 values (torch's
    own CPU sqrt misses by an ulp on about 0.6% of them), with JAX's
    derivative g * (0.5 / sqrt(x))."""
    x = np.random.default_rng(0).uniform(0.0, 100.0, 1_000_000).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(j(x))), want)
    for fn in (safemath.sqrt, safemath.safe_sqrt):
        np.testing.assert_array_equal(fn(t(x)).numpy(), want)
    assert (torch.sqrt(t(x)).numpy() != want).any()  # what the rounding repairs
    xs = t(x[:64]).requires_grad_(True)
    (g,) = torch.autograd.grad(safemath.safe_sqrt(xs).sum(), xs)
    jg = jax.grad(lambda v: jnp.sum(jnp.sqrt(v)))(j(x[:64]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
