"""The port's per-bounce telemetry (K5's plain version, ray_color(...,
debug=True)) against the JAX megakernels' debug output
(ray_color_pallas(..., interpret=True, debug=True)) on the same rays and
key: demo-box 16x16 (the K2 path, P <= 64) and sphere-grid 16x16 (the K3
path).

Bounds. Radiance through both packages differs on at most 2% of lanes
(tests/test_megakernel.py's knife-edge pin). The channels see the knife
edge before it reaches radiance: a ray leaving a surface starts ON it
(zero origin offset), so its extension query reports its own surface at t
~ 0 (a box face at tmin = 0, a sphere at t ~ 1e-7) in one package and
something else in the other, and the vertices after it follow different
paths. A lane's vertex is therefore compared while no earlier vertex of
the lane had such a self-hit (extension t below SELF_HIT in either
package), and its extension channels (xt, xp) only when that vertex's own
extension is not one. Only the cur channel is compared at a vertex where
the path has ended (cur = 0 in either package): the JAX stream kernel's
queries skip dead lanes, so their other channels are leftovers.

- the 0/1 channels (cur, is_specular) and the index channels (prim, xp)
  equal on every compared vertex, except on at most 2% of lanes (measured
  0 or 1 of 256);
- the float channels within rtol 1e-4 (atol 1e-6 for values near 0) on
  every compared vertex of the agreeing lanes, except on at most 10% of
  lanes (measured 9 to 18 of 256 demo-box lanes over runs, 9 of 256
  sphere-grid lanes): XLA's FMA contraction, amplified at grazing and far
  hits (t), along degenerate box frames (T_max, bs_f2) and at checker
  edges (the albedo flips), moves those by 2e-4 to O(1);
- the port's radiance with debug on equals radiance with it off, bit for
  bit.

On the K3 path JAX numbers primitives in its MegaPack order; its prim and
xp channels are mapped back to scene rows (scene_to_mega) and compared
where the query hit (t < T_MAX): on a miss JAX may report a padding row.
For the same reason xt is compared where either package's query hit.
Each JAX reference is computed once, in a module-scoped fixture.
"""

import jax
import numpy as np
import pytest
import torch

from plutracer_tpu.ops.camera import generate_rays as jax_generate_rays
from plutracer_tpu.ops.pallas import integrator_kernel as jik
from plutracer_tpu.render.renderer import pixel_centers as jax_pixel_centers
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu.semantics import DEFAULT_OPTIONS as JAX_OPTIONS
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.cuda import DBG_C, DBG_CHANNELS
from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_kernel
from plutracer_tpu_torch.render.integrator import draw_uniforms, ray_color
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

KEY = 7
RES = 16
SELF_HIT = 1e-5
T_MAX = 100000.0
FLAGS = (DBG_CHANNELS.index("cur"), DBG_CHANNELS.index("is_specular"))
INDEX = (DBG_CHANNELS.index("prim"), DBG_CHANNELS.index("xp"))
XT, XP, T, PRIM, CUR = (DBG_CHANNELS.index(c) for c in ("xt", "xp", "t", "prim", "cur"))


@pytest.fixture(scope="module")
def both():
    """name -> (port scene, o, d, JAX radiance, JAX telemetry)."""
    out = {}
    for name in ("demo-box", "sphere-grid"):
        args = ["/res", f"{RES}x{RES}"]
        js = jax_compile(jax_load(f"scenes/{name}.urn", args))
        ts = compile_scene(load_scene_file(f"scenes/{name}.urn", args), device="cpu")
        px0 = jax_pixel_centers(RES, RES)
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        o, d = jax_generate_rays(js.camera, px0 + jax.random.uniform(k1, px0.shape),
                                 jax.random.uniform(k2, px0.shape))
        o, d = np.asarray(o), np.asarray(d)
        L, dbg = jik.ray_color_pallas(js, o, d, jax.random.PRNGKey(KEY), JAX_OPTIONS,
                                      interpret=True, debug=True)
        dbg = np.array(dbg)
        if js.prim_type.shape[0] > jik.MAX_P:  # MegaPack ids -> scene rows
            s2m = np.asarray(js.prims_mega.scene_to_mega)
            m2s = np.full(int(s2m.max()) + 1, -1)
            m2s[s2m] = np.arange(s2m.size)
            for c, tc in ((PRIM, T), (XP, XT)):
                hit = dbg[:, tc] < T_MAX
                ids = np.clip(dbg[:, c].astype(np.int64), 0, m2s.size - 1)
                dbg[:, c] = np.where(hit, m2s[ids], dbg[:, c])
        out[name] = (ts, o, d, np.asarray(L), dbg)
    return out


def port_debug(ts, o, d):
    u = draw_uniforms(rng.PRNGKey(KEY), o.shape[0], DEFAULT_OPTIONS.max_bounces, "cpu")
    # the kernel entry point on CPU tensors is its plain version
    L, dbg = ray_color_kernel(ts, torch.tensor(o), torch.tensor(d), u, DEFAULT_OPTIONS,
                              debug=True)
    return u, L, dbg.numpy()


@pytest.mark.parametrize("name", ["demo-box", "sphere-grid"])
def test_debug_channels_match_jax(both, name):
    ts, o, d, _, jd = both[name]
    _, _, pd = port_debug(ts, o, d)
    mb, B = DEFAULT_OPTIONS.max_bounces, o.shape[0]
    assert pd.shape == jd.shape == (mb, DBG_C, B)
    self_hit = (np.abs(pd[:, XT]) < SELF_HIT) | (np.abs(jd[:, XT]) < SELF_HIT)
    before = np.concatenate([np.zeros((1, B), bool), np.cumsum(self_hit, 0)[:-1] > 0])
    cmp = ~before  # (mb, B): vertices reached without an earlier self-hit
    stream = name == "sphere-grid"
    # an ended path's channels are the JAX kernel's leftovers (its stream
    # query skips dead lanes), so only cur itself is compared there
    live = (pd[:, CUR] == 1) & (jd[:, CUR] == 1)
    mask = {c: cmp & (live if c != CUR else True) for c in range(DBG_C)}
    for c in (XT, XP):
        mask[c] &= ~self_hit
    mask[XT] &= (pd[:, XT] < T_MAX) | (jd[:, XT] < T_MAX)
    if stream:  # JAX ids are scene rows only where its query hit
        mask[PRIM] &= jd[:, T] < T_MAX
        mask[XP] &= jd[:, XT] < T_MAX
    index_lane = np.zeros(B, bool)
    for c in FLAGS + INDEX:
        index_lane |= ((pd[:, c] != jd[:, c]) & mask[c]).any(0)
    float_lane = np.zeros(B, bool)
    for c in set(range(DBG_C)) - set(FLAGS + INDEX):
        close = np.isclose(pd[:, c], jd[:, c], rtol=1e-4, atol=1e-6)
        float_lane |= (~close & mask[c]).any(0)
    assert index_lane.mean() <= 0.02, (
        f"{name}: {index_lane.sum()} of {B} lanes differ in a 0/1 or index channel")
    assert (float_lane & ~index_lane).mean() <= 0.10, (
        f"{name}: {(float_lane & ~index_lane).sum()} of {B} lanes differ in a float channel "
        "beyond rtol 1e-4")
    # the comparison covers most live vertices (the self-hit cut drops the rest)
    assert mask[T].sum() >= 0.5 * live.sum() > 0


@pytest.mark.parametrize("name", ["demo-box", "sphere-grid"])
def test_debug_leaves_radiance_unchanged(both, name):
    ts, o, d, jL, _ = both[name]
    u, L, _ = port_debug(ts, o, d)
    plain = ray_color(ts, torch.tensor(o), torch.tensor(d), u, DEFAULT_OPTIONS)
    assert torch.equal(L, plain)
    a, b = np.log1p(np.maximum(L.numpy(), 0.0)), np.log1p(np.maximum(jL, 0.0))
    assert (np.abs(a - b) > 1e-3).mean() <= 0.02


def test_debug_under_wavefront_takes_k3_channels(both):
    """debug=True under stream_wavefront gives the monolithic path's
    telemetry (K4 has none), as the JAX package does."""
    ts, o, d, _, _ = both["sphere-grid"]
    u, L, pd = port_debug(ts, o, d)
    L2, pd2 = ray_color_kernel(ts, torch.tensor(o), torch.tensor(d), u,
                               DEFAULT_OPTIONS.replace(stream_wavefront=True), debug=True)
    assert torch.equal(L, L2) and np.array_equal(pd, pd2.numpy())
