"""The stream kernels' walk layout (scene/compile.walk_tables) and its
plain walk (walk_closest_plain, the K3 query's plain version), against
the brute-force closest hit and the JAX package's BVH walk; the pass
loop's batching of strata; the compile's default device; what a dead
wavefront lane may leave stale.

Tolerances: none where both sides run the same arithmetic. The walk
tests the same packed rows with K1's arithmetic as closest_hit_plain and
fold the lexicographic minimum of (t, packed row), so found and prim are
equal bit for bit on every ray and t on every hit (on a miss a walk
reports _BIG, where the brute force may report a padding row about 1e30
away). Against JAX's ops.bvh.bvh_closest (XLA's arithmetic,
FMA-contracted) found and the winner are equal and t agrees to 1e-4
relative, as in tests/test_torch_bvh.py. The batched pass loop and the
poisoned wavefront carry are bit-equal to their references.
"""

import types

import numpy as np
import pytest
import torch

from plutracer_tpu.ops.bvh import bvh_closest as jax_bvh_closest
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_plain, walk_closest_plain
from plutracer_tpu_torch.ops.intersect import T_MAX
from plutracer_tpu_torch.render import renderer
from plutracer_tpu_torch.render.integrator import draw_uniforms, ray_color_plain
from plutracer_tpu_torch.render.renderer import pixel_centers
from plutracer_tpu_torch.render.wavefront import ray_color_wavefront
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.compile import (
    WALK_LEAF_ROWS,
    WALK_STACK,
    bvh_helpers,
    walk_tables,
)
from plutracer_tpu_torch.scene.loader import sphere_cloud
from plutracer_tpu_torch.scene.types import PRIM_SPHERE, PRIM_TRIANGLE, PrimDesc, SceneDesc
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

BRUTE_CHUNK = 256  # rays per closest_hit_plain call: it builds a (B, P) matrix


def layout_walk(s, o, d, **kw):
    return walk_closest_plain(s.prims_packed, s.walk_nodes, s.walk_rows, o, d, **kw)


_SCENES = {}


def load(name, res=16):
    if (name, res) not in _SCENES:
        if name == "cloud":
            desc = sphere_cloud(512, seed=0)
        else:
            desc = load_scene_file(f"scenes/{name}.urn", ["/res", f"{res}x{res}"])
        _SCENES[name, res] = compile_scene(desc, device="cpu")
    return _SCENES[name, res]


def camera_rays(s, res=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    px = pixel_centers(res, res) + torch.rand((res * res, 2), generator=g)
    return generate_rays(s.camera, px, torch.rand((res * res, 2), generator=g))


def interior_rays(s, n, seed=1, unit=False):
    """Origins inside the root box; directions of random length (0.5 to
    1.5) unless unit: a non-unit ray makes phantom sphere hits."""
    g = np.random.default_rng(seed)
    lo, hi = s.bvh.node_min[0].numpy(), s.bvh.node_max[0].numpy()
    o = lo + (hi - lo) * g.uniform(size=(n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if not unit:
        d *= g.uniform(0.5, 1.5, (n, 1))
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def cloud_rays(n, seed=2):
    """proto_bigp.py's rays: origins in [-12, 12]^3, unit directions."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(g.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def brute_force(s, o, d):
    parts = [closest_hit_plain(s.prims_packed, o[i:i + BRUTE_CHUNK], d[i:i + BRUTE_CHUNK])
             for i in range(0, o.shape[0], BRUTE_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*parts))


def assert_answers_equal(got, want):
    for name, a, b in zip(("found", "prim"), got, want):
        assert torch.equal(a, b), f"{name}: {(a != b).sum().item()} rays differ"
    f = want[0]
    assert torch.equal(got[2][f], want[2][f]), f"t: {(got[2] != want[2])[f].sum().item()} differ"
    assert (got[2][~f] >= T_MAX).all()


CASES = [("sphere-grid", 16), ("mesh0", 16), ("mesh1", 12), ("cloud", 0)]


@pytest.mark.parametrize("rays", ["camera", "interior"])
@pytest.mark.parametrize("name,res", CASES, ids=[c[0] for c in CASES])
def test_walk_equals_brute_force(name, res, rays):
    """Camera rays (the cloud's are proto_bigp's random rays) and non-unit
    rays from inside the scene, whose phantom sphere hits only the
    parent-AABB cull removes."""
    s = load(name, max(res, 8))
    if rays == "interior":
        o, d = interior_rays(s, 1024 if name != "mesh1" else 512)
    else:
        o, d = camera_rays(s, res) if res else cloud_rays(1024)
    want = brute_force(s, o, d)
    assert want[0].float().mean() > 0.1
    assert_answers_equal(layout_walk(s, o, d), want)


@pytest.mark.parametrize("side", [1.0, -1.0], ids=["above", "below"])
def test_tie_goes_to_lower_packed_row(side):
    """Two triangles sharing an edge, a ray through the edge from either
    side: both give t = 1 exactly. The walk tests scene row 1 first, so
    only the (t, row) fold keeps row 0, as K1 does."""
    tri = lambda a, b, c: PrimDesc(PRIM_TRIANGLE, *(np.array(v, np.float32) for v in (a, b, c)))
    desc = SceneDesc()
    desc.add_prim(tri((1, 0, 0), (0, 1, 0), (1, 1, 0)))
    desc.add_prim(tri((1, 0, 0), (0, 1, 0), (-2, -2, 0)))
    desc.add_prim(tri((10, 0, 0), (11, 0, 0), (10, 1, 0)))
    s = compile_scene(desc, device="cpu")
    assert s.walk_rows[:2, 10].tolist() == [1.0, 0.0]  # leaf order: row 1 first
    o = torch.tensor([[0.5, 0.5, side]])
    d = torch.tensor([[0.0, 0.0, -side]])
    f, p, t = layout_walk(s, o, d)
    assert f.item() and p.item() == 0 and t.item() == 1.0


@pytest.mark.parametrize("name,jres", [("sphere-grid", 16), ("mesh1", 12)])
def test_walk_winners_equal_jax_bvh_closest(name, jres):
    js = jax_compile(jax_load(f"scenes/{name}.urn", ["/res", f"{jres}x{jres}"]))
    s = load(name, jres)
    for o, d in (camera_rays(s, jres), interior_rays(s, 256, unit=True)):
        f, p, t = layout_walk(s, o, d)
        jf, jp, jt = (np.asarray(x) for x in jax_bvh_closest(js, js.bvh, o.numpy(), d.numpy()))
        np.testing.assert_array_equal(f.numpy(), jf)
        np.testing.assert_array_equal(p.numpy()[jf], jp[jf])
        np.testing.assert_allclose(t.numpy()[jf], jt[jf], rtol=1e-4)


@pytest.mark.parametrize("name", ["sphere-grid", "mesh0", "cloud"])
def test_any_hit_found_equals_closest(name):
    """The shadow walk of a point light: found as the closest walk's, on
    unit and non-unit rays; where found, a real row under T_MAX."""
    s = load(name)
    for unit in (True, False):
        o, d = interior_rays(s, 1024, seed=3, unit=unit)
        f, _, _ = layout_walk(s, o, d)
        af, ap, at = layout_walk(s, o, d, any_hit=True)
        assert torch.equal(af, f) and f.any() and (~f).any()
        assert (at[af] < T_MAX).all() and (at[~af] >= T_MAX).all() and (ap[~af] == 0).all()


def subtree_rows(nodes):
    """(first, end) walk-row range of each node's subtree, and of each
    child: leaves hold contiguous rows and subtrees are depth-first."""
    refs = nodes[:, 12:14].tolist()
    span = [None] * len(refs)

    def child_span(ref):
        if ref < 0:
            code = -1 - ref
            return code >> 2, (code >> 2) + (code & 3) + 1
        return span[ref]

    for i in reversed(range(len(refs))):  # children follow their parent
        kids = [child_span(r) for r in refs[i] if r != 0]
        span[i] = (min(k[0] for k in kids), max(k[1] for k in kids))
    return span, child_span


@pytest.mark.parametrize("name", ["demo-box", "sphere-grid", "mesh0", "cloud"])
def test_walk_layout(name):
    """Rows: each packed row once, col 10 its packed index, in leaf order.
    Nodes: leaves of 1 to WALK_LEAF_ROWS rows, the stack deep enough, each
    child's LINE flag set exactly when its subtree holds a sphere, and
    every child box (padded) holding its rows' primitive boxes and its
    spheres' cull boxes (packed cols 11:17), which the LINE test needs."""
    s = load(name)
    nodes, rows = s.walk_nodes, s.walk_rows
    assert nodes.dtype == torch.int32 and nodes.shape[1] == 16 and rows.shape == (s.num_prims, 20)
    prow = rows[:, 10].long()
    leaf_row = bvh_helpers(s.prim_type, s.bvh)["leaf_row"]
    assert sorted(prow.tolist()) == sorted(leaf_row[leaf_row >= 0].tolist())
    assert torch.equal(rows[:, :10], s.prims_packed[prow, :10])
    assert torch.equal(rows[:, 11:17], s.prims_packed[prow, 11:17])
    depth = walk_tables(s.prim_type, s.bvh, s.prims_packed)["walk_depth"]
    assert depth + 1 <= WALK_STACK
    span, child_span = subtree_rows(nodes)
    assert span[0] == (0, s.num_prims)
    boxes = nodes.view(torch.float32)[:, :12].reshape(-1, 2, 2, 3)  # node, child, lo/hi, xyz
    sphere = rows[:, 0] == PRIM_SPHERE
    a, b = rows[:, 1:4], rows[:, 4:7]
    r = b[:, :1]
    prim_lo = torch.where(sphere[:, None], a - r, torch.minimum(torch.minimum(a, b), rows[:, 7:10]))
    prim_hi = torch.where(sphere[:, None], a + r, torch.maximum(torch.maximum(a, b), rows[:, 7:10]))
    box = rows[:, 0] == 1
    prim_lo = torch.where(box[:, None], a, prim_lo)
    prim_hi = torch.where(box[:, None], b, prim_hi)
    cull = sphere & (rows[:, 14] < 3.0e38)
    for i in range(nodes.shape[0]):
        for side in (0, 1):
            ref = int(nodes[i, 12 + side])
            if ref == 0:
                continue
            lo, hi = child_span(ref)
            if ref < 0:
                assert 1 <= hi - lo <= WALK_LEAF_ROWS
            line = bool((int(nodes[i, 14]) >> side) & 1)
            assert line == bool(sphere[lo:hi].any()), (i, side)
            blo, bhi = boxes[i, side, 0], boxes[i, side, 1]
            assert (prim_lo[lo:hi] >= blo).all() and (prim_hi[lo:hi] <= bhi).all(), (i, side)
            c = cull[lo:hi]
            assert (rows[lo:hi][c, 11:14] >= blo).all() and (rows[lo:hi][c, 14:17] <= bhi).all()


def test_walk_count_mode():
    """The count mode (what chip_smoke.py counts the walks' work with)
    answers as the walk does; every walk visits the root, a hit visits a
    leaf, a leaf tests 1 to WALK_LEAF_ROWS rows, each counted by its type;
    on mesh0 a walk visits a
    small part of the layout, and the any-hit walk no more than the
    closest walk."""
    s = load("mesh0")
    o, d = interior_rays(s, 1024, unit=True)
    found, prim, t, nodes, leaves, by_type = layout_walk(s, o, d, count=True)
    assert_answers_equal((found, prim, t), layout_walk(s, o, d))
    absent = torch.tensor([r == 0 for r in s.packed_type_rows])
    assert by_type.shape == (o.shape[0], 3) and (by_type[:, absent] == 0).all()
    rows = by_type.sum(1)
    assert (nodes >= 1).all() and (leaves[found] >= 1).all()
    assert (leaves <= rows).all() and (rows <= leaves * WALK_LEAF_ROWS).all()
    assert (nodes + leaves).float().mean() < 0.25 * s.walk_nodes.shape[0]
    any_nodes = layout_walk(s, o, d, any_hit=True, count=True)[3]
    assert any_nodes.float().mean() <= nodes.float().mean()


def test_render_passes_batches_strata_in_order(monkeypatch):
    """The kernel path's bookkeeping, with a stand-in radiance on the CPU:
    strata are drawn in order, traced 3 a call, and accumulated in order,
    bit-equal to one stratum a call; the last call takes what remains."""
    s = load("demo-box", 8)
    calls = []

    def stand_in(scene, o, d, u, options):
        calls.append(o.shape[0])
        return (o + d * u[0, :, :3]) * u[1, :, 3:4]

    monkeypatch.setattr(renderer, "radiance_of_uniforms", stand_in)
    key = rng.PRNGKey(3)
    one = renderer.render_passes(s, key, 2, 8, 6, 4, 7)
    assert calls == [48] * 7
    calls.clear()
    monkeypatch.setattr(renderer, "strata_per_launch", lambda scene, options, rays: 3)
    batched = renderer.render_passes(s, key, 2, 8, 6, 4, 7)
    assert calls == [144, 144, 48]
    assert torch.equal(batched, one)
    # the same sum, stratum by stratum in order
    acc = torch.zeros((48, 3))
    px0 = pixel_centers(8, 6)
    for st in range(2, 9):
        o, d, u = renderer._stratum_rays(s, px0, rng.fold_in(key, st), st, 4, DEFAULT_OPTIONS)
        acc = acc + stand_in(s, o, d, u, DEFAULT_OPTIONS)
    assert torch.equal(batched, acc)


def test_strata_per_launch(monkeypatch):
    """One stratum a call off the kernel path (a CPU scene, even with the
    kernel backend forced); on the kernel path of a CUDA scene enough
    strata for LAUNCH_RAYS rays, at most MAX_STRATA."""
    s = load("demo-box", 8)
    forced = DEFAULT_OPTIONS.replace(integrator_backend="kernel")
    assert renderer.strata_per_launch(s, DEFAULT_OPTIONS, 65536) == 1
    assert renderer.strata_per_launch(s, forced, 65536) == 1
    monkeypatch.setattr(renderer, "resolve_integrator_backend", lambda scene, opts, dev: "kernel")
    card = types.SimpleNamespace(device=torch.device("cuda"))
    per = [renderer.strata_per_launch(card, DEFAULT_OPTIONS, r) for r in (65536, 262144, 262145, 3072)]
    assert per == [4, 1, 1, 16]


def test_compile_scene_defaults_to_the_card(monkeypatch):
    desc = load_scene_file("scenes/demo-box.urn", ["/res", "8x8"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_scene(desc)
    assert compile_scene(desc, device="cpu").device == torch.device("cpu")


def test_dead_lanes_leave_prim_and_t_stale():
    """A lane that has ended (alive 0) may carry any prim and t: K4 leaves
    prim 0 and t BIG where it skips the extension query, plain_bounce the
    query's answer. Poisoning both fields of every dead lane after every
    step leaves the wavefront radiance bit-equal, for every sort; the
    other fields of a dead lane are the same in K4 and plain_bounce."""
    from plutracer_tpu_torch.ops.cuda.stream_kernel import onebounce_plain

    s = load("mesh0", 8)
    o, d = camera_rays(s, 8)
    u = draw_uniforms(rng.PRNGKey(4), o.shape[0], DEFAULT_OPTIONS.max_bounces, "cpu")
    g = torch.Generator().manual_seed(0)

    def poisoned(scene, tables, wave, i, perm, options):
        onebounce_plain(scene, tables, wave, i, perm, options)
        out = wave.carry_next  # the carry the next step reads
        dead = out[:, 13] == 0.0
        out[dead, 14] = torch.randint(0, scene.num_prims, (int(dead.sum()),), generator=g).float()
        out[dead, 15] = torch.rand(int(dead.sum()), generator=g) * 10.0

    for sort in ("none", "morton"):
        opts = DEFAULT_OPTIONS.replace(stream_wavefront=True, stream_sort=sort)
        want = ray_color_wavefront(s, o, d, u, opts, step=onebounce_plain)
        assert torch.equal(ray_color_wavefront(s, o, d, u, opts, step=poisoned), want)
    assert torch.equal(want, ray_color_plain(s, o, d, u, DEFAULT_OPTIONS))
