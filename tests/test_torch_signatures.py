"""The JAX package's signatures the port keeps: any int64 seed,
safemath.normalize(v, axis, eps), compile_scene(desc, options,
build_accel) and make_mesh(shape, axis_names, devices), each against the
JAX function; and its import paths: every name a JAX subpackage exports
(``__all__``) and the top level's public names are exported by the
port's counterpart, or mapped or left out by name in README.md; and
every public function and class each JAX module defines (ops.pallas and
__main__ aside), held to the port's at the same path: it takes every call
of the JAX one (signature_faults), one case a module.

Tolerances: normalize within 1 ulp-scale (rtol 1e-6) of the JAX function
(both compute v * rsqrt(sum(v * v) + eps); XLA's CPU rsqrt and torch's may
round apart by an ulp). Renders of a scene compiled with
build_accel=False against the JAX package's render of its own
build_accel=False compile: tests/test_golden.py's bounds (p99 of |log1p|
differences below 0.05, mean below 0.01), as tests/test_torch_render.py
holds the full compile.
"""

import dataclasses
import importlib
import inspect
import pathlib
import pkgutil
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plutracer_tpu
import plutracer_tpu_torch

from plutracer_tpu.ops.safemath import normalize as jax_normalize
from plutracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plutracer_tpu.render.renderer import render as jax_render
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.intersect import query_lite
from plutracer_tpu_torch.ops.safemath import normalize
from plutracer_tpu_torch.parallel import make_mesh
from plutracer_tpu_torch.render.integrator import megakernel_eligible, resolve_integrator_backend
from plutracer_tpu_torch.render.renderer import render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.types import ACCEL_FIELDS
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
W, H, N, SEED = 32, 24, 2, 42


# ---- seeds: every int64 seed jax.random.PRNGKey takes ----


def test_negative_seed_renders_as_jax(tmp_path):
    """/seed -1 through the CLI, and render_elastic at seed -1: the image
    of render at rng.PRNGKey(-1), and within the golden bounds of the
    JAX package's render at jax.random.PRNGKey(-1)."""
    from plutracer_tpu_torch import cli
    from plutracer_tpu_torch.render.elastic import render_elastic

    path = str(REPO / "scenes" / "dof.urn")
    res = cli.run([path, "/res", f"{W}x{H}", "/smp", str(N), "/seed", "-1", "/device", "cpu",
                   "/o", str(tmp_path / "m1.bmp")])
    assert (tmp_path / "m1.bmp").exists()
    scene = compile_scene(load_scene_file(path, ["/res", f"{W}x{H}"]), device="cpu")
    want = render(scene, W, H, N, rng.PRNGKey(-1))
    assert torch.equal(res.linear, want)
    assert np.array_equal(render_elastic(scene, W, H, N, -1, devices=[CPU]), want.numpy())
    ref = np.asarray(jax_render(jax_compile(jax_load(path, ["/res", f"{W}x{H}"])), W, H, N,
                                jax.random.PRNGKey(-1)))
    diff = np.abs(np.log1p(np.maximum(want.numpy(), 0.0)) - np.log1p(np.maximum(ref, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01


# ---- normalize(v, axis=-1, eps=1e-30) ----

CALLS = {  # how the axis and eps reach the function
    "axis 0 by position": ((0,), {}),
    "axis 1 by position": ((1,), {}),
    "axis -1 by position": ((-1,), {}),
    "axis 0 by keyword": ((), {"axis": 0}),
    "axis 1 by keyword": ((), {"axis": 1}),
    "axis -1 by keyword": ((), {"axis": -1}),
    "axis 0, eps by keyword": ((0,), {"eps": 0.25}),
    "eps by keyword": ((), {"eps": 0.25}),
}


@pytest.mark.parametrize("shape", [(3, 3), (4, 3), (5, 2)])
@pytest.mark.parametrize("call", list(CALLS))
def test_normalize_matches_jax(shape, call):
    args, kwargs = CALLS[call]
    v = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_normalize(jnp.asarray(v), *args, **kwargs))
    got = normalize(torch.from_numpy(v), *args, **kwargs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_normalize_last_axis_keeps_the_kernels_order():
    """Over a last axis of 3 the sum is safemath.dot's (x + y) + z, the
    order the kernels round in: bit-equal to it whatever the axis's
    spelling."""
    from plutracer_tpu_torch.ops.safemath import dot, safe_rsqrt

    v = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32))
    want = v * safe_rsqrt(dot(v, v) + 1e-30)[..., None]
    for got in (normalize(v), normalize(v, -1), normalize(v, axis=1)):
        assert torch.equal(got, want)


# ---- compile_scene(desc, options, build_accel, device) ----


def _bare(name, by_position):
    desc = load_scene_file(str(REPO / "scenes" / f"{name}.urn"), ["/res", f"{W}x{H}"])
    if by_position:
        return compile_scene(desc, DEFAULT_OPTIONS, False, "cpu")
    return compile_scene(desc, build_accel=False, device="cpu")


@pytest.mark.parametrize("by_position", [False, True], ids=["keyword", "position"])
def test_compile_without_accel_has_no_accelerator(by_position):
    s = _bare("demo-box", by_position)
    assert all(getattr(s, f) is None for f in ACCEL_FIELDS)
    assert s.device == CPU and s.to(CPU).prims_packed is None
    assert not megakernel_eligible(s, DEFAULT_OPTIONS)
    assert resolve_integrator_backend(s, DEFAULT_OPTIONS, "cuda") == "plain"
    full = compile_scene(load_scene_file(str(REPO / "scenes" / "demo-box.urn"),
                                         ["/res", f"{W}x{H}"]), device="cpu")
    assert all(getattr(full, f) is not None for f in ACCEL_FIELDS)


@pytest.mark.parametrize("name", ["demo-box", "dof"])
def test_render_without_accel_matches_jax(name):
    """The plain path over a scene compiled with build_accel=False against
    the JAX package's render of compile_scene(desc, build_accel=False)."""
    img = render(_bare(name, False), W, H, N, rng.PRNGKey(SEED)).numpy()
    path, args = str(REPO / "scenes" / f"{name}.urn"), ["/res", f"{W}x{H}"]
    ref = np.asarray(jax_render(jax_compile(jax_load(path, args), build_accel=False), W, H, N,
                                jax.random.PRNGKey(SEED)))
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(ref, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01, (
        np.quantile(diff, 0.99), diff.mean())


def test_render_without_accel_equals_full_compile_on_the_plain_path():
    """dof, whose phantom-hit cull moves no hit at this size: the render
    of the bare scene is bit-equal to the full compile's. (On demo-box the
    full compile's cull drops phantom sphere hits that the bare scene
    keeps, in the JAX package as here.)"""
    desc = load_scene_file(str(REPO / "scenes" / "dof.urn"), ["/res", f"{W}x{H}"])
    full = render(compile_scene(desc, device="cpu"), W, H, N, rng.PRNGKey(SEED))
    bare = render(compile_scene(desc, DEFAULT_OPTIONS, False, device="cpu"), W, H, N,
                  rng.PRNGKey(SEED))
    assert torch.equal(full, bare)


@pytest.mark.parametrize("engine", ["pallas", "bvh"])
def test_engines_that_need_the_accelerator_raise(engine):
    s = _bare("demo-box", True)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    opts = dataclasses.replace(DEFAULT_OPTIONS, intersect_backend=engine)
    with pytest.raises(ValueError, match="build_accel=False"):
        query_lite(s, o, d, opts)
    with pytest.raises(ValueError, match="build_accel=False"):
        render(s, 4, 4, 1, rng.PRNGKey(0), opts)


def test_forced_kernel_integrator_raises_without_accel():
    s = _bare("demo-box", False)
    opts = dataclasses.replace(DEFAULT_OPTIONS, integrator_backend="kernel")
    with pytest.raises(ValueError, match="build_accel=False"):
        resolve_integrator_backend(s, opts, "cuda")


# ---- make_mesh(shape, axis_names, devices) ----


def test_make_mesh_takes_jax_signature():
    cpus = [CPU] * 8
    want = jax_make_mesh((4, 2), ("tiles", "spp"), jax.devices()[:8])
    for m in (make_mesh((4, 2), ("tiles", "spp"), cpus),
              make_mesh((4, 2), ["tiles", "spp"], devices=cpus),
              make_mesh(shape=(4, 2), axis_names=("tiles", "spp"), devices=cpus),
              make_mesh((4, 2), devices=cpus)):
        assert m.axis_names == tuple(want.axis_names)
        assert m.shape == dict(want.shape)
    assert make_mesh(None, ("tiles", "spp"), [CPU] * 3).shape == {"tiles": 3, "spp": 1}


@pytest.mark.parametrize("second", [[CPU] * 4, (CPU, CPU), ("spp", "tiles"), ("x", "y"),
                                    "tiles", ("tiles",)], ids=repr)
def test_make_mesh_refuses_other_axes(second):
    """The port's meshes are (tiles, spp) grids: other axis names, and a
    device list in the old second place, raise ValueError."""
    with pytest.raises(ValueError, match="axis_names"):
        make_mesh((2, 2), second)


# ---- the JAX package's import paths ----

JAX_SUBPACKAGES = sorted(m.name for m in pkgutil.iter_modules(plutracer_tpu.__path__) if m.ispkg)


def _readme_names():
    """(the JAX names README's name table maps, the names its "Left out on
    purpose" paragraph names), as written in backticks."""
    text = (REPO / "README.md").read_text()
    table = text.split("Names of the JAX package with a counterpart under another name", 1)[1]
    rows = [row for row in table.lstrip(":\n").split("\n\n", 1)[0].splitlines()
            if row.startswith("| `")]
    mapped = {m for row in rows for m in re.findall(r"`([\w.]+)", row.split("|")[1])}
    left_out = text.split("Left out on purpose", 1)[1].split("\n\n", 1)[0]
    return mapped, set(re.findall(r"`([\w.]+)`", left_out))


def _public(mod):
    """A module's exported names: its __all__, else its public attributes
    that are not modules (the top level of both packages has no __all__)."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n in vars(mod) if not n.startswith("_") and not inspect.ismodule(getattr(mod, n))]


@pytest.mark.parametrize("sub", ["", *JAX_SUBPACKAGES])
def test_jax_import_paths_have_counterparts(sub):
    """Each name plutracer_tpu[.sub] exports is exported by
    plutracer_tpu_torch[.sub], or README's name table maps
    sub.<module>.<name> to another name, or README leaves it out."""
    jmod = importlib.import_module("plutracer_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("plutracer_tpu_torch" + (f".{sub}" if sub else ""))
    mapped, left_out = _readme_names()
    missing = []
    for name in _public(jmod):
        if hasattr(tmod, name) or name in left_out:
            continue
        if not any(m.split(".")[0] == sub and m.split(".")[-1] == name for m in mapped):
            missing.append(name)
    assert not missing, f"plutracer_tpu{'.' + sub if sub else ''}: {missing} have no counterpart"
    for name in getattr(tmod, "__all__", []):
        assert getattr(tmod, name) is not None, name


def test_reexports_are_the_modules_functions():
    """The re-exported names are the port modules' own objects."""
    from plutracer_tpu_torch import diff, render, scene, semantics, utils
    from plutracer_tpu_torch.diff import optimize
    from plutracer_tpu_torch.render import integrator, renderer
    from plutracer_tpu_torch.scene import types
    from plutracer_tpu_torch.utils import profiling

    assert plutracer_tpu_torch.RenderOptions is semantics.RenderOptions
    assert (render.render, render.render_image, render.ray_color) == (
        renderer.render, renderer.render_image, integrator.ray_color)
    assert (diff.InverseRenderConfig, diff.optimize_scene) == (
        optimize.InverseRenderConfig, optimize.optimize_scene)
    assert (utils.PhaseTimer, utils.RenderStats, utils.profile_trace) == (
        profiling.PhaseTimer, profiling.RenderStats, profiling.profile_trace)
    assert scene.CameraParams is types.CameraParams
    for name in [n for n in plutracer_tpu.scene.__all__ if n.isupper()]:
        assert getattr(scene, name) == getattr(plutracer_tpu.scene, name), name


def test_each_subpackage_imports_first_without_a_cycle():
    """In a fresh process, each port subpackage imported first (the port's
    modules dropped between them) imports cleanly: no cycle, no jax, and
    no CUDA initialisation."""
    subs = [m.name for m in pkgutil.iter_modules(plutracer_tpu_torch.__path__) if m.ispkg]
    code = f"""
import importlib, sys, torch
for sub in {["", *subs]!r}:
    for m in [m for m in sys.modules if m.startswith("plutracer_tpu_torch")]:
        del sys.modules[m]
    importlib.import_module("plutracer_tpu_torch" + ("." + sub if sub else ""))
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "plutracer_tpu."))]
assert not torch.cuda.is_initialized()
print("ok", len({subs!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr[-2000:]


# ---- every exported signature of the JAX package ----

JAX_MODULES = ["", *sorted(
    m.name[len("plutracer_tpu."):]
    for m in pkgutil.walk_packages(plutracer_tpu.__path__, "plutracer_tpu.")
    if not m.name.startswith("plutracer_tpu.ops.pallas") and not m.name.endswith("__main__"))]
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _defined(mod):
    """The public functions and classes a module defines (not those it
    imports)."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == mod.__name__}


def signature_faults(jobj, tobj):
    """How the port's `tobj` would refuse a call of the JAX package's
    `jobj`: JAX's positional parameters must be, in order, the first of the
    port's, by the same names and kinds; JAX's keyword-only ones must be
    keywords of the port; a JAX default must be a port default; JAX's
    *args and **kw must be the port's; and every further parameter of the
    port must be keyword-only or have a default."""
    try:
        js = inspect.signature(jobj)
    except (TypeError, ValueError):  # a class of a builtin base (an exception)
        return [] if inspect.isclass(tobj) else ["a class in JAX, not in the port"]
    ts = inspect.signature(tobj)
    jp, tp = list(js.parameters.values()), list(ts.parameters.values())
    jpos, tpos = [p for p in jp if p.kind in POSITIONAL], [p for p in tp if p.kind in POSITIONAL]
    faults = []
    if [(p.name, p.kind) for p in jpos] != [(p.name, p.kind) for p in tpos[:len(jpos)]]:
        faults.append(f"positional {[p.name for p in jpos]} are not the first of "
                      f"{[p.name for p in tpos]}")
    byname = {p.name: p for p in tp}
    for p in jp:
        q = byname.get(p.name)
        if p.kind is inspect.Parameter.KEYWORD_ONLY and (q is None or q.kind in VARIADIC
                                                         or q.kind is q.POSITIONAL_ONLY):
            faults.append(f"keyword {p.name} missing")
        if p.kind in VARIADIC and not any(q.kind is p.kind for q in tp):
            faults.append(f"{p} missing")
        if p.default is not p.empty and q is not None and q.default is q.empty \
                and q.kind not in VARIADIC:
            faults.append(f"{p.name} has no default")
    known = {p.name for p in jp}
    for q in tp[len(jpos):]:
        if q.name not in known and q.kind not in VARIADIC and q.default is q.empty \
                and q.kind is not q.KEYWORD_ONLY:
            faults.append(f"further parameter {q.name} is positional without a default")
    return faults


@pytest.mark.parametrize("sub", JAX_MODULES, ids=lambda s: s or "plutracer_tpu")
def test_jax_signatures_held(sub):
    """Each public function and class a JAX module defines has a
    counterpart of the same name in the port's module of the same path
    that takes every call of the JAX one (signature_faults). A name the
    port lacks at that path must be mapped by README's name table or left
    out by its "Left out on purpose" paragraph; no other name is exempt."""
    jmod = importlib.import_module("plutracer_tpu" + (f".{sub}" if sub else ""))
    try:
        tmod = importlib.import_module("plutracer_tpu_torch" + (f".{sub}" if sub else ""))
    except ModuleNotFoundError:
        tmod = None
    mapped, left_out = _readme_names()
    faults = {}
    for name, jobj in _defined(jmod).items():
        if tmod is None or not hasattr(tmod, name):
            if f"{sub}.{name}" not in mapped and name not in left_out:
                faults[name] = ["no counterpart"]
            continue
        got = signature_faults(jobj, getattr(tmod, name))
        if got:
            faults[name] = got
    assert not faults, f"plutracer_tpu{'.' + sub if sub else ''}: {faults}"
