"""The port's own copies of the JAX package's front end (urn, io.bmp,
io.font, semantics, native) against the originals: the same values, the
same pixels, the same fields. Exact comparisons throughout (host code with
the same semantics)."""

import dataclasses
import pathlib

import numpy as np
import pytest

from plutracer_tpu import native as jax_native
from plutracer_tpu import semantics as jax_semantics
from plutracer_tpu import urn as jax_urn
from plutracer_tpu.io import bmp as jax_bmp
from plutracer_tpu.io import font as jax_font
from plutracer_tpu.urn import repl as jax_repl
from plutracer_tpu_torch import native, semantics, urn
from plutracer_tpu_torch.io import bmp, font
from plutracer_tpu_torch.urn import repl
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENES = sorted(p.name for p in (REPO / "scenes").glob("*.urn"))


@pytest.mark.parametrize("name", SCENES)
def test_urn_evaluates_scenes_as_jax(name):
    text = (REPO / "scenes" / name).read_text()
    assert str(urn.parse(text)) == str(jax_urn.parse(text))
    got = urn.EvalContext().create_std_funcs().reduce(urn.parse(text))
    want = jax_urn.EvalContext().create_std_funcs().reduce(jax_urn.parse(text))
    assert str(got) == str(want)


def test_urn_repl_as_jax():
    import io

    lines = "x: 2 + 3\n(x * 4)\nfunc [a] [a + 1]\n:!q\n"
    outs = []
    for mod in (repl, jax_repl):
        out = io.StringIO()
        mod.run_repl(io.StringIO(lines), out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and "urn>" in outs[0]


def test_bmp_round_trip_and_text_pixels_equal(tmp_path):
    g = np.random.default_rng(0)
    img = g.uniform(0.0, 1.0, (13, 17, 3)).astype(np.float32)
    ours, theirs = tmp_path / "a.bmp", tmp_path / "b.bmp"
    bmp.write_bmp(str(ours), img)
    jax_bmp.write_bmp(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(bmp.read_bmp(str(theirs)), jax_bmp.read_bmp(str(ours)))
    swirl = str(REPO / "scenes" / "swirl.bmp")
    np.testing.assert_array_equal(bmp.read_bmp(swirl), jax_bmp.read_bmp(swirl))
    canvas = np.zeros((40, 120, 3), np.float32)
    text = "init 12 ms\nrender 3.5 s"
    np.testing.assert_array_equal(font.draw_text(canvas.copy(), text, (2, 3), (1.0, 0.5, 0.0)),
                                  jax_font.draw_text(canvas.copy(), text, (2, 3), (1.0, 0.5, 0.0)))


def test_render_options_fields_and_defaults_equal():
    ours = [(f.name, f.default) for f in dataclasses.fields(semantics.RenderOptions)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jax_semantics.RenderOptions)]
    assert ours == theirs
    for name in ("DEFAULT_OPTIONS", "TEXTBOOK_OPTIONS"):
        assert dataclasses.asdict(getattr(semantics, name)) == \
            dataclasses.asdict(getattr(jax_semantics, name))
    assert semantics.RenderOptions is not jax_semantics.RenderOptions


def test_native_builds_its_own_library_and_matches():
    """The port's native helpers build into the port's _build/, never into
    native/, and give the JAX package's BVH and OBJ results."""
    before = sorted(p.name for p in (REPO / "native").iterdir())
    if not native.available():
        pytest.skip("no C++ compiler: the pure-Python fallbacks run instead")
    assert sorted(p.name for p in (REPO / "native").iterdir()) == before
    assert native._library_path().parent == REPO / "plutracer_tpu_torch" / "_build"
    g = np.random.default_rng(0)
    prims = np.concatenate([np.zeros((9, 1)), g.uniform(-1, 1, (9, 9))], 1).astype(np.float32)
    prims[:, 4:7] = np.abs(prims[:, 4:7]) * 0.1 + 0.01  # sphere radius column
    got, want = native.build_bvh_native(prims), jax_native.build_bvh_native(prims)
    if want is None:
        pytest.skip("the JAX package's native library is unavailable here")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    obj = str(REPO / "scenes" / "asteroid.obj")
    for a, b in zip(native.load_obj_native(obj), jax_native.load_obj_native(obj)):
        np.testing.assert_array_equal(a, b)
