"""The port's diagnostics against the JAX package's: utils/profiling
(PhaseTimer, RenderStats, profile_trace), renderer.render_image, the
plain integrator's terms=True split and the term_dump / term_diff tools.

Bounds: the reports equal the JAX package's strings; images and terms
against JAX within the golden bounds of tests/test_golden.py (|log1p|
difference p99 < 0.05, mean < 0.01; XLA contracts products into FMAs, so
knife-edge lanes differ); the sum of the terms equals the radiance within
1e-6 of its largest entry (the radiance is summed in float32 vertex by
vertex, the terms in float64 after). The JAX dump runs tools/term_dump.py
at n = 1, so its terms are one call of the JAX integrator's
ray_color(terms=True), on pass 0 of seed 0: the same call the port's split
is held against. Under the default options the NEE BSDF term is zero in
both packages (the shading-normal gate), so the split is also held
against one more JAX call of the same pass without the gate, where that
term carries radiance. The JAX runs are two subprocesses started when this
module starts, so their compiles overlap the tests.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from plutracer_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from plutracer_tpu.utils.profiling import RenderStats as JaxRenderStats
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.render.integrator import radiance_of_uniforms, ray_color_plain
from plutracer_tpu_torch.render.renderer import _stratum_rays, pixel_centers, render, render_image
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from plutracer_tpu_torch.tools import term_diff, term_dump
from plutracer_tpu_torch.utils.profiling import PhaseTimer, RenderStats, profile_trace
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
DEMO = str(REPO / "scenes" / "demo-box.urn")
RES = 48  # the dumps' size: term_diff's 16x16 blocks of 3x3 pixels
PLAIN = DEFAULT_OPTIONS.replace(integrator_backend="plain")


def golden_close(a, b, what=""):
    diff = np.abs(np.log1p(np.maximum(a, 0.0)) - np.log1p(np.maximum(b, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01, (what, np.quantile(diff, 0.99),
                                                                    diff.mean())


# the JAX package's render_image, and pass 0 of seed 0 (n = 1) through its
# ray_color(terms=True) without the shading-normal gate, with
# tools/term_dump.py's rays; the terms as (B, 3 terms, nb, 3)
RENDER_IMAGE_AND_UNGATED = """
import jax, jax.numpy as jnp, numpy as np
from plutracer_tpu.ops.camera import generate_rays
from plutracer_tpu.render.integrator import ray_color
from plutracer_tpu.render.renderer import pixel_centers, render_image
from plutracer_tpu.scene import compile_scene, load_scene_file
from plutracer_tpu.semantics import DEFAULT_OPTIONS
s = compile_scene(load_scene_file({demo!r}, ['/res', '32x24']))
np.save({image!r}, np.asarray(render_image(s, 32, 24, 2, seed=0)))
s = compile_scene(load_scene_file({demo!r}, ['/res', '{res}x{res}', '/smp', '1']))
px0 = pixel_centers({res}, {res})
k_px, k_lens, k_path = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), 3)
px = px0 + jax.random.uniform(k_px, px0.shape) * 0.999
o, d = generate_rays(s.camera, px, jax.random.uniform(k_lens, px0.shape) * 0.999)
opts = DEFAULT_OPTIONS.replace(integrator_backend='xla', shading_normal_le_gate=False)
_, ys = jax.jit(lambda o, d, k: ray_color(s, o, d, k, opts, terms=True))(o, d, k_path)
np.save({ungated!r}, np.asarray(ys).transpose(2, 1, 0, 3))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """tools/term_dump.py (n = 1), and the JAX package's render_image and
    ungated split, in two subprocesses; yields a function that waits for
    them and returns (the dump's base path, the tonemapped image, the
    ungated terms)."""
    tmp = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""), "--xla_cpu_multi_thread_eigen=false"]))
    image, ungated = tmp / "render_image.npy", tmp / "ungated.npy"
    code = RENDER_IMAGE_AND_UNGATED.format(demo=DEMO, image=str(image), res=RES,
                                           ungated=str(ungated))
    procs = [subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd in (
        [sys.executable, "tools/term_dump.py", DEMO, str(tmp / "jax"), "--res", str(RES),
         "--smp", "1", "--seed", "0", "--platform", "cpu"],
        [sys.executable, "-c", code])]

    def result():
        for proc in procs:
            log = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, log[-3000:]
        return tmp / "jax", np.load(image), np.load(ungated)

    yield result
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("w,h,spp,seconds,mb", [(512, 512, 64, 2.5, 8), (32, 24, 4, 0.0, 8),
                                                 (640, 480, 9, 1234.5678, 3)])
def test_render_stats_equal_jax(w, h, spp, seconds, mb):
    got, want = RenderStats(w, h, spp, seconds, mb), JaxRenderStats(w, h, spp, seconds, mb)
    assert got.report() == want.report()
    assert (got.samples, got.samples_per_sec, got.rays_per_sec_upper) == (
        want.samples, want.samples_per_sec, want.rays_per_sec_upper)


def test_phase_timer_equal_jax():
    got, want = PhaseTimer(), JaxPhaseTimer()
    for t in (got, want):
        t.phases.update({"init": 0.0123456, "render": 1.23456789, "postprocess": 0.5})
    assert got.report() == want.report() and got.as_json() == want.as_json()
    for _ in range(2):
        with got.phase("render"):
            pass
    assert got.phases["render"] > 1.23456789 and list(got.phases) == list(want.phases)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """profile_trace(log_dir), the JAX package's call: the directory is
    made and the trace written inside it."""
    s = compile_scene(load_scene_file(DEMO, ["/res", "8x6"]), device="cpu")
    with profile_trace(str(tmp_path / "prof")):
        render(s, 8, 6, 1, rng.PRNGKey(0))
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_profile_trace_accumulates_in_its_directory(tmp_path):
    """Two traces into one directory are two files, as the JAX profiler's
    runs accumulate in its log_dir; with no card in use no CUDA activity
    is recorded."""
    s = compile_scene(load_scene_file(DEMO, ["/res", "8x6"]), device="cpu")
    for _ in range(2):
        with profile_trace(str(tmp_path)) as prof:
            render(s, 8, 6, 1, rng.PRNGKey(0))
        assert torch.profiler.ProfilerActivity.CUDA not in prof.activities
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 2


def test_render_image_within_golden_bounds_of_jax(jax_runs):
    s = compile_scene(load_scene_file(DEMO, ["/res", "32x24"]), device="cpu")
    img = render_image(s, 32, 24, 2, seed=0)
    assert img.shape == (24, 32, 3) and bool(torch.isfinite(img).all()) and float(img.min()) >= 0
    golden_close(img.numpy(), jax_runs()[1])


def _pass0(s):
    """Pass 0 of a seed-0, n = 1 render: rays and uniforms."""
    return _stratum_rays(s, pixel_centers(RES, RES), rng.fold_in(rng.PRNGKey(0), 0), 0, 1, PLAIN)


def test_terms_split_matches_jax(jax_runs):
    s = compile_scene(load_scene_file(DEMO, ["/res", f"{RES}x{RES}"]), device="cpu")
    o, d, u = _pass0(s)
    L, ys = ray_color_plain(s, o, d, u, PLAIN, terms=True)
    assert ys.shape == (PLAIN.max_bounces, 3, RES * RES, 3)
    assert torch.equal(L, ray_color_plain(s, o, d, u, PLAIN))  # terms=False: the same bits
    L64 = L.double().numpy()
    assert np.abs(ys.double().sum((0, 1)).numpy() - L64).max() <= 1e-6 * np.abs(L64).max()
    base, _, jungated = jax_runs()
    nb = PLAIN.max_bounces
    jterms = np.fromfile(f"{base}.terms.f32", np.float32).reshape(RES * RES, 3, nb, 3)
    jlin = np.fromfile(f"{base}.linear.f32", np.float32).reshape(RES * RES, 3)
    golden_close(L.numpy(), jlin, "L")
    terms = ys.numpy().transpose(2, 1, 0, 3)  # (B, 3 terms, nb, 3)
    for k, name in enumerate(("emitted", "NEE light", "NEE BSDF")):
        golden_close(terms[:, k], jterms[:, k], name)
    # the reference's shading-normal gate (semantics.py quirk 3) leaves the
    # NEE BSDF strategy nothing in both packages; without it, it adds in
    assert terms[:, :2].any(axis=(0, 2, 3)).all() and not terms[:, 2].any()
    assert not jterms[:, 2].any()
    # without the gate the NEE BSDF term carries radiance: held against
    # the JAX package's there
    ungated = PLAIN.replace(shading_normal_le_gate=False)
    L, ys = ray_color_plain(s, o, d, u, ungated, terms=True)
    assert ys[:, 2].any() and jungated[:, 2].any()
    L64 = L.double().numpy()
    assert np.abs(ys.double().sum((0, 1)).numpy() - L64).max() <= 1e-6 * np.abs(L64).max()
    terms = ys.numpy().transpose(2, 1, 0, 3)
    for k, name in enumerate(("emitted", "NEE light", "NEE BSDF")):
        golden_close(terms[:, k], jungated[:, k], f"{name}, ungated")


def test_kernel_path_refuses_terms():
    s = compile_scene(load_scene_file(DEMO, ["/res", "8x6"]), device="cpu")
    o, d, u = _stratum_rays(s, pixel_centers(8, 6), rng.PRNGKey(0), 0, 1, PLAIN)
    with pytest.raises(ValueError, match="plain path"):
        radiance_of_uniforms(s, o, d, u, DEFAULT_OPTIONS.replace(integrator_backend="kernel"),
                             terms=True)
    L, ys = radiance_of_uniforms(s, o, d, u, PLAIN, terms=True)
    assert torch.equal(L, radiance_of_uniforms(s, o, d, u, PLAIN))


def test_term_dump_then_term_diff(jax_runs, tmp_path, capsys, monkeypatch):
    ours = str(tmp_path / "torch")
    out = term_dump.main([DEMO, ours, "--res", str(RES), "--smp", "1", "--device", "cpu"])
    assert out["self_check"] <= 1e-6 * np.abs(out["linear"]).max()
    nb = PLAIN.max_bounces
    assert np.array_equal(np.fromfile(ours + ".terms.f32", np.float32),
                          out["terms"].reshape(-1))
    assert out["terms"].shape == (RES, RES, 3, nb, 3)
    # the dump is pass 0's split and radiance
    s = compile_scene(load_scene_file(DEMO, ["/res", f"{RES}x{RES}"]), device="cpu")
    L, ys = ray_color_plain(s, *_pass0(s), PLAIN, terms=True)
    assert np.array_equal(out["linear"].reshape(-1, 3), L.numpy())
    assert np.array_equal(out["terms"].reshape(-1, 3, nb, 3), ys.numpy().transpose(2, 1, 0, 3))
    base = jax_runs()[0]
    golden_close(out["linear"], np.fromfile(f"{base}.linear.f32", np.float32).reshape(RES, RES, 3))
    capsys.readouterr()
    term_diff.main([ours, str(base), "--res", str(RES)])
    report = capsys.readouterr().out
    assert "term  bounces" in report and "emit  b0" in report and "nee_l b1" in report
    absd = float(report.split("tonemapped block |diff| mean (avg over refs): ")[1].split()[0])
    assert absd < 0.01, report
    # no card: the tool raises, it does not fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        term_dump.main([DEMO, ours, "--res", "8", "--smp", "1"])
