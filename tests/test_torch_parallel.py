"""The port's multi-device path (parallel/mesh.py, parallel/sharded.py:
render_sharded and the mesh train step) against the JAX package's
render_sharded and make_train_step on the conftest's 8 virtual CPU
devices, and against itself across mesh shapes.

Bounds:
- images against JAX: the two run the same estimator at the same keys in
  different float32 arithmetic (XLA contracts products into FMAs), so
  lanes at knife edges (the glass sphere) take other paths. The padding
  case (dof, 8x8) is within the golden bounds of tests/test_golden.py
  (|log1p| difference p99 < 0.05, mean < 0.01), and so is demo-box
  32x24, n = 2 on the 1x1 mesh. On the (4, 2) mesh at the same seed, 4 of
  the 768 pixels differ by more than 0.05, two of them by a firefly
  (|log1p| differences 8.3 and 4.6), which alone put the mean at 0.018:
  there the p99 bound holds with the mesh scenes' structural bound in
  place of the mean (at most 3% of pixels over 0.05;
  tests/test_torch_stream.py). The split adds no flips: it changes each
  pixel's keys, so other samples land on the knife edges. At seeds 0, 1
  and 2, 0 to 3 pixels differ on the 1x1 mesh, 3 to 5 on (2, 2) and 2 to
  4 on (4, 2), and the golden mean fails where a firefly is among them:
  on (2, 2) and (4, 2) at seed 0 (tests/torch_jax_flips.py);
- the port's meshes against each other as tests/test_sharding.py holds
  the JAX package's: within 1.75x the single-device render's own
  seed-to-seed noise, which a dropped or doubled shard exceeds;
- the padding divergence: the port traces exactly n^2 strata, and its
  image equals its own strata summed in order, bit for bit; the JAX
  image equals the sum of the strata JAX traces, padding included, within
  1e-6 of its largest entry, and is 10% off the real strata's mean;
- first-step gradients on a (2, 2) mesh on dof 16x12 (ab and linear): each
  field within 1e-3 of its largest entry, losses within 1e-4 relative
  (tests/test_torch_train.py's bounds for dof on a 1x1 mesh), once the
  port's gradients are multiplied by the mesh's 4 positions. The port's
  are the gradients of the loss it reports (the positions' gradients
  summed over tiles, averaged over spp, as the losses are). The JAX
  step's come out the position count times larger on the CPU: under
  shard_map's varying-axes check (on there, off on a TPU) the gradient
  of the replicated parameters is already summed over every position
  before the step's own psum and pmean (measured: 2, 2 and 4 times on
  (2, 1), (1, 2) and (2, 2) meshes, 1 on a 1x1). Adam's update hardly
  sees a common factor, which is how the JAX package's training never
  showed it;
- mesh=None against a 1x1 mesh: bit for bit.

The JAX references (two train-step compiles of 25-45 s each on this CPU,
and the renders) run in two subprocesses started when this module
starts, so they overlap the port's tests.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.parallel import make_mesh, make_train_step, render_sharded
from plutracer_tpu_torch.parallel import sharded
from plutracer_tpu_torch.parallel.sharded import DIFFERENTIABLE_FIELDS, get_params
from plutracer_tpu_torch.render.renderer import _trace_stratum, over, pixel_centers, render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
DEMO = str(REPO / "scenes" / "demo-box.urn")
DOF = str(REPO / "scenes" / "dof.urn")
CPU = torch.device("cpu")
POSITIONS = 4  # of the (2, 2) mesh the gradients are compared on
TRAIN_KW = dict(loss_clamp=5.0, project_nonnegative=True,
                trainable=("mat_color", "light_intensity", "tex_c0"))


class Probe:
    """An optimiser with Adam's interface: zero updates, the gradients as
    its state (tests/test_torch_train.py's)."""

    def init(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads, state):
        return {k: torch.zeros_like(v) for k, v in grads.items()}, grads


def scene(path, w, h):
    return compile_scene(load_scene_file(path, ["/res", f"{w}x{h}"]), device="cpu")


def log_diff(a, b):
    return np.abs(np.log1p(np.maximum(a, 0.0)) - np.log1p(np.maximum(b, 0.0)))


def golden_close(a, b):
    diff = log_diff(a, b)
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01, (np.quantile(diff, 0.99),
                                                                    diff.mean())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: this file's passes of a few hundred rays run
    faster so, beside the JAX subprocesses."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def train_inputs(tmp_path_factory):
    """dof 16x12: a target (the port's render, n = 2), params at 0.8 of the
    scene's and a mask freezing the odd material rows, saved for JAX."""
    s = scene(DOF, 16, 12)
    target = render(s, 16, 12, 2, rng.PRNGKey(11)).reshape(-1, 3).numpy()
    params = {k: v.numpy() * np.float32(0.8) for k, v in get_params(s).items()}
    rows = params["mat_color"].shape[0]
    mask = np.repeat((np.arange(rows) % 2 == 0).astype(np.float32)[:, None], 3, 1)
    path = tmp_path_factory.mktemp("train") / "inputs.npz"
    np.savez(path, target=target, mask=mask, **{f"p_{k}": v for k, v in params.items()})
    return s, target, params, mask, path


JAX_RENDERS = """
import jax, jax.numpy as jnp, numpy as np
from plutracer_tpu.parallel.mesh import make_mesh
from plutracer_tpu.parallel.sharded import render_sharded
from plutracer_tpu.render.renderer import render_pass
from plutracer_tpu.scene import compile_scene, load_scene_file
s = compile_scene(load_scene_file({demo!r}, ['/res', '32x24']))
demo = np.asarray(render_sharded(s, 32, 24, 2, jax.random.PRNGKey(0), make_mesh((4, 2))))
demo11 = np.asarray(render_sharded(s, 32, 24, 2, jax.random.PRNGKey(0), make_mesh((1, 1))))
d = compile_scene(load_scene_file({dof!r}, ['/res', '8x8']))
key = jax.random.PRNGKey(0)
pad = np.asarray(render_sharded(d, 8, 8, 3, key, make_mesh((1, 2))))
# the strata JAX traces on (1, 2): blocks of 5 of [0..8] padded with a 0
strata = [np.asarray(render_pass(d, jax.random.fold_in(jax.random.fold_in(
    jax.random.fold_in(key, 0), si), j), jnp.int32(s), 8, 8, 3))
    for si, block in enumerate(([0, 1, 2, 3, 4], [5, 6, 7, 8, 0])) for j, s in enumerate(block)]
np.savez({out!r}, demo=demo, demo11=demo11, pad=pad, strata=np.stack(strata))
"""

JAX_TRAIN = """
import jax, jax.numpy as jnp, numpy as np, optax
from plutracer_tpu.parallel.mesh import make_mesh
from plutracer_tpu.parallel.sharded import make_train_step
from plutracer_tpu.scene import compile_scene, load_scene_file
z = np.load({inputs!r})
s = compile_scene(load_scene_file({dof!r}, ['/res', '16x12']))
probe = optax.GradientTransformation(
    lambda p: jax.tree.map(jnp.zeros_like, p),
    lambda g, st, p=None: (jax.tree.map(jnp.zeros_like, g), g))
params = {{k: jnp.asarray(z['p_' + k]) for k in {fields!r}}}
out = {{}}
for ls in {spaces!r}:
    step = make_train_step(s, 16, 12, 2, make_mesh((2, 2)), optimizer=probe, loss_space=ls,
                           grad_mask={{'mat_color': jnp.asarray(z['mask'])}}, **{kw!r})
    _, g, loss = step(params, step.init(params), z['target'], jax.random.PRNGKey(3), jnp.int32(1))
    out[ls + '_loss'] = np.asarray(loss)
    out.update({{ls + '_' + k: np.asarray(v) for k, v in g.items()}})
np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory, train_inputs):
    """The JAX package's renders and first-step gradients, in two
    subprocesses started when this module starts; yields a function that
    waits for them and returns their outputs."""
    tmp = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""), "--xla_cpu_multi_thread_eigen=false"]))
    codes = {
        "renders": JAX_RENDERS.format(demo=DEMO, dof=DOF, out=str(tmp / "renders.npz")),
        "ab": JAX_TRAIN.format(inputs=str(train_inputs[4]), dof=DOF, fields=DIFFERENTIABLE_FIELDS,
                               spaces=("ab",), kw=TRAIN_KW, out=str(tmp / "ab.npz")),
        "linear": JAX_TRAIN.format(inputs=str(train_inputs[4]), dof=DOF,
                                   fields=DIFFERENTIABLE_FIELDS, spaces=("linear",), kw=TRAIN_KW,
                                   out=str(tmp / "linear.npz")),
    }
    # the ab step's compile is the longest: it starts first, the renders
    # and the linear step share the second process
    procs = {
        "ab": subprocess.Popen([sys.executable, "-c", codes["ab"]], cwd=str(REPO), env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "renders": subprocess.Popen(
            [sys.executable, "-c", codes["renders"] + codes["linear"]], cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
    }
    done = {}

    def result(name):
        proc = procs["ab" if name == "ab" else "renders"]
        if proc not in done:
            log = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, log[-3000:]
            done[proc] = True
        return dict(np.load(tmp / f"{name}.npz"))

    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_mesh_shapes_and_errors(monkeypatch):
    m = make_mesh((4, 2), devices=[CPU] * 8)
    assert m.shape == {"tiles": 4, "spp": 2} and m.axis_names == ("tiles", "spp")
    assert make_mesh(devices=[CPU] * 8).shape == {"tiles": 8, "spp": 1}
    assert [(ti, si) for ti, si, _ in m.local()] == [(t, s) for t in range(4) for s in range(2)]
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh((3, 3), devices=[CPU] * 8)
    # no card: the default mesh, and a render or a step on it, raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_sharded(scene(DEMO, 8, 6), 8, 6, 1, rng.PRNGKey(0))


def _blocks(x, k=8):
    h, w, c = x.shape
    h, w = h - h % k, w - w % k
    return x[:h, :w].reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))


def test_mesh_shapes_estimate_the_same_image():
    """(1, 1), (4, 2) and (8, 1) meshes against the single-device render's
    own seed-to-seed noise at 16 spp (tests/test_sharding.py's bounds)."""
    s = scene(DEMO, 32, 24)
    log = lambda x: np.log1p(np.maximum(x.numpy(), 0.0))
    b1, b2 = (log(render(s, 32, 24, 4, rng.PRNGKey(k))) for k in (1, 2))
    noise_px = np.abs(b1 - b2).mean()
    noise_blk = np.abs(_blocks(b1) - _blocks(b2)).mean()
    for shape in ((1, 1), (4, 2), (8, 1)):
        a = log(render_sharded(s, 32, 24, 4, rng.PRNGKey(0), make_mesh(shape, devices=[CPU] * 8)))
        assert a.shape == (24, 32, 3) and np.isfinite(a).all(), shape
        assert np.abs(a - b1).mean() <= 1.75 * noise_px + 1e-3, shape
        assert np.abs(_blocks(a) - _blocks(b1)).mean() <= 1.75 * noise_blk + 1e-3, shape
        # a dropped or doubled shard shifts the brightness far beyond noise
        assert abs(a.mean() - b1.mean()) <= 1.75 * abs(b1.mean() - b2.mean()) + 5e-3, shape


def test_render_sharded_1x1_within_golden_bounds_of_jax(jax_refs):
    img = render_sharded(scene(DEMO, 32, 24), 32, 24, 2, rng.PRNGKey(0),
                         make_mesh((1, 1), devices=[CPU]))
    golden_close(img.numpy(), jax_refs("renders")["demo11"])


def test_render_sharded_within_golden_bounds_of_jax(jax_refs):
    img = render_sharded(scene(DEMO, 32, 24), 32, 24, 2, rng.PRNGKey(0),
                         make_mesh((4, 2), devices=[CPU] * 8))
    diff = log_diff(img.numpy(), jax_refs("renders")["demo"])
    assert np.quantile(diff, 0.99) < 0.05, np.quantile(diff, 0.99)
    assert (diff.max(-1) > 0.05).mean() <= 0.03, (diff.max(-1) > 0.05).mean()


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 3), (1, 4), (3, 9)])
def test_every_mesh_traces_each_stratum_once(monkeypatch, shape):
    """n = 3 over spp blocks of 9, 5, 3, 3 and 1 strata: each tile traces
    strata 0..8 exactly once, keyed by their place in their block."""
    traced = []
    real = sharded.stratum_launches

    def spy(sc, key, pairs, px0, n, options):
        traced.append([s for _, s in pairs])
        return real(sc, key, pairs, px0, n, options)

    monkeypatch.setattr(sharded, "stratum_launches", spy)
    t, sp = shape
    render_sharded(scene(DOF, 6, 6), 6, 6, 3, rng.PRNGKey(0),
                   make_mesh(shape, devices=[CPU] * (t * sp)))
    for ti in range(t):
        blocks = traced[ti * sp:(ti + 1) * sp]
        assert sorted(s for b in blocks for s in b) == list(range(9)), (shape, blocks)


def test_padding_strata_are_not_traced(jax_refs):
    """dof 8x8, n = 3 on a (1, 2) mesh: blocks of 5 strata, the second one
    short. The port's image is its 9 strata summed in block order / 9;
    the JAX package pads the second block with stratum 0 and adds it in."""
    s = scene(DOF, 8, 8)
    key = rng.PRNGKey(0)
    img = render_sharded(s, 8, 8, 3, key, make_mesh((1, 2), devices=[CPU] * 2))
    px = pixel_centers(8, 8)
    parts = []
    for si, block in enumerate(([0, 1, 2, 3, 4], [5, 6, 7, 8])):
        shard_key = rng.fold_in(rng.fold_in(key, 0), si)
        acc = torch.zeros((64, 3))
        for j, st in enumerate(block):
            acc = acc + _trace_stratum(s, px, rng.fold_in(shard_key, j), st, 3, DEFAULT_OPTIONS)
        parts.append(acc)
    assert torch.equal(img, over(parts[0] + parts[1], 9).reshape(8, 8, 3))
    ref = jax_refs("renders")
    pad, strata = ref["pad"].reshape(-1, 3).astype(np.float64), ref["strata"].astype(np.float64)
    scale = np.abs(pad).max()
    assert np.abs(pad - strata.sum(0) / 9).max() <= 1e-6 * scale  # 10 strata, padding 0 too
    assert np.abs(pad - strata[:9].sum(0) / 9).max() > 0.1 * scale  # not the 9 real ones
    golden_close(img.numpy().reshape(-1, 3), (strata[:9].sum(0) / 9).astype(np.float32))


@pytest.mark.parametrize("loss_space", ["ab", "linear"])
def test_first_step_grads_on_a_mesh_match_jax(jax_refs, train_inputs, loss_space):
    """The (2, 2) step's gradients after the trainable filter and the mask,
    returned as the Probe optimiser's state (tests/test_torch_train.py)."""
    s, target, params, mask, _ = train_inputs
    step = make_train_step(s, 16, 12, 2, make_mesh((2, 2), devices=[CPU] * 4), optimizer=Probe(),
                           loss_space=loss_space, grad_mask={"mat_color": torch.from_numpy(mask)},
                           **TRAIN_KW)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    _, tg, tl = step(tparams, step.init(tparams), torch.from_numpy(target), rng.PRNGKey(3), 1)
    ref = jax_refs(loss_space)
    jl = float(ref[f"{loss_space}_loss"])
    assert abs(float(tl) - jl) <= 1e-4 * abs(jl), (float(tl), jl)
    for f in DIFFERENTIABLE_FIELDS:
        g, jg = tg[f].numpy(), ref[f"{loss_space}_{f}"]
        assert np.isfinite(g).all(), f
        if f not in TRAIN_KW["trainable"]:
            assert not g.any() and not jg.any(), f
            continue
        scale = float(np.abs(jg).max())
        assert np.abs(POSITIONS * g - jg).max() <= 1e-3 * scale, (
            f, np.abs(POSITIONS * g - jg).max(), scale)
        assert np.abs(g - jg).max() > 0.5 * scale, f  # the JAX step's factor
    mc = tg["mat_color"].numpy()
    assert not mc[mask == 0].any() and np.abs(mc).max() > 0


def test_default_mesh_step_equals_a_1x1_mesh(train_inputs):
    s, target, params, _, _ = train_inputs
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    out = []
    for mesh in (None, make_mesh((1, 1), devices=[CPU])):
        step = make_train_step(s, 16, 12, 2, mesh, loss_space="ab", **TRAIN_KW)
        out.append(step.many(tparams, step.init(tparams), torch.from_numpy(target),
                             rng.PRNGKey(5), 0, 2))
    (p0, s0, l0, nf0), (p1, s1, l1, nf1) = out
    assert torch.equal(l0, l1) and torch.equal(nf0, nf1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(a, b) for a, b in zip(s0.mu.values(), s1.mu.values()))


def test_optimize_mesh_starts_on_the_scene_device(monkeypatch):
    """optimize_scene's mesh devices: CPU positions for a CPU scene; on a
    host of two cards, the scene's card first, so a (1, 1) mesh stays on
    it."""
    from types import SimpleNamespace

    from plutracer_tpu_torch.diff import optimize

    assert optimize.mesh_devices(SimpleNamespace(device=CPU), None) == [CPU]
    assert optimize.mesh_devices(SimpleNamespace(device=CPU), (2, 3)) == [CPU] * 6
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(optimize, "visible_devices", lambda caller: cards)
    on1 = SimpleNamespace(device=cards[1])
    assert optimize.mesh_devices(on1, (1, 1)) == [cards[1], cards[0]]
    assert optimize.mesh_devices(SimpleNamespace(device=cards[0]), None) == cards


def test_loss_downsample_needs_one_tile():
    s = scene(DEMO, 16, 16)
    with pytest.raises(ValueError, match="1-tile mesh"):
        make_train_step(s, 16, 16, 1, make_mesh((2, 1), devices=[CPU] * 2), loss_downsample=2)
    make_train_step(s, 16, 16, 1, make_mesh((1, 2), devices=[CPU] * 2), loss_downsample=2)
