"""What the train step's captured CUDA graph rests on, on the CPU.

On one card the train step is captured as two CUDA graphs and replayed
(parallel/sharded._Graphed; held bit-equal to the eager step by
tests/test_torch_cuda.py). A replay takes nothing from the host but what
is written into its buffers, so the step's key words come from a table on
the card (renderer.launch_words of each pass, traced by
renderer.trace_launch, as every launch is) and the optimiser's constants
are built once a device. Here, on the CPU:

- a pass's words are the keys JAX derives for one stratum (split and
  fold_in), and trace_launch of one stratum (R1's and R2's plain twins
  reading the words from a tensor) gives that stratum's radiance inside
  a launch of several, bit for bit;
- Adam and exponential_decay with their constants built once give the
  updates of the same arithmetic with every constant made anew a call
  (the code before), bit for bit, over the recipe's phase-1 schedule
  (600 steps) and its phase-2 schedule (300, 0.05);
- a CPU scene keeps the eager step: no graph is captured, and a step
  equals its two eager halves bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.diff.optim import Adam, AdamState, MultiTransform, apply_updates
from plutracer_tpu_torch.diff.optim import exponential_decay
from plutracer_tpu_torch.ops.safemath import _sqrt_rn
from plutracer_tpu_torch.parallel.sharded import get_params, make_train_step
from plutracer_tpu_torch.render import renderer
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from plutracer_tpu_torch.utils import profiling
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

W, H = 16, 12
SEEDS = [0, 7, 2**31 + 11, 2**32 - 1]


def scene(name):
    return compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", f"{W}x{H}"]),
                         device="cpu")


def words_of(key, stratum, mb):
    """A pass's words: launch_words of the one stratum, as a tensor."""
    return torch.from_numpy(renderer.launch_words([rng.key_words(key)], [stratum], mb))


@pytest.mark.parametrize("seed", SEEDS)
def test_stratum_words_are_launch_draws_keys(seed):
    """A pass's words: the max_bounces path keys fold_in(k_path, i), then
    the cell and the jitter keys (k_px, k_lens), with (k_px, k_lens,
    k_path) = split(key, 3) as JAX derives them, every uint32 word as its
    int32 bit pattern; R1's plain twin draws JAX's path uniforms from
    them."""
    mb, stratum = DEFAULT_OPTIONS.max_bounces, 3
    key = rng.fold_in(rng.PRNGKey(seed), 5)
    got = words_of(key, stratum, mb)
    assert got.shape == (2 * mb + 5,) and got.dtype == torch.int32
    unsigned = got.numpy().view(np.uint32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    k_px, k_lens, k_path = jax.random.split(jkey, 3)
    path = [jax.random.fold_in(k_path, i) for i in range(mb)]
    assert unsigned[:2 * mb].tolist() == np.concatenate([np.asarray(k) for k in path]).tolist()
    assert unsigned[2 * mb:].tolist() == [stratum, *np.asarray(k_px), *np.asarray(k_lens)]
    u = rng.uniform_block_words(got[:2 * mb].view(mb, 2), 12 * 10)
    want = np.stack([np.asarray(jax.random.uniform(k, (10 * 12,))) for k in path])
    np.testing.assert_array_equal(u.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["demo-box", "dof"])
@pytest.mark.parametrize("seed", SEEDS)
def test_trace_stratum_table_equals_key_path(name, seed):
    """trace_launch of one stratum's words (the graph's forward, and
    _trace_stratum) gives that stratum's radiance traced inside a launch
    of four (launch_words of four keys and cells, the stratum third), bit
    for bit (a pinhole camera and a thin lens)."""
    s = scene(name)
    px0 = renderer.pixel_centers(W, H)
    B, mb = px0.shape[0], DEFAULT_OPTIONS.max_bounces
    key, stratum, n = rng.fold_in(rng.PRNGKey(seed), 2), 7, 3
    got = renderer.trace_launch(s, px0, words_of(key, stratum, mb), 1, n, DEFAULT_OPTIONS)
    assert torch.equal(got, renderer._trace_stratum(s, px0, key, stratum, n, DEFAULT_OPTIONS))
    keys = [rng.key_words(rng.fold_in(rng.PRNGKey(seed), j)) for j in (0, 1, 2, 3)]
    launch = renderer.launch_words(keys, [4, 0, stratum, 8], mb)
    want = renderer.trace_launch(s, px0, launch, 4, n, DEFAULT_OPTIONS)[2 * B:3 * B]
    assert got.abs().sum() > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_uniform_block_words_is_the_plain_block():
    """uniform_block_words on the CPU: the plain block of the keys whose
    words are the table's bit patterns (words at and past 2**31
    included); refused on a device it does not draw on."""
    keys = rng.key_table([(0, 2**31), (2**32 - 1, 5), (123, 2**31 - 1)])
    signed = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
    assert torch.equal(rng.uniform_block_words(signed, 33), rng.uniform_block_plain(keys, 33))
    with pytest.raises(ValueError, match="device"):
        rng.uniform_block_words(signed.to("meta"), 4)


class PerCallAdam(Adam):
    """Adam.update as it was before its constants were kept: every
    constant a new tensor each update (the arithmetic the kept constants
    must reproduce)."""

    def update(self, grads, state):
        dev = state.count.device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)

        def bias_correction(decay, count):
            power = torch.pow(torch.tensor(np.float32(decay).item(), dtype=torch.float64,
                                           device=dev), count.to(torch.float64))
            return torch.tensor(1.0, dtype=torch.float32, device=dev) - power.to(torch.float32)

        b1, b2 = self.b1, self.b2
        c1, d1, c2, d2 = f32(1 - b1), f32(b1), f32(1 - b2), f32(b2)
        mu = {k: c1 * g + d1 * state.mu[k] for k, g in grads.items()}
        nu = {k: c2 * (g * g) + d2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        bc1, bc2 = bias_correction(b1, count), bias_correction(b2, count)
        lr = self.learning_rate(state.count) if callable(self.learning_rate) else self.learning_rate
        step = torch.as_tensor(-1 * lr, dtype=torch.float32, device=dev)
        eps, eps_root = f32(self.eps), f32(0.0)
        full = lambda c, x: c.expand_as(x)
        updates = {k: step * ((mu[k] / full(bc1, mu[k]))
                              / (_sqrt_rn(nu[k] / full(bc2, nu[k]) + eps_root) + eps))
                   for k in grads}
        return updates, AdamState(count, mu, nu)


def per_call_decay(init_value, transition_steps, decay_rate):
    """exponential_decay as it was before its constants were kept."""
    def schedule(count):
        f32 = lambda x: torch.tensor(np.float32(x).item(), dtype=torch.float32)
        p = count.to(torch.float32) / f32(transition_steps)
        power = torch.pow(torch.tensor(np.float32(decay_rate).item(), dtype=torch.float64),
                          p.to(torch.float64)).to(torch.float32)
        return torch.where(count <= 0, f32(init_value), f32(init_value) * power)

    return schedule


@pytest.mark.parametrize("recipe", [(20.0, 600, 0.1), (1.0, 600, 0.1), (1e-2, 300, 0.05)],
                         ids=["phase-1 emission", "train cell emission", "phase-2 albedo"])
def test_kept_constants_equal_per_call_constants(recipe):
    """Over the schedule's whole run (and as far again), the schedule's
    rates and the updates, moments and parameters of Adam with that
    schedule (and of Adam at a fixed 3e-2) equal the per-call arithmetic's,
    bit for bit, on gradients of mixed magnitudes."""
    steps = recipe[1]
    kept, before = exponential_decay(*recipe), per_call_decay(*recipe)
    counts = torch.arange(-1, 2 * steps + 1, dtype=torch.int32)
    for c in counts:
        assert torch.equal(kept(c).view(torch.int32), before(c).view(torch.int32)), int(c)
    g = np.random.default_rng(steps)
    shapes = {"mat_color": (8, 3), "light_intensity": (1, 3)}
    labels = {"mat_color": "albedo", "light_intensity": "emission"}
    opts = [MultiTransform({"albedo": cls(3e-2), "emission": cls(sched)}, labels)
            for cls, sched in ((Adam, kept), (PerCallAdam, before))]
    params = [{k: torch.from_numpy(g.uniform(0, 1, s).astype(np.float32))
               for k, s in shapes.items()}] * 2
    states = [o.init(params[0]) for o in opts]
    for _ in range(steps):
        grads = {k: torch.from_numpy((g.normal(size=s) * 10.0 ** g.integers(-6, 3))
                                     .astype(np.float32)) for k, s in shapes.items()}
        out = [o.update(grads, st) for o, st in zip(opts, states)]
        states = [st for _, st in out]
        params = [apply_updates(p, u) for p, (u, _) in zip(params, out)]
    for k in shapes:
        assert torch.equal(params[0][k].view(torch.int32), params[1][k].view(torch.int32)), k
    leaves = [o.state_leaves(st) for o, st in zip(opts, states)]
    assert all(torch.equal(a, b) for a, b in zip(*leaves))
    assert int(states[0].inner_states["emission"].count) == steps


def test_cpu_scene_keeps_the_eager_step():
    """On a CPU scene the step is not captured (train.graph_captures and
    train.graph_replays stay 0) and step.many equals the step's eager
    halves (loss_and_grads, then apply), bit for bit, over three steps."""
    s = scene("demo-box")
    target = renderer.render(s, W, H, 2, rng.PRNGKey(11)).reshape(-1, 3)
    params = dict(get_params(s))
    params["mat_color"] = params["mat_color"] * 0.5
    step = make_train_step(s, W, H, 2, loss_space="log", trainable=("mat_color", "light_intensity"))
    key0 = rng.PRNGKey(8)
    profiling.reset()
    with profiling.recording():
        p, st, losses, _ = step.many(params, step.init(params), target, key0, 0, 3)
        assert profiling.counter("train.graph_captures") == 0
        assert profiling.counter("train.graph_replays") == 0
    ep, est = params, step.init(params)
    for i in range(3):
        loss, grads, nf = step.loss_and_grads(ep, target, rng.fold_in(key0, i), i % 4)
        ep, est = step.apply(ep, est, grads, nf)
        assert torch.equal(loss, losses[i])
    assert all(torch.equal(p[k], ep[k]) for k in p)
    assert torch.equal(st.count, est.count) and int(st.count) == 3
