"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the run is on the CPU at a tiny
size, the kernels' plain versions) and the rest of the run is driven as
it stands, once for each fault a render cell can have. (One card: no
exchange between cards to leave out.)"""

import pytest

from helpers import run_tiny, tiny_cell


def _render():
    from plutracer_tpu_torch.render import renderer

    return renderer, renderer.render


def state_unchanged(scene, width, height, n, key, *a, **k):
    """The accumulator handed back as it started: no stratum added."""
    renderer, _ = _render()
    return renderer._finalize(renderer.zeros_accum(width, height, scene.device), n * n,
                              width, height)


def half_the_batch(scene, width, height, n, key, *a, **k):
    """Half of the strata left out, the mean taken over the rest."""
    renderer, _ = _render()
    half = max(1, n * n // 2)
    acc = renderer.render_passes(scene, key, 0, width, height, n, half)
    return renderer._finalize(acc, half, width, height)


def make_altered(render):
    def another_answer(scene, width, height, n, key, *a, **k):
        """The answer altered where it is produced: the image of another key."""
        return render(scene, width, height, n, key + 1, *a, **k)
    return another_answer


def make_darker(render):
    def darker(scene, width, height, n, key, *a, **k):
        """Every pixel's radiance altered by a hundredth."""
        return render(scene, width, height, n, key, *a, **k) * 0.99
    return darker


def bad_tonemap(color):
    """The tonemap's gamma altered."""
    from plutracer_tpu_torch.ops.tonemap import reinhard

    return reinhard(color) ** 1.01


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "another_answer",
                                   "darker", "bad_tonemap"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from plutracer_tpu_torch.ops import tonemap

    renderer, render = _render()
    cell = tiny_cell("cornell-box.final", size=8, n=2, pixels=16)
    ok, _ = run_tiny(cell)
    assert ok["correct"]
    if fault == "bad_tonemap":
        monkeypatch.setattr(tonemap, "postprocess_image", bad_tonemap)
    else:
        broken = {"state_unchanged": state_unchanged, "half_the_batch": half_the_batch,
                  "another_answer": make_altered(render), "darker": make_darker(render)}[fault]
        monkeypatch.setattr(renderer, "render", broken)
    result, compared = run_tiny(cell)
    assert not result["correct"], result["checks"]
    assert any(not c.ok for c in compared)


def test_nonfinite_image_is_not_correct(monkeypatch):
    renderer, render = _render()

    def nan_pixel(*a, **k):
        img = render(*a, **k).clone()
        img[0, 0, 0] = float("nan")
        return img

    monkeypatch.setattr(renderer, "render", nan_pixel)
    result, _ = run_tiny(tiny_cell("cornell-box.final", size=8, n=1))
    assert not result["correct"]
    assert result["checks"]["nonfinite"]["value"] >= 1


def _sharded():
    from plutracer_tpu_torch.parallel import sharded

    return sharded


def step_unchanged(make, first=0):
    def make_broken(*a, **k):
        step = make(*a, **k)
        many = step.many

        def frozen(params, opt_state, target, key0, start, k_steps):
            """The step's loss computed, its parameters and state handed back
            unchanged (from step `first` on)."""
            new_params, new_state, losses, nf = many(params, opt_state, target, key0, start,
                                                     k_steps)
            if start < first:
                return new_params, new_state, losses, nf
            return params, opt_state, losses, nf
        step.many = frozen
        return step
    return make_broken


def later_steps_unchanged(make):
    """The state handed back unchanged from the first step past the checked
    ones on: only the window's steps are broken."""
    return step_unchanged(make, first=3)


def half_layout(layout):
    def half(scene, mesh, width, height):
        """Half of the pixels left out: the loss is the mean over the rest."""
        rows, scenes, px = layout(scene, mesh, width, height)
        return rows // 2, scenes, {d: p[:rows // 2] for d, p in px.items()}
    return half


def loss_altered(make):
    def make_broken(*a, **k):
        step = make(*a, **k)
        many = step.many

        def altered(*args):
            params, state, losses, nf = many(*args)
            return params, state, losses * 1.001, nf
        step.many = altered
        return step
    return make_broken


@pytest.mark.parametrize("fault", ["step_unchanged", "half_the_batch", "loss_altered",
                                   "later_steps_unchanged"])
def test_broken_train_step_is_not_correct(fault, monkeypatch):
    from helpers import tiny_train

    sharded = _sharded()
    cell = tiny_train()
    ok, _ = run_tiny(cell)
    assert ok["correct"], ok["checks"]
    if fault == "half_the_batch":
        monkeypatch.setattr(sharded, "_layout", half_layout(sharded._layout))
    else:
        wrap = {"step_unchanged": step_unchanged, "loss_altered": loss_altered,
                "later_steps_unchanged": later_steps_unchanged}[fault]
        monkeypatch.setattr(sharded, "make_train_step", wrap(sharded.make_train_step))
    result, _ = run_tiny(cell)
    assert not result["correct"], result["checks"]
