"""The frozen reference against the program on the CPU: the compiled
tables, and every pixel of a 16x16 image at n = 1 (n = 2 on the Cornell
box; a tetra of 4^2 tetrahedra, as the CPU's brute force needs)."""

import numpy as np
import pytest
import torch

from helpers import small_tetra
from plubench import check, spec

SCENES = spec.HERE / "scenes"


@pytest.mark.parametrize("scene,n", [("cornell-box.urn", 2), ("tetra.urn", 1)])
def test_reference_matches_program(scene, n):
    from plutracer_tpu_torch.ops.tonemap import postprocess_image
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    W = H = 16
    path = small_tetra() if scene == "tetra.urn" else SCENES / scene
    prog = compile_scene(load_scene_file(str(path), ["/res", f"{W}x{H}"]), device="cpu")
    ref = check.reference_scene(path, W, H, "cpu")
    assert check.tables_off(prog, ref) == 0.0
    words = check.item_words(2**31 + 3, 5)
    img = render(prog, W, H, n, torch.tensor(words, dtype=torch.int64))
    pix = np.arange(W * H)
    ref_px = check.reference_pixels(ref, W, H, n, words, pix)
    assert torch.equal(img.reshape(-1, 3), ref_px)
    lin = img.reshape(-1, 3)
    nums = check.pixel_numbers(lin, postprocess_image(lin), ref_px)
    assert nums == {"linear_rel_l1": 0.0, "pixels_off": 0.0, "tonemap_gap": 0.0}


def test_sampled_pixels_match_the_whole_image():
    """A sample of pixels, replayed alone, equals those pixels of the
    reference's whole image (the per-pixel counters of the draws)."""
    W = H = 8
    ref = check.reference_scene(SCENES / "cornell-box.urn", W, H, "cpu")
    words = check.item_words(11, 0)
    whole = check.reference_pixels(ref, W, H, 2, words, np.arange(W * H))
    pix = check.sample_pixels(11, W, H, 9)
    assert torch.equal(check.reference_pixels(ref, W, H, 2, words, pix), whole[pix])


def test_scene_compare_sees_a_changed_table():
    W = H = 8
    ref = check.reference_scene(SCENES / "cornell-box.urn", W, H, "cpu")
    other = check.reference_scene(SCENES / "cornell-box.urn", W, H, "cpu")
    other.mat_color[1, 0] += 1e-3
    assert check.tables_off(other, ref) == 1.0
