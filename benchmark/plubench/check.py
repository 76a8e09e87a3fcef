"""What decides ``correct``: the program's outputs against the frozen
reference (plubench/reference), computed on the card after the window.

A render's answer is an image. A sample of pixels is drawn from the
seed, and the run keeps those pixels of every linear image and every
tonemapped image in host memory; once the window has closed, one of the
images it completed is drawn from the seed, and the reference works
each sampled pixel out again from the scene file and the image's key
(its own scene tables, uniforms, camera rays and paths, every stratum);
the numbers below compare:

- ``tables_off``: entries of the scene's tables (primitives, materials,
  textures, lights, atlas, camera, the spheres' cull boxes) where the
  program's compiled scene differs from the reference's compile; exact;
- ``nonfinite``: entries of the window's images in host memory that are
  not finite; exact;
- ``linear_rel_l1``: sum |program - reference| over sum |reference| of the
  sampled pixels' linear radiance;
- ``pixels_off``: the share of sampled pixels whose linear radiance
  differs from the reference's by more than PIXEL_RTOL of max(1, |ref|) in
  a channel (a flipped path at a knife edge moves one pixel);
- ``tonemap_gap``: the largest gap between the program's tonemapped pixel
  in host memory and the reference's tonemap of the program's own linear
  pixel.

The control (tests/test_bench_control.py) puts the reference in the
program's place computed in bfloat16: its scene tables and each
stratum's radiance rounded to bfloat16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

MASK = 0xFFFFFFFF
PIXEL_RTOL = 1e-4
# the limits, set from the readings PERF.md gives: sound runs of the program
# on a dozen seeds and more (the lower reading), the bfloat16 control on
# three (the upper)
RENDER_LIMITS = {"tables_off": 0.0, "nonfinite": 0.0, "linear_rel_l1": 2e-3,
                 "pixels_off": 0.05, "tonemap_gap": 1e-4}
REF_RAYS = 1 << 18  # camera rays of one reference call (strata x pixels)
SCENE_FIELDS = ("prim_type", "prim_a", "prim_b", "prim_c", "prim_n0", "prim_n1", "prim_n2",
                "prim_uv0", "prim_uv1", "prim_uv2", "prim_material", "prim_area", "prim_light",
                "mat_type", "mat_color", "mat_tex", "mat_eta", "mat_k", "tex_type", "tex_c0",
                "tex_c1", "tex_scale", "tex_line", "tex_img_ofs", "tex_img_w", "tex_img_h",
                "atlas", "light_type", "light_pos", "light_intensity", "light_prim",
                "parent_min", "parent_max")
CAMERA_FIELDS = ("pos", "look", "right", "up", "inv_image_size", "w", "lens_radius",
                 "focal_distance")


@dataclasses.dataclass
class Compared:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def seed_words(seed: int):
    """The base key of a run: (0, seed mod 2^32), with the seed's high
    word folded in where it has one (any seed up to 2^64)."""
    from plubench.reference import rng

    words = (0, seed & MASK)
    return rng.fold_in_words(words, (seed >> 32) & MASK) if seed >> 32 else words


def item_words(seed: int, i: int):
    """The key of item i (an image, a step) of a run."""
    from plubench.reference import rng

    return rng.fold_in_words(seed_words(seed), i)


def draw(seed: int, salt: int):
    """A numpy generator for the check's draws (which image, which pixels)."""
    return np.random.default_rng([seed & MASK, seed >> 32, salt])


def sample_pixels(seed: int, width: int, height: int, k: int) -> np.ndarray:
    """k distinct pixel indices (row-major), drawn from the seed, sorted."""
    k = min(k, width * height)
    return np.sort(draw(seed, 1).choice(width * height, size=k, replace=False))


def reference_scene(scene_path, width: int, height: int, device):
    """The reference's compiled scene of the scene file at the given size."""
    from plubench.reference.scene.compile import compile_numpy, scene_from_numpy
    from plubench.reference.scene.loader import load_scene_file

    desc = load_scene_file(str(scene_path), ["/res", f"{width}x{height}"])
    return scene_from_numpy(compile_numpy(desc)).to(device)


def round_scene(scene):
    """The scene with every float table rounded to bfloat16 (and held in
    float32)."""
    from plubench.reference.scene.types import CameraParams

    r = lambda x: x.to(torch.bfloat16).to(torch.float32) if x.is_floating_point() else x
    cam = CameraParams(**{f: r(getattr(scene.camera, f)) for f in CAMERA_FIELDS})
    floats = {f: r(getattr(scene, f)) for f in SCENE_FIELDS if getattr(scene, f) is not None}
    return dataclasses.replace(scene, camera=cam, **floats)


def reference_options(options: dict):
    """The reference's options from a mix's program options: the fields
    that change the answer (the reference has no others; the program's
    choices of engine and kernel do not change it)."""
    from plubench.reference.semantics import DEFAULT_OPTIONS, RenderOptions

    known = {f.name for f in dataclasses.fields(RenderOptions)}
    return DEFAULT_OPTIONS.replace(**{k: v for k, v in options.items() if k in known})


def reference_pixels(scene, width: int, height: int, n: int, words, pix, work=None,
                     bf16: bool = False, options=None) -> torch.Tensor:
    """(K, 3) linear radiance of the pixels pix (row-major indices) of the
    image of n^2 strata keyed `words`, as render computes it: stratum s
    keyed fold_in(key, s) and split into pixel, lens and path keys; each
    pixel's jitter and path uniforms are the words at its own counters of
    those keys' draws; the strata summed in order, then divided by n^2.
    bf16 rounds each stratum's radiance to bfloat16 (the control)."""
    from plubench.reference import rng
    from plubench.reference.render.integrator import ray_color_plain
    from plubench.reference.render.renderer import jittered_rays, over
    from plubench.reference.semantics import DEFAULT_OPTIONS

    options = DEFAULT_OPTIONS if options is None else options
    dev = scene.prim_a.device
    p = torch.as_tensor(np.asarray(pix), dtype=torch.int64, device=dev)
    K, spp, mb = p.shape[0], n * n, options.max_bounces
    px0 = torch.stack([(p % width).to(torch.float32), (p // width).to(torch.float32)], -1)
    jit_idx = torch.stack([2 * p, 2 * p + 1], -1).reshape(-1)
    u_idx = (12 * p[:, None] + torch.arange(12, device=dev)).reshape(-1)
    acc = torch.zeros((K, 3), device=dev)
    per = max(1, REF_RAYS // K)
    for s0 in range(0, spp, per):
        strata = list(range(s0, min(spp, s0 + per)))
        trip = [rng.split_words(rng.fold_in_words(words, s), 3) for s in strata]
        S = len(strata)
        jit = rng.uniform_words_at([t[0] for t in trip] + [t[1] for t in trip], jit_idx)
        u = rng.uniform_words_at([rng.fold_in_words(t[2], i) for i in range(mb) for t in trip],
                                 u_idx)
        o, d = jittered_rays(scene.camera, px0, jit.reshape(2, S, K, 2), strata, n)
        with torch.no_grad():
            L = ray_color_plain(scene, o, d, u.reshape(mb, S * K, 12), options, work=work)
        if bf16:
            L = L.to(torch.bfloat16).to(torch.float32)
        for j in range(S):
            acc = acc + L[j * K:(j + 1) * K]
    return over(acc, spp)


def tables_off(program_scene, ref_scene) -> float:
    """Entries of the scene tables where the two compiled scenes differ
    (shapes that differ count every entry)."""
    off = 0
    pairs = [(getattr(program_scene, f), getattr(ref_scene, f)) for f in SCENE_FIELDS]
    pairs += [(getattr(program_scene.camera, f), getattr(ref_scene.camera, f))
              for f in CAMERA_FIELDS]
    for a, b in pairs:
        if a is None or b is None:
            off += 0 if a is None and b is None else 1
            continue
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.shape != b.shape:
            off += max(a.numel(), b.numel())
        else:
            off += int((a.to(b.dtype) != b).sum())
    off += 0 if tuple(program_scene.cull_rows or ()) == tuple(ref_scene.cull_rows or ()) else 1
    return float(off)


def pixel_numbers(got_linear, got_tonemapped, ref_linear) -> Dict[str, float]:
    """linear_rel_l1, pixels_off and tonemap_gap of the sampled pixels:
    the program's linear radiance (on its device: the reference's tonemap
    of it runs there) and tonemapped pixels and the reference's linear
    radiance, (K, 3) each."""
    from plubench.reference.ops.tonemap import reinhard

    ref = ref_linear.detach().double().cpu()
    got = got_linear.detach().double().cpu()
    diff = (got - ref).abs()
    rel_l1 = float(diff.sum() / ref.abs().sum().clamp(min=1e-30))
    off = (diff > PIXEL_RTOL * ref.abs().clamp(min=1.0)).any(-1).double().mean()
    tm_ref = reinhard(got_linear.detach().to(torch.float32)).double().cpu()
    tm_got = torch.as_tensor(np.asarray(got_tonemapped)).double()
    gap = float((tm_got - tm_ref).abs().max()) if ref.numel() else 0.0
    return {"linear_rel_l1": rel_l1, "pixels_off": float(off), "tonemap_gap": gap}


def control_numbers(scene_path, width: int, height: int, n: int, words, pix,
                    device) -> Dict[str, float]:
    """The render check's numbers with the control in the program's place:
    the reference computed in bfloat16 (round_scene's tables, each
    stratum's radiance and the tonemapped pixels rounded to bfloat16)
    against the reference."""
    from plubench.reference.ops.tonemap import reinhard

    ref_scene = reference_scene(scene_path, width, height, device)
    ctl_scene = round_scene(ref_scene)
    ref = reference_pixels(ref_scene, width, height, n, words, pix)
    ctl = reference_pixels(ctl_scene, width, height, n, words, pix, bf16=True)
    tm = reinhard(ctl).to(torch.bfloat16).to(torch.float32).cpu()
    return {"tables_off": tables_off(ctl_scene, ref_scene),
            "nonfinite": float(int((~torch.isfinite(tm)).sum())),
            **pixel_numbers(ctl, tm, ref)}


def judged(values: Dict[str, float], limits: Dict[str, float]) -> List[Compared]:
    return [Compared(k, float(values[k]), float(limits[k])) for k in limits]


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], counted) -> float:
    """The worst leaf's gap between the norms, | |got| - |ref| |, over the
    larger of the reference leaf's norm and the median leaf's."""
    norm = lambda x: float(x.detach().double().norm())
    ref_n = {f: norm(v) for f, v in ref.items()}
    med = float(np.median(list(ref_n.values())))
    return max(abs(norm(got[f].to(ref[f].device)) - ref_n[f]) / max(ref_n[f], med, 1e-30)
               for f in counted)
