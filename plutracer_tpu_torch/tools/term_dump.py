"""Dump the port's per-(term, bounce) linear radiance split.

The port of tools/term_dump.py: writes <base>.linear.f32 (H, W, 3) and
<base>.terms.f32 (H, W, 3 terms, max_bounces, 3) float32 in the JAX tool's
layout, so plutracer_tpu_torch/tools/term_diff.py can diff two dumps (the
port's, the JAX package's, the instrumented reference build's) contribution
site by contribution site. Term 0 is the radiance emitted at a vertex, 1 the
NEE light strategy, 2 the NEE BSDF strategy. Always runs the plain
integrator (the kernels are held bit-equal to it on the card).

    python -m plutracer_tpu_torch.tools.term_dump SCENE.urn OUT_BASE
        [--res 512] [--smp 16] [--seed 0] [--device cuda|cpu]

smp is N (spp = N^2, as the reference CLI). Pass s is keyed fold_in(seed
key, s) at stratum s, as render's; the passes are summed in float64. Runs
on the card unless --device cpu is given; without a card it raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.cli import resolve_device
from plutracer_tpu_torch.render.integrator import ray_color_plain
from plutracer_tpu_torch.render.renderer import _stratum_rays, pixel_centers
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS


def term_passes(scene, width: int, height: int, n: int, seed: int, options=DEFAULT_OPTIONS):
    """(linear (H, W, 3), terms (H, W, 3, max_bounces, 3)) float32 numpy:
    the means over the n^2 passes of the plain integrator's radiance and
    of its split by term and bounce."""
    options = options.replace(integrator_backend="plain")
    px0 = pixel_centers(width, height, scene.device)
    key = rng.PRNGKey(seed)
    spp, nb = n * n, options.max_bounces
    acc_l = torch.zeros((height * width, 3), dtype=torch.float64, device=scene.device)
    acc_t = torch.zeros((nb, 3, height * width, 3), dtype=torch.float64, device=scene.device)
    for s in range(spp):
        o, d, u = _stratum_rays(scene, px0, rng.fold_in(key, s), s, n, options)
        L, ys = ray_color_plain(scene, o, d, u, options, terms=True)  # ys: (nb, 3, B, 3)
        acc_l += L.double()
        acc_t += ys.double()
        if (s + 1) % 32 == 0:
            print(f"  pass {s + 1}/{spp}", flush=True)
    lin = (acc_l.cpu().numpy() / spp).astype(np.float32).reshape(height, width, 3)
    # (nb, 3, HW, 3) -> (HW, 3 terms, nb, 3)
    terms = (acc_t.cpu().numpy() / spp).transpose(2, 1, 0, 3).astype(np.float32)
    return lin, terms.reshape(height, width, 3, nb, 3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene")
    ap.add_argument("out_base")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--smp", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    W = H = args.res
    n = args.smp
    scene = compile_scene(load_scene_file(args.scene, ["/res", f"{W}x{H}", "/smp", str(n)]),
                          device=dev)
    lin, terms = term_passes(scene, W, H, n, args.seed)
    err = float(np.abs(terms.sum(axis=(2, 3)) - lin).max())
    print(f"self-check max|sum(terms) - L| = {err:.3e}")
    lin.tofile(args.out_base + ".linear.f32")
    terms.tofile(args.out_base + ".terms.f32")
    print(f"wrote {args.out_base}.linear.f32 / .terms.f32  (linear mean {lin.mean():.4f})")
    return {"linear": lin, "terms": terms, "self_check": err}


if __name__ == "__main__":
    main()
