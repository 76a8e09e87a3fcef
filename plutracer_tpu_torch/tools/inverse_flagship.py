"""Flagship inverse rendering: the port of tools/inverse_flagship.py.

    python -m plutracer_tpu_torch.tools.inverse_flagship [--res 256]
        [--steps 600] [--phase2-steps 300] [--checkpoint DIR] [--device cuda|cpu]

Recovers the diffuse albedos (``mat_color`` of the diffuse rows) and the
light emission (``light_intensity``) of a scene (default
``scenes/demo-box.urn``) from a rendered target, with gradients through
the whole NEE + MIS path-tracing estimator. Two phases:

1. the LOG loss with per-field Adams (albedo at a constant rate, emission
   at an exponentially decaying one): robust while the emission is 4x
   off, it brings the emission close, but its variance bias puts the
   albedo optimum below the truth;
2. the pooled, unbiased 'ab' product loss at more samples a step
   (``--phase2-n``, ``--phase2-downsample`` k x k pooling, an optional
   firefly clamp whose target averages clamped 1-spp passes), with a
   decaying albedo rate, which descends to the true optimum.

Non-diffuse rows stay frozen through a gradient mask; a step whose
gradient is not finite is rejected whole (parallel/sharded). With
``--checkpoint DIR`` each phase checkpoints its parameters and optimiser
state under DIR, and a rerun with the same flags resumes bit-exactly,
replaying a finished phase 1 from its checkpoint.

Writes the convergence curve and per-parameter recovery errors as JSON
(``--out``), with the JAX tool's keys, and with ``--save-images`` the
target and recovered BMPs beside it. Runs on the card unless
``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.cli import resolve_device
from plutracer_tpu_torch.diff.optim import Adam, MultiTransform, exponential_decay
from plutracer_tpu_torch.diff.optimize import InverseRenderConfig, optimize_scene
from plutracer_tpu_torch.parallel.sharded import apply_params, get_params, params_from_numpy
from plutracer_tpu_torch.render.renderer import (
    _finalize, pixel_centers, render, stratum_launches, zeros_accum,
)
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.types import MAT_DIFFUSE
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

DEFAULT_SCENE = str(Path(__file__).resolve().parents[2] / "scenes" / "demo-box.urn")
LABELS = {"mat_color": "albedo", "light_intensity": "emission",
          "tex_c0": "albedo", "tex_c1": "albedo"}


def _albedo_err(params, true_p, diffuse_rows):
    a = np.asarray(params["mat_color"])[diffuse_rows]
    b = np.asarray(true_p["mat_color"])[diffuse_rows]
    return float(np.abs(a - b).mean())


def _emission_err(params, true_p):
    a = np.asarray(params["light_intensity"])
    b = np.asarray(true_p["light_intensity"])
    denom = np.maximum(np.abs(b), 1e-6)
    return float((np.abs(a - b) / denom).mean())


def _numpy(params):
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clamped_target(scene, width, height, n, clamp, key):
    """The phase-2 target under a firefly clamp: the mean of n^2 1-spp
    passes (pass i keyed fold_in(key, i), stratum i), each clamped at
    `clamp`. That is the map theta -> E[min(X_1spp, c)] the clamped loss
    sees, so the pooled ab optimum stays at the true parameters; clamping
    a high-spp render instead moves it."""
    acc = zeros_accum(width, height, scene.device)
    for launch in stratum_launches(scene, key, [(s, s) for s in range(n * n)],
                                   pixel_centers(width, height, scene.device), n):
        for L in launch:
            acc = acc + torch.clamp(L, max=clamp)
    return _finalize(acc, n * n, width, height)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=DEFAULT_SCENE)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--target-n", type=int, default=16,
                    help="stratified grid for the target render (spp = n^2)")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--n", type=int, default=2,
                    help="stratified grid per optimisation step (spp = n^2 a pass)")
    ap.add_argument("--loss", default="log", choices=["ab", "log", "l2"],
                    help="phase-1 loss: 'log' (log1p-space L2), 'ab' (dual-buffer "
                         "unbiased product) or 'l2'")
    ap.add_argument("--lr-albedo", type=float, default=3e-2)
    ap.add_argument("--lr-emission", type=float, default=20.0,
                    help="initial Adam rate for light_intensity, decaying "
                         "exponentially to a tenth by the last phase-1 step")
    ap.add_argument("--phase2-steps", type=int, default=300,
                    help="steps of the refinement phase (0 disables it)")
    ap.add_argument("--phase2-loss", default="ab", choices=["ab", "log"])
    ap.add_argument("--phase2-n", type=int, default=4,
                    help="stratified grid per phase-2 step (spp = n^2)")
    ap.add_argument("--phase2-downsample", type=int, default=8,
                    help="k x k average-pool images before the phase-2 ab loss")
    ap.add_argument("--phase2-lr-albedo", type=float, default=1e-2)
    ap.add_argument("--phase2-lr-emission", type=float, default=1.0)
    ap.add_argument("--phase2-clamp", type=float, default=0.0,
                    help="firefly clamp on linear radiance (render and target) "
                         "in the phase-2 loss; 0 disables it")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each bounce in the backward (remat_bounces)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-from", default=None,
                    help="start from a prior run's output JSON (recovered_albedo, "
                         "recovered_emission) instead of the canonical perturbation")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="write per-phase checkpoints under DIR; a rerun with the same "
                         "flags resumes bit-exactly")
    ap.add_argument("--out", default="inverse_torch.json")
    ap.add_argument("--save-images", action="store_true",
                    help="write the target and recovered BMPs beside --out")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    W = H = args.res
    scene = compile_scene(load_scene_file(args.scene, ["/res", f"{W}x{H}"]), device=dev)
    mat_type = scene.mat_type.cpu().numpy()
    diffuse_rows = np.nonzero(mat_type == MAT_DIFFUSE)[0]
    print(f"[flagship] scene={args.scene} res={W}x{H} diffuse_rows={diffuse_rows.tolist()} "
          f"device={dev}", flush=True)

    _sync(dev)
    t0 = time.perf_counter()
    target = render(scene, W, H, args.target_n, rng.PRNGKey(100))
    _sync(dev)
    t_target = time.perf_counter() - t0
    print(f"[flagship] target rendered: {args.target_n ** 2} spp in {t_target:.3f}s", flush=True)

    target2 = target
    if args.phase2_clamp > 0:
        t0 = time.perf_counter()
        target2 = clamped_target(scene, W, H, args.target_n, args.phase2_clamp,
                                 rng.PRNGKey(100))
        _sync(dev)
        print(f"[flagship] clamped target ({args.phase2_clamp}) rendered in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)

    true_p = _numpy(get_params(scene))
    init = {k: v.copy() for k, v in true_p.items()}
    # perturb: diffuse walls -> flat grey, emission -> 25% of true
    init["mat_color"][diffuse_rows] = 0.25
    init["light_intensity"] = init["light_intensity"] * np.float32(0.25)
    if args.init_from:
        prev = json.loads(Path(args.init_from).read_text())
        init["mat_color"][diffuse_rows] = np.asarray(prev["recovered_albedo"], np.float32)
        init["light_intensity"] = np.asarray(prev["recovered_emission"], np.float32)
        print(f"[flagship] resumed params from {args.init_from}", flush=True)

    # freeze every non-diffuse mat_color row (mirror/glass tints are at
    # their true values and must not random-walk under MC gradient noise)
    mask = {"mat_color": torch.from_numpy(
        (mat_type == MAT_DIFFUSE).astype(np.float32)[:, None]).to(dev)}
    # Adam's steps are about lr-sized whatever the gradient's scale, so the
    # O(500) emission takes a large rate decaying to a tenth over phase 1
    opt = MultiTransform(
        {"albedo": Adam(args.lr_albedo),
         "emission": Adam(exponential_decay(args.lr_emission, args.steps, 0.1))},
        LABELS)

    curve = []

    def cb(i, loss, params):
        p = _numpy(params)
        rec = {"step": i, "loss": loss,
               "albedo_mae": _albedo_err(p, true_p, diffuse_rows),
               "emission_rel_err": _emission_err(p, true_p)}
        curve.append(rec)
        print(f"[flagship] step {i:4d} loss={loss:.5f} albedo_mae={rec['albedo_mae']:.4f} "
              f"emission_rel={rec['emission_rel_err']:.4f}", flush=True)

    ropts = DEFAULT_OPTIONS.replace(remat_bounces=True) if args.remat else DEFAULT_OPTIONS
    ck1 = ck2 = None
    if args.checkpoint:
        os.makedirs(args.checkpoint, exist_ok=True)
        ck1 = os.path.join(args.checkpoint, "phase1.ckpt.npz")
        ck2 = os.path.join(args.checkpoint, "phase2.ckpt.npz")
    cfg = InverseRenderConfig(
        width=W, height=H, n=args.n, steps=args.steps, seed=args.seed, log_every=10,
        trainable=("mat_color", "light_intensity"), optimizer=opt, grad_mask=mask,
        loss_space="linear" if args.loss == "l2" else args.loss, options=ropts,
        checkpoint_path=ck1,
    )
    stats = {}
    t0 = time.perf_counter()
    params, losses = optimize_scene(scene, target, cfg, init_params=params_from_numpy(init, dev),
                                    callback=cb, stats_out=stats)
    _sync(dev)
    t_phase1 = time.perf_counter() - t0
    t_phase2 = 0.0

    if args.phase2_steps > 0:
        print(f"[flagship] phase 2: {args.phase2_loss} loss, {args.phase2_steps} steps at "
              f"{args.phase2_n ** 2} spp", flush=True)
        # a decaying albedo rate: under the pooled ab loss a constant one
        # leaves an lr-sized random walk around the optimum
        opt2 = MultiTransform(
            {"albedo": Adam(exponential_decay(args.phase2_lr_albedo, args.phase2_steps, 0.05)),
             "emission": Adam(args.phase2_lr_emission)},
            LABELS)

        def cb2(i, loss, p):
            cb(args.steps + i, loss, p)

        cfg2 = InverseRenderConfig(
            width=W, height=H, n=args.phase2_n, steps=args.phase2_steps, seed=args.seed + 1,
            log_every=10, trainable=("mat_color", "light_intensity"), optimizer=opt2,
            grad_mask=mask, loss_space=args.phase2_loss,
            loss_downsample=args.phase2_downsample if args.phase2_loss == "ab" else 1,
            loss_clamp=args.phase2_clamp, options=ropts, checkpoint_path=ck2,
            # pooling needs the whole image on one tile
            mesh_shape=(1, 1),
        )
        stats2 = {}
        t0 = time.perf_counter()
        params, losses2 = optimize_scene(scene, target2, cfg2, init_params=params,
                                         callback=cb2, stats_out=stats2)
        _sync(dev)
        t_phase2 = time.perf_counter() - t0
        losses = losses + losses2
        stats["phase2"] = stats2
    t_opt = t_phase1 + t_phase2

    final = _numpy(params)
    err0_albedo = _albedo_err(init, true_p, diffuse_rows)
    err0_emission = _emission_err(init, true_p)
    result = {
        "config": {
            "scene": args.scene, "res": [W, H],
            "target_spp": args.target_n ** 2, "steps": args.steps,
            "lr_albedo": args.lr_albedo, "lr_emission": args.lr_emission,
            "loss": args.loss,
            "phase2": {"steps": args.phase2_steps, "loss": "ab", "n": args.phase2_n,
                       "lr_albedo": args.phase2_lr_albedo,
                       "lr_emission": args.phase2_lr_emission},
            "trainable": ["mat_color[diffuse rows]", "light_intensity"],
        },
        "grad_sanitize_stats": stats,
        "device": str(dev),
        "target_render_s": round(t_target, 2),
        "optimize_s": round(t_opt, 2),
        # unrounded wall seconds (ends in a synchronize on the card)
        "timings": {"target_render_s": t_target, "phase1_s": t_phase1, "phase2_s": t_phase2},
        "init": {"albedo_mae": err0_albedo, "emission_rel_err": err0_emission},
        "final": {
            "albedo_mae": _albedo_err(final, true_p, diffuse_rows),
            "emission_rel_err": _emission_err(final, true_p),
            "loss_mean_last20": float(np.mean(losses[-20:])),
        },
        "true_albedo": true_p["mat_color"][diffuse_rows].tolist(),
        "recovered_albedo": final["mat_color"][diffuse_rows].tolist(),
        "true_emission": true_p["light_intensity"].tolist(),
        "recovered_emission": final["light_intensity"].tolist(),
        "curve": curve,
        "losses": losses,
    }
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"[flagship] wrote {args.out}: albedo_mae {err0_albedo:.4f} -> "
          f"{result['final']['albedo_mae']:.4f}, emission_rel {err0_emission:.4f} -> "
          f"{result['final']['emission_rel_err']:.4f}", flush=True)

    if args.save_images:
        from plutracer_tpu_torch.io.bmp import write_bmp
        from plutracer_tpu_torch.ops.tonemap import postprocess_image

        outdir = Path(args.out).resolve().parent
        outdir.mkdir(parents=True, exist_ok=True)
        write_bmp(str(outdir / "inverse_target.bmp"), postprocess_image(target).cpu().numpy())
        rec = render(apply_params(scene, params), W, H, 8, rng.PRNGKey(7))
        write_bmp(str(outdir / "inverse_recovered.bmp"), postprocess_image(rec).cpu().numpy())
        print(f"[flagship] images in {outdir}/", flush=True)
    result["params"] = params
    return result


if __name__ == "__main__":
    main()
