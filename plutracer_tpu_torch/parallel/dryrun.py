"""Dry runs of the multi-device path.

``dryrun_multichip`` is the port of the JAX package's
``__graft_entry__.dryrun_multichip`` on the repo's demo-box scene:

    python -m plutracer_tpu_torch.parallel.dryrun [N]

On an N-position mesh ((N/2, 2) when N is even, else (N, 1)) at 32x16, n = 2:
a sharded render; render_elastic on the same devices, bit-equal to render;
one sharded train step; the flagship variant (per-field Adams through
MultiTransform, the diffuse-row gradient mask, the log loss, step.many); and
the phase-2 variant on a (1, N) mesh (the clamped, pooled ab loss with
rematerialised bounces). Every loss must be finite and no gradient
non-finite. Runs on the card (its cards in turn when N exceeds their count;
[cuda:0] * 4 on a one-card machine); without a card it raises unless
`devices` lists CPU devices.

``mesh_jobs`` runs sharded renders and train steps (job specs) in this
process, and ``run_processes`` runs the same jobs in a job of several
processes under torch.distributed, each a worker
(``python -m plutracer_tpu_torch.parallel.dryrun --worker ...``) holding its
rows of the mesh. Held against each other, they show a result does not
depend on how the mesh is split over processes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.diff.optim import Adam, MultiTransform
from plutracer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, visible_devices
from plutracer_tpu_torch.parallel.sharded import get_params, make_train_step, render_sharded
from plutracer_tpu_torch.render.elastic import render_elastic
from plutracer_tpu_torch.render.renderer import render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.types import MAT_DIFFUSE
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

ROOT = Path(__file__).resolve().parents[2]
SCENE = ROOT / "scenes" / "demo-box.urn"
W, H, N = 32, 16, 2


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the dry run on `devices` (default: the visible cards in turn, n_devices of
    them). Returns the mesh shapes, the train losses and the non-finite
    gradient fractions."""
    if devices is None:
        cards = visible_devices("dryrun_multichip")
        devices = [cards[i % len(cards)] for i in range(n_devices)]
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    shape = (n_devices // 2, 2) if n_devices % 2 == 0 and n_devices > 1 else (n_devices, 1)
    mesh = make_mesh(shape, devices=devices)
    scene = compile_scene(load_scene_file(str(SCENE), ["/res", f"{W}x{H}"]), device=devices[0])

    img = render_sharded(scene, W, H, N, rng.PRNGKey(0), mesh)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all()), "sharded render"

    # passes are the elastic renderer's unit of migration: its image is
    # the single-device render's whatever the devices
    img_e = render_elastic(scene, W, H, N, 0, devices=devices)
    img_1 = render(scene, W, H, N, rng.PRNGKey(0)).cpu().numpy()
    assert np.array_equal(img_e, img_1), "render_elastic differs from render"

    # the sharded train step: a pass, the ab loss, reduced gradients, Adam
    step = make_train_step(scene, W, H, N, mesh)
    params = {k: v * 0.9 for k, v in get_params(scene).items()}
    target = img.reshape(-1, 3)
    params, _, loss = step(params, step.init(params), target, rng.PRNGKey(1), 0)
    assert bool(torch.isfinite(loss)), "train step loss"
    out = {"mesh": mesh.shape, "loss": float(loss)}
    print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} loss={float(loss):.6f}")

    # the flagship variant: per-field Adams, frozen non-diffuse rows, the
    # log loss, step.many
    diffuse = (scene.mat_type == MAT_DIFFUSE).to(torch.float32)[:, None]
    mask = {"mat_color": diffuse}
    opt = MultiTransform({"albedo": Adam(3e-2), "emission": Adam(10.0)},
                         {"mat_color": "albedo", "light_intensity": "emission",
                          "tex_c0": "albedo", "tex_c1": "albedo"})
    fstep = make_train_step(scene, W, H, N, mesh, optimizer=opt, loss_space="log",
                            trainable=("mat_color", "light_intensity"), grad_mask=mask,
                            project_nonnegative=True)
    fparams = {k: v * 0.5 for k, v in get_params(scene).items()}
    fparams, _, losses, nf = fstep.many(fparams, fstep.init(fparams), target,
                                        rng.PRNGKey(2), 0, 4)
    assert bool(torch.isfinite(losses).all()), "flagship losses"
    out["flagship_losses"], out["flagship_nonfinite"] = losses.tolist(), nf.tolist()
    print(f"dryrun_multichip({n_devices}): flagship inverse 4 steps ok "
          f"(losses={[round(x, 4) for x in losses.tolist()]}, nonfinite_frac={nf.tolist()})")

    # the phase-2 variant on the spp axis alone (pooling needs whole images)
    mesh2 = make_mesh((1, n_devices), devices=devices)
    p2step = make_train_step(scene, W, H, N, mesh2, optimizer=Adam(1e-2), loss_space="ab",
                             trainable=("mat_color",), grad_mask=mask, project_nonnegative=True,
                             loss_downsample=8, loss_clamp=20.0,
                             options=DEFAULT_OPTIONS.replace(remat_bounces=True))
    fparams, _, l2, nf2 = p2step.many(fparams, p2step.init(fparams), target,
                                      rng.PRNGKey(3), 0, 4)
    assert bool(torch.isfinite(l2).all()) and float(nf2.max()) == 0.0, "phase-2 variant"
    out["phase2_mesh"], out["phase2_losses"] = mesh2.shape, l2.tolist()
    print(f"dryrun_multichip({n_devices}): clamped pooled-ab phase-2 ok on spp mesh "
          f"(losses={[round(x, 4) for x in l2.tolist()]})")
    return out


def mesh_jobs(specs: Sequence[dict], devices: Sequence) -> Dict[str, np.ndarray]:
    """Run each job spec on a mesh of this process's `devices` (every
    process's under torch.distributed) and return its outputs as numpy
    arrays, job i's named "j{i}_...". A spec: {"kind": "render" or
    "train", "scene": path, "res": [w, h], "n": n, "seed": s, "shape":
    [tiles, spp]}, with "loss_space" for a train step. A render gives
    "image"; a train step (Adam(1e-2) on mat_color and light_intensity,
    from mat_color at half the scene's, against the 1-spp render of
    seed + 1, at stratum 0) gives "loss", the "param_*" and the optimiser
    state's "opt_*" leaves."""
    out = {}
    for i, spec in enumerate(specs):
        w, h = spec["res"]
        scene = compile_scene(load_scene_file(spec["scene"], ["/res", f"{w}x{h}"]),
                              device=devices[0])
        mesh = make_mesh(tuple(spec["shape"]), devices=devices)
        key = rng.PRNGKey(spec["seed"])
        if spec["kind"] == "render":
            img = render_sharded(scene, w, h, spec["n"], key, mesh)
            out[f"j{i}_image"] = img.cpu().numpy()
            continue
        target = render(scene, w, h, 1, rng.PRNGKey(spec["seed"] + 1)).reshape(-1, 3)
        opt = Adam(1e-2)
        step = make_train_step(scene, w, h, spec["n"], mesh, optimizer=opt,
                               loss_space=spec["loss_space"],
                               trainable=("mat_color", "light_intensity"))
        params = get_params(scene)
        params["mat_color"] = params["mat_color"] * 0.5
        params, state, loss = step(params, step.init(params), target, key, 0)
        out[f"j{i}_loss"] = loss.cpu().numpy()
        out.update({f"j{i}_param_{k}": v.cpu().numpy() for k, v in params.items()})
        out.update({f"j{i}_opt_{k}": v.cpu().numpy()
                    for k, v in enumerate(opt.state_leaves(state))})
    return out


def run_processes(specs: Sequence[dict], devices: Sequence[Sequence[str]],
                  timeout: float = 600.0, env: Optional[dict] = None) -> List[Dict[str, np.ndarray]]:
    """mesh_jobs in a job of len(devices) gloo worker processes, rank r on
    devices[r] (ranks may share a card), rendezvousing through a fresh
    file; every rank's outputs.
    A worker that fails or outlives `timeout` seconds fails the call (the
    others are killed); a worker's collectives time out after `timeout`."""
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "plutracer_tpu_torch.parallel.dryrun", "--worker",
             json.dumps(list(specs)), "--rank", str(r), "--world", str(len(devices)),
             "--init", init, "--devices", ",".join(devs),
             "--timeout", str(timeout), "--out", f"{tmp}/rank{r}.npz"],
            cwd=str(ROOT), env=dict(os.environ if env is None else env),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r, devs in enumerate(devices)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log[-3000:]}")
        return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(len(devices))]


def _worker(argv) -> None:
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True, help="the job specs, JSON")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--devices", required=True, help="this rank's devices, comma-separated")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    initialize_distributed(args.init, num_processes=args.world, process_id=args.rank,
                           backend="gloo", timeout=args.timeout)
    try:
        out = mesh_jobs(json.loads(args.worker), [torch.device(d) for d in args.devices.split(",")])
    finally:
        dist.destroy_process_group()
    np.savez(args.out, **out)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        _worker(sys.argv[1:])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
