"""Command-line driver (reference: src/main.cpp:115-215).

    python -m plutracer_tpu_torch [/i] <scene.urn> [/res WxH] [/smp N]
        [/o out.bmp] [/seed N] [/device cuda|cpu] [/checkpoint PATH]
        [/supervise] [/profile DIR]

- ``/i`` opens the urn REPL first (``:!q`` continues, ``:!x`` exits 42);
- ``/res WxH`` and ``/smp N`` override scene resolution / AA samples
  (spp = N^2, matching src/main.cpp:170's uvec2(N) stratified grid);
- ``/o PATH`` output path (default ``image_<epoch-ns>.bmp``), written
  with the watermark (scene path + phase timings + mode tag) drawn twice
  for a drop shadow;
- ``/seed N`` RNG seed (renders are deterministic per seed);
- ``/device`` where to render; default ``cuda``. Asking for CUDA on a
  machine without a GPU is an error, never a silent CPU render;
- ``/checkpoint PATH`` save and resume the progressive accumulation state
  (render/progressive.py): a rerun with the same flags resumes from the
  last chunk written;
- ``/supervise`` render under the failure-detecting supervisor
  (render/supervisor.py): the render runs in a worker subprocess with a
  heartbeat and checkpoints, and a crash or hang is restarted from the
  last checkpoint. With ``/supervise``, ``/checkpoint`` names the
  supervisor's work DIRECTORY (heartbeat, checkpoint and result live
  there); without it, a per-(scene, resolution, seed) directory is made in
  the working directory;
- ``/profile DIR`` write a torch.profiler trace of the render phase into
  DIR (utils/profiling.profile_trace: a Chrome trace
  ``<host>_<pid>.<ns>.pt.trace.json``); ignored under /supervise,
  where the render runs in another process.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch


def pathlib_stem(path: str) -> str:
    """The file name of `path` without its last suffix."""
    return pathlib.Path(path).stem


def _pop_flag(args: List[str], flag: str) -> Optional[str]:
    if flag in args:
        i = args.index(flag)
        if i + 1 >= len(args):
            raise SystemExit(f"{flag} needs a value")
        v = args[i + 1]
        del args[i : i + 2]
        return v
    return None


def _pop_switch(args: List[str], flag: str) -> bool:
    if flag in args:
        args.remove(flag)
        return True
    return False


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "/device cuda was asked for but no CUDA device is available; "
            "pass /device cpu to render on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"/device must be cuda or cpu, got {name!r}")
    return dev


class RenderResult(NamedTuple):
    linear: torch.Tensor  # (H, W, 3) linear radiance on the render device (CPU if supervised)
    out_path: str
    integrator: str  # "kernel", "plain", or "supervised" (the worker's choice)
    render_seconds: float
    tier: Optional[str] = None  # the kernel path's integrator.kernel_tier: k2, k3 or k4


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)

    if args and args[0] == "/i":
        args.pop(0)
        from plutracer_tpu_torch.urn.repl import run_repl

        run_repl()
        if not args:
            return 0

    if not args:
        print(
            "usage: plutracer_tpu_torch [/i] <scene.urn> [/res WxH] [/smp N] "
            "[/o out.bmp] [/seed N] [/device cuda|cpu] [/checkpoint PATH] "
            "[/supervise] [/profile DIR]"
        )
        return 2
    run(args)
    return 0


def run(args: List[str]) -> RenderResult:
    """Render the scene named in the CLI arguments (everything after the
    optional /i), write the BMP, and return what was rendered."""
    args = list(args)
    out_path = _pop_flag(args, "/o")
    seed = int(_pop_flag(args, "/seed") or 0)
    device = resolve_device(_pop_flag(args, "/device") or "cuda")
    profile_dir = _pop_flag(args, "/profile")
    checkpoint = _pop_flag(args, "/checkpoint")
    supervise = _pop_switch(args, "/supervise")

    scn_path = args.pop(0)
    print(f"loading scene {scn_path}")

    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
    from plutracer_tpu_torch.render.integrator import kernel_tier, resolve_integrator_backend
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    # --- init phase: parse (+ compile, unless supervised) scene ---
    init_start = time.perf_counter()
    desc = load_scene_file(scn_path, args)
    width, height = desc.resolution
    if not supervise:
        scene = compile_scene(desc, device=device)
    init_end = time.perf_counter()

    if supervise:
        # the device work happens in the worker subprocess only: this process
        # watches the heartbeat and restarts from the checkpoint
        from plutracer_tpu_torch.render.supervisor import supervise_render

        if profile_dir:
            print("(/profile is ignored under /supervise: the render runs in a worker process)")
        workdir = checkpoint or f".supervise_{pathlib_stem(scn_path)}_{width}x{height}_s{seed}"
        if os.path.exists(workdir) and not os.path.isdir(workdir):
            raise SystemExit(f"/checkpoint {workdir} is a file; under /supervise it names the "
                             "supervisor's work directory")
        backend, tier = "supervised", None
        print(f"rendering on {device} in a supervised worker (work directory {workdir})... ")
        render_start = time.perf_counter()
        result = supervise_render(scn_path, width, height, desc.samples, seed, workdir,
                                  device=device.type)
        if result.restarts:
            print(f"(recovered from {result.restarts} worker failure(s))")
        linear = torch.from_numpy(result.image)
        render_end = time.perf_counter()
    else:
        from plutracer_tpu_torch.render.progressive import render_with_checkpoint

        backend = resolve_integrator_backend(scene, DEFAULT_OPTIONS, device)
        tier = kernel_tier(scene, DEFAULT_OPTIONS) if backend == "kernel" else None
        print(f"rendering on {device} with the {backend} integrator"
              f"{f' ({tier})' if tier else ''}... ")
        from plutracer_tpu_torch.utils.profiling import profile_trace

        with profile_trace(profile_dir) if profile_dir else contextlib.nullcontext():
            render_start = time.perf_counter()
            linear = render_with_checkpoint(scene, width, height, desc.samples, seed=seed,
                                            checkpoint_path=checkpoint)
            if device.type == "cuda":
                torch.cuda.synchronize()
            render_end = time.perf_counter()
        if profile_dir:
            print(f"profile: a trace in {profile_dir}")

    print("postprocessing... ")
    from plutracer_tpu_torch.ops.tonemap import postprocess_image

    pp_start = time.perf_counter()
    img = postprocess_image(linear).cpu().numpy().astype(np.float32)
    pp_end = time.perf_counter()
    print("... finished")

    init_ms = int((init_end - init_start) * 1000)
    render_ms = int((render_end - render_start) * 1000)
    pp_ms = int((pp_end - pp_start) * 1000)
    watermark = (
        f"scene: {scn_path}\n"
        f"init took: {init_ms}ms\n"
        f"render took: {render_ms}ms\n"
        f"postprocess took: {pp_ms}ms\n"
        f"torch-{device.type}\n"
    )
    print(watermark, end="")

    from plutracer_tpu_torch.io.bmp import write_bmp
    from plutracer_tpu_torch.io.font import draw_text

    draw_text(img, watermark, (9, 10), (0.2, 0.2, 0.2))  # drop shadow
    draw_text(img, watermark, (8, 8), (1.0, 0.6, 0.0))
    if out_path is None:
        out_path = f"image_{time.time_ns()}.bmp"
    write_bmp(out_path, img)
    print(f"wrote {out_path}")
    return RenderResult(linear, out_path, backend, render_end - render_start, tier)


if __name__ == "__main__":
    sys.exit(main())
