"""Failure detection and automatic restart for long renders.

The port of plutracer_tpu/render/supervisor.py. A render worker runs in a
subprocess of its own session, and the supervisor recovers from the two
failure modes of accelerator jobs:

- **Crash** (a non-zero exit, a killed process, or an exit 0 that left no
  readable result): seen in the exit code and the result file.
- **Hang** (a wedged device or host): seen in a liveness heartbeat. The
  worker touches a heartbeat file at start, after its imports, after its
  set-up and after every pass; a heartbeat older than
  ``heartbeat_timeout`` gets the worker's process group killed. The file
  is touched before each launch, so a worker that wedges before its first
  beat still times out.

Either way the supervisor relaunches the worker, which resumes from the
last checkpoint written by ``render/elastic.py``. That checkpoint does not
depend on the device list, so each launch may use a different number of
devices (``device_counts``) and the final image is still bit-identical to
the same supervised job run without a failure. A ``.job`` fingerprint
beside the checkpoint makes a worker refuse a checkpoint of another job.

Worker entry point: ``python -m plutracer_tpu_torch.render.supervisor
--worker ...`` (in this module, so the subprocess needs only the package).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["supervise_render", "SuperviseResult", "WorkerFailure"]


class WorkerFailure(RuntimeError):
    """Raised when the worker keeps failing past max_restarts."""


@dataclass
class SuperviseResult:
    image: np.ndarray  # linear (H, W, 3)
    restarts: int
    events: List[Tuple[str, str]] = field(default_factory=list)


def _launch(args, env, log_path):
    log = open(log_path, "ab")
    # own session: one killpg stops the worker and anything it spawned, by
    # exact process group id (never by pattern)
    return subprocess.Popen(args, env=env, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True), log


def _read_result(path: str) -> Optional[np.ndarray]:
    try:
        with np.load(path) as z:
            return np.asarray(z["linear"])
    except (OSError, KeyError, ValueError):
        return None


def supervise_render(
    scene_path: str,
    width: int,
    height: int,
    n: int,
    seed: int,
    workdir: str,
    *,
    scene_args: Optional[Sequence[str]] = None,
    max_restarts: int = 3,
    heartbeat_timeout: float = 120.0,
    checkpoint_every: int = 8,
    device: str = "cuda",
    device_counts: Optional[Sequence[Optional[int]]] = None,
    inject_fault: Optional[str] = None,
    poll: float = 0.5,
) -> SuperviseResult:
    """Run a supervised render; returns the finished linear image.

    ``device`` is where the worker renders, ``cuda`` or ``cpu``; the worker
    never falls back to the CPU. ``device_counts[i]`` is the number of
    devices in launch ``i``'s list (None: every visible CUDA device, or one
    CPU); the last entry is reused for later launches. ``inject_fault`` (a
    PLUTRACER_FAULT spec, e.g. "crash:4") is set on the first launch only:
    the test hook for the recovery path.
    """
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "render.ckpt.npz")
    hb = os.path.join(workdir, "heartbeat")
    out = os.path.join(workdir, "result.npz")
    log_path = os.path.join(workdir, "worker.log")
    events: List[Tuple[str, str]] = []
    restarts = 0
    # the worker imports this package whatever its working directory
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    counts = list(device_counts) if device_counts else [None]
    for launch in range(max_restarts + 1):
        env = dict(os.environ)
        env.pop("PLUTRACER_FAULT", None)
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        if inject_fault and launch == 0:
            env["PLUTRACER_FAULT"] = inject_fault
        count = counts[min(launch, len(counts) - 1)]
        args = [
            sys.executable, "-m", "plutracer_tpu_torch.render.supervisor",
            "--worker", "--scene", scene_path, "--res", f"{width}x{height}",
            "--n", str(n), "--seed", str(seed), "--ckpt", ckpt,
            "--heartbeat", hb, "--out", out,
            "--checkpoint-every", str(checkpoint_every), "--device", device,
        ]
        if count is not None:
            args += ["--devices", str(count)]
        for a in scene_args or []:
            args += ["--scene-arg", a]
        if os.path.exists(out):
            os.remove(out)  # a result must come from this launch
        with open(hb, "w"):
            pass
        proc, log = _launch(args, env, log_path)
        events.append(("launch", f"#{launch} devices={count} pid={proc.pid}"))
        failed = None
        while True:
            rc = proc.poll()
            if rc is not None:
                if rc != 0:
                    failed = f"exit code {rc}"
                break
            if time.time() - os.path.getmtime(hb) > heartbeat_timeout:
                failed = f"heartbeat stale > {heartbeat_timeout}s"
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
                break
            time.sleep(poll)
        log.close()
        if failed is None:
            image = _read_result(out)
            if image is not None:
                events.append(("done", f"after {restarts} restart(s)"))
                return SuperviseResult(image, restarts, events)
            failed = "exit code 0 without a readable result"
        events.append(("failure", failed))
        restarts += 1
    raise WorkerFailure(f"worker failed {max_restarts + 1} times; events: {events}")


# --------------------------------------------------------------------------
# worker entry point (subprocess side)
# --------------------------------------------------------------------------


def _worker(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--res", required=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--heartbeat", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--scene-arg", action="append", default=[])
    a = ap.parse_args(argv)

    def beat(*_) -> None:
        with open(a.heartbeat, "a"):
            pass
        os.utime(a.heartbeat, None)

    beat()  # liveness from process start (imports and set-up count)
    if not os.path.isfile(a.scene):  # fail before the slow imports
        raise SystemExit(f"scene {a.scene} not found")

    import torch

    from plutracer_tpu_torch.cli import resolve_device
    from plutracer_tpu_torch.render.elastic import render_elastic
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    beat()
    dev = resolve_device(a.device)  # raises without a card; never the CPU instead
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        count = visible if a.devices is None else a.devices
        if not 1 <= count <= visible:
            raise SystemExit(f"--devices {count}: {visible} CUDA device(s) visible")
        devices = [torch.device("cuda", i) for i in range(count)]
    else:
        devices = [dev] * (a.devices or 1)

    w, h = (int(v) for v in a.res.split("x"))
    # refuse a checkpoint left by a DIFFERENT job in the same workdir (the
    # same seed but another scene or resolution would silently blend): the
    # job's fingerprint rides beside the checkpoint
    job = f"{os.path.abspath(a.scene)}|{a.res}|n={a.n}|seed={a.seed}"
    tag = a.ckpt + ".job"
    if os.path.exists(a.ckpt) and os.path.exists(tag):
        with open(tag) as f:
            if f.read() != job:
                raise SystemExit(f"checkpoint {a.ckpt} belongs to a different job; "
                                 "remove it or use a fresh workdir")
    with open(tag, "w") as f:
        f.write(job)

    scene = compile_scene(load_scene_file(a.scene, ["/res", a.res, *a.scene_arg]),
                          device=devices[0])
    beat()
    img = render_elastic(scene, w, h, a.n, a.seed, checkpoint_path=a.ckpt,
                         checkpoint_every=a.checkpoint_every, devices=devices,
                         on_chunk=beat, on_pass=beat)
    tmp = a.out + ".tmp"
    np.savez(tmp, linear=np.asarray(img, np.float32))
    os.replace(tmp + ".npz", a.out)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
