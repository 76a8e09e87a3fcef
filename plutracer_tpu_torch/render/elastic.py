"""Elastic, fault-tolerant progressive rendering.

The port of plutracer_tpu/render/elastic.py over torch devices: a
``parallel.mesh.Mesh`` of them in place of a jax Mesh (``pass_stack``),
a list of them for ``render_elastic``. The stratified PASS is the unit of
migration:

- Pass ``s`` is a full-image program keyed by ``fold_in(key, s)``, the
  per-pass sample stream of ``renderer.render_passes``, so a pass gives
  the same radiance, bit for bit, whichever device computes it and
  however many devices share the chunk.
- A chunk's strata go to the devices in contiguous blocks. Each device
  renders its block as render_passes does (strata_per_launch strata a
  launch on the kernel path); the host takes every pass back unsummed and
  adds them in stratum order as float32, the single device's order.
- The render state is therefore free of the device list: ``(accum,
  next_pass, seed)``. A job checkpointed on four devices resumes on one,
  or on the CPU, with the same image (the supervisor tests hold it bit
  for bit through crash, hang and fewer-device histories).

``render/supervisor.py`` builds failure detection (exit codes and a
stale heartbeat) and automatic restart on top of this module.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.parallel.mesh import Mesh, scene_replicas, spp_row, visible_devices
from plutracer_tpu_torch.render.progressive import load_state, save_state
from plutracer_tpu_torch.render.renderer import pixel_centers, stratum_launches
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions

__all__ = ["render_elastic", "pass_stack"]


def pass_stack(
    scene,
    key,
    strata: Sequence[int],
    width: int,
    height: int,
    n: int,
    options: RenderOptions,
    mesh: Mesh,
    *,
    on_pass: Optional[Callable[[int], None]] = None,
) -> np.ndarray:
    """The given strata rendered as a stacked (len(strata), H*W, 3) float32
    array: the JAX package's pass_stack(scene, key, strata, width, height,
    n, options, mesh). The strata go in contiguous blocks over the mesh's
    ``spp`` positions (its first tile row, which must be this process's);
    the scene is copied once to each distinct device of them
    (``parallel.mesh.scene_replicas``). Row i is pass strata[i] of
    ``renderer.render_passes``, bit for bit, whatever the mesh. Unlike
    JAX's, no padding rows are returned: exactly len(strata) rows. The
    devices launch in turns, so their work overlaps; each pass's radiance
    is copied back as its launch ends, and ``on_pass(stratum)`` fires for
    it."""
    row = mesh.grid[0]
    if any(pos.rank != mesh.rank for pos in row):
        raise ValueError("pass_stack: the mesh's spp positions must all be this process's")
    scenes = scene_replicas(scene, [pos.device for pos in row])
    strata = [int(s) for s in strata]
    size = -(-len(strata) // len(scenes))
    blocks = [strata[i * size:(i + 1) * size] for i in range(len(scenes))]
    work = [(stratum_launches(sc, key, [(s, s) for s in blk],
                              pixel_centers(width, height, sc.device), n, options), blk)
            for sc, blk in zip(scenes, blocks) if blk]
    out: List[List[np.ndarray]] = [[] for _ in work]
    live = list(range(len(work)))
    while live:
        launched = []
        for i in live:
            try:
                launched.append((i, next(work[i][0])))
            except StopIteration:
                pass
        for i, passes in launched:
            for L in passes:
                out[i].append(L.cpu().numpy())
                if on_pass is not None:
                    on_pass(work[i][1][len(out[i]) - 1])
        live = [i for i, _ in launched]
    return np.stack([p for dev_passes in out for p in dev_passes])


def _parse_fault() -> Optional[tuple]:
    """Fault injection for the supervisor tests: PLUTRACER_FAULT=
    "crash:N" | "hang:N" faults after the chunk holding pass N is rendered
    but BEFORE its checkpoint is saved, so the work since the last
    checkpoint is lost, which is the failure the supervisor must recover
    from. The supervisor sets it on the first launch only."""
    spec = os.environ.get("PLUTRACER_FAULT", "")
    if not spec:
        return None
    kind, _, at = spec.partition(":")
    return (kind, int(at))


def render_elastic(
    scene,
    width: int,
    height: int,
    n: int,
    seed: int = 0,
    *,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
    options: RenderOptions = DEFAULT_OPTIONS,
    devices: Optional[Sequence] = None,
    on_chunk: Optional[Callable[[int], None]] = None,
    on_pass: Optional[Callable[[int], None]] = None,
):
    """Render n^2 stratified passes over a list of devices.

    Equal to ``renderer.render`` bit for bit (the same per-pass sample
    stream, the same stratum-order float32 sum and division by spp), with
    the passes spread over ``devices`` (default: every visible CUDA device)
    and the accumulator on the host, so the checkpoint is valid for any
    later device list. The passes go through ``pass_stack`` over the
    (1, len(devices)) mesh of the list (``parallel.mesh.spp_row``), one
    chunk a call, each call copying the scene to the devices it does not
    live on.
    ``on_pass(stratum)`` fires as each pass comes back and
    ``on_chunk(next_pass)`` after each checkpointed chunk: the supervisor's
    worker beats its heartbeat on both.

    Returns the linear (H, W, 3) image as a numpy array.
    """
    devs = visible_devices("render_elastic") if devices is None else devices
    mesh = spp_row(devs)
    spp = n * n
    checkpoint_every = max(1, checkpoint_every)
    key = rng.PRNGKey(seed)
    accum = np.zeros((height * width, 3), np.float32)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck_accum, start, ck_seed = load_state(checkpoint_path)
        if ck_seed != seed:
            raise ValueError(f"checkpoint seed {ck_seed} != requested {seed}")
        accum = ck_accum
    fault = _parse_fault()
    s = start
    while s < spp:
        # chunk boundaries are absolute multiples of checkpoint_every, so a
        # resumed run issues the same chunks
        k = min(checkpoint_every - s % checkpoint_every, spp - s)
        stack = pass_stack(scene, key, range(s, s + k), width, height, n, options, mesh,
                           on_pass=on_pass)
        for i in range(k):  # stratum-order float32 adds
            accum = accum + stack[i]
        s += k
        if fault is not None and s > fault[1]:
            if fault[0] == "hang":
                while True:  # the heartbeat goes stale; the supervisor kills us
                    time.sleep(1.0)
            os._exit(13)
        if checkpoint_path:
            save_state(checkpoint_path, accum, s, seed)
        if on_chunk is not None:
            on_chunk(s)
    return (accum / np.float32(spp)).reshape(height, width, 3)
