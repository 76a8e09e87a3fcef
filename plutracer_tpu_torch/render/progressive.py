"""Progressive, checkpointable rendering.

The port of plutracer_tpu/render/progressive.py. The sample accumulator,
the next pass and the seed are written to an npz file between chunks of
passes, so an interrupted render resumes exactly: the randomness is
counter-based (pass s always draws from fold_in(key, s)) and the passes
are summed in stratum order whatever the chunking.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.render.renderer import PASS_CHUNK, _finalize, render_passes, zeros_accum
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions


def save_state(path: str, accum, next_pass: int, seed: int) -> None:
    """Atomically write (accum, next_pass, seed); accum is a tensor on any
    device or an array."""
    if isinstance(accum, torch.Tensor):
        accum = accum.cpu().numpy()
    tmp = path + ".tmp"
    np.savez(tmp, accum=np.asarray(accum, np.float32), next_pass=next_pass, seed=seed)
    os.replace(tmp + ".npz", path)


def load_state(path: str):
    """(accum as a float32 array, next_pass, seed)."""
    z = np.load(path)
    return np.asarray(z["accum"], np.float32), int(z["next_pass"]), int(z["seed"])


def render_with_checkpoint(
    scene,
    width: int,
    height: int,
    n: int,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
    options: RenderOptions = DEFAULT_OPTIONS,
):
    """Render n^2 stratified passes on the scene's device; optionally
    resume from and write to a checkpoint file. A checkpoint of another
    seed is refused. Returns the linear (H, W, 3) image."""
    spp = n * n
    checkpoint_every = max(1, checkpoint_every)
    key = rng.PRNGKey(seed)
    accum = zeros_accum(width, height, scene.device)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck_accum, start, ck_seed = load_state(checkpoint_path)
        if ck_seed != seed:
            raise ValueError(f"checkpoint seed {ck_seed} != requested seed {seed}")
        accum = torch.from_numpy(ck_accum).to(scene.device)
        print(f"resuming at pass {start}/{spp}")
    # checkpoints land on chunk boundaries aligned to checkpoint_every, so a
    # resumed run issues the same chunks
    chunk = min(PASS_CHUNK, checkpoint_every) if checkpoint_path else PASS_CHUNK
    s = start
    while s < spp:
        k = min(chunk, spp - s)
        if checkpoint_path:
            k = min(k, checkpoint_every - s % checkpoint_every)
        accum = render_passes(scene, key, s, width, height, n, k, options, accum=accum)
        s += k
        if checkpoint_path and (s % checkpoint_every == 0 or s == spp):
            save_state(checkpoint_path, accum, s, seed)
    return _finalize(accum, spp, width, height)
