"""R2: the pass loop's camera stage on the card, a launch's strata at once.

``camera_rays_cuda(cam, px0, keys, strata, n)`` launches csrc/camera.cu:
the (S*B, 3) float32 origins and directions of a launch of S =
len(strata) strata of the B pixels px0, stratum j from cell strata[j]
and the pixel and lens jitter uniform(k_px, (B, 2)) and uniform(k_lens,
(B, 2)) of its keys keys[j] = (k_px, k_lens) (``renderer.launch_draws``
hands them back), drawn inside the kernel; bit-equal to
``renderer.camera_rays_plain`` on the card. It replaces the camera stage
that XLA fuses into the JAX package's render_passes, jitter draw included
(plutracer_tpu/render/renderer.py:36-43, plutracer_tpu/ops/camera.py:18-45):
the pass loop makes one launch of it a pass-loop launch
(render/renderer.launch_rays).

The strata's cells and key words go to the kernel by value (no table, no
copy to the card); the camera is read from a table on the card
(``camera_table``), built once a camera and kept on it.
``camera_rays_table_cuda(cam, px0, table, n)`` is the same launch with
the cells and key words read from an (S, STRATUM_WORDS) int32 table on
the card (cell, then k_px's and k_lens's words as int32 bit patterns),
the same kernel body and so the same bits: a launch captured in a CUDA
graph (parallel/sharded's train step) keeps its arguments from the
capture, so its strata come from a buffer written before each replay.
Each launch counts once in utils/profiling's ``launches.r2``.
"""

from __future__ import annotations

import ctypes

import torch

from plutracer_tpu_torch.utils import profiling

MAX_STRATA = 16  # the most strata a launch (csrc/camera.cu: PLU_MAX_STRATA)
STRATUM_WORDS = 5  # int32 words a stratum of a table on the card (csrc/camera.cu)
_FIELDS = ("pos", "look", "right", "up", "inv_image_size", "w", "lens_radius", "focal_distance")


class Strata(ctypes.Structure):
    """A launch's strata, passed by value (csrc/camera.cu PluStrata): each
    stratum's cell and its jitter keys' four words, k_px's then k_lens's."""

    _fields_ = [("cell", ctypes.c_int * MAX_STRATA), ("key", ctypes.c_uint32 * (4 * MAX_STRATA))]


def jitter_words(keys, S: int):
    """The 4 * S uint32 words of S (k_px, k_lens) pairs of (k1, k2) ints,
    in launch order; raises on anything else."""
    if len(keys) != S:
        raise ValueError(f"camera_rays_cuda: {len(keys)} jitter key pairs for {S} strata")
    words = []
    for pair in keys:
        if len(pair) != 2 or any(len(k) != 2 for k in pair):
            raise ValueError(f"camera_rays_cuda: a stratum's jitter keys are (k_px, k_lens) "
                             f"pairs of two words, got {pair}")
        words += [w for k in pair for w in k]
    if not all(isinstance(w, int) and 0 <= w <= 0xFFFFFFFF for w in words):
        raise ValueError(f"camera_rays_cuda: jitter key words must be ints in [0, 2**32), got "
                         f"{words}")
    return words


def camera_table(cam) -> torch.Tensor:
    """(17,) float32 on the camera's device: pos, look, right, up,
    inv_image_size, w, lens_radius, focal_distance, the layout
    csrc/camera.cu reads. Built once a camera (and again only if one of
    its tensors is replaced or changed in place) and kept on it."""
    parts = [getattr(cam, f) for f in _FIELDS]
    versions = [t._version for t in parts]
    held = cam.__dict__.get("_r2_table")
    if (held is None or held[1] != versions
            or any(a is not b for a, b in zip(held[0], parts))):
        table = torch.cat([t.reshape(-1).to(torch.float32) for t in parts]).contiguous()
        held = (parts, versions, table)
        cam.__dict__["_r2_table"] = held
    return held[2]


def _check(what: str, t: torch.Tensor, shape, dev) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"camera_rays_cuda: {what} must be a contiguous float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"camera_rays_cuda: {what} on {t.device}, not {dev}")
    if t.data_ptr() % 8:
        raise ValueError(f"camera_rays_cuda: {what} must be 8-byte aligned")


def _launch_shape(px0: torch.Tensor, S: int, n: int, what: str):
    """(device, B) of a launch of S strata over px0, after the checks both
    entry points share."""
    dev = px0.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {dev}")
    B = px0.shape[0]
    if not 1 <= S <= MAX_STRATA:
        raise ValueError(f"{what}: 1 to {MAX_STRATA} strata a launch, got {S}")
    if n < 1:
        raise ValueError(f"{what}: an n = {n} grid")
    if S * B >= 2**31:
        raise ValueError(f"{what}: {S} x {B} rays, at most 2**31 - 1")
    return dev, B


def camera_rays_cuda(cam, px0: torch.Tensor, keys, strata, n: int):
    """Launch R2 on px0's CUDA device and its current stream (no
    synchronisation): (o, d), (S*B, 3) float32 each, views of one buffer.
    One launch for 1 <= S <= MAX_STRATA; raises on anything else, a CPU
    tensor included, and never falls back to the plain version."""
    from plutracer_tpu_torch.ops.cuda import build

    strata = [int(s) for s in strata]
    S, n = len(strata), int(n)
    dev, B = _launch_shape(px0, S, n, "camera_rays_cuda")
    if min(strata) < 0 or max(strata) >= 2**31:
        raise ValueError(f"camera_rays_cuda: cells {strata} of an n = {n} grid")
    words = jitter_words(keys, S)
    table = camera_table(cam)
    _check("px0", px0, (B, 2), dev)
    _check("the camera table", table, (17,), dev)
    out = torch.empty((2, S * B, 3), dtype=torch.float32, device=dev)
    o, d = out[0], out[1]
    if B == 0:
        return o, d
    lib = build.load().lib
    with build.on_device(dev) as stream:
        rc = lib.plu_camera_rays(table.data_ptr(), px0.data_ptr(),
                                 Strata((ctypes.c_int * MAX_STRATA)(*strata),
                                        (ctypes.c_uint32 * (4 * MAX_STRATA))(*words)),
                                 S, B, n, o.data_ptr(), d.data_ptr(), stream)
    build.check(rc, "plu_camera_rays")
    profiling.count("launches.r2")
    return o, d


def camera_rays_table_cuda(cam, px0: torch.Tensor, table: torch.Tensor, n: int):
    """camera_rays_cuda with the strata's cells and jitter key words read
    on the card from `table`, (S, STRATUM_WORDS) int32 on px0's card (each
    row: the cell, then k_px's and k_lens's words as int32 bit patterns),
    not passed by value: one launch, nothing copied to the card and no
    synchronisation, so a CUDA graph can capture it. A cell outside [0,
    n * n) is the caller's to prevent (the table is read only on the
    card). Raises on anything else the kernel does not take."""
    from plutracer_tpu_torch.ops.cuda import build

    n = int(n)
    if table.dim() != 2 or table.shape[1] != STRATUM_WORDS:
        raise ValueError(f"camera_rays_table_cuda: the table must be (S, {STRATUM_WORDS}), "
                         f"got {tuple(table.shape)}")
    S = table.shape[0]
    dev, B = _launch_shape(px0, S, n, "camera_rays_table_cuda")
    if table.dtype != torch.int32 or not table.is_contiguous() or table.device != dev:
        raise ValueError(f"camera_rays_table_cuda: the table must be contiguous int32 on {dev}, "
                         f"got {table.dtype} on {table.device}")
    cam_table = camera_table(cam)
    _check("px0", px0, (B, 2), dev)
    _check("the camera table", cam_table, (17,), dev)
    out = torch.empty((2, S * B, 3), dtype=torch.float32, device=dev)
    o, d = out[0], out[1]
    if B == 0:
        return o, d
    lib = build.load().lib
    with build.on_device(dev) as stream:
        rc = lib.plu_camera_rays_table(cam_table.data_ptr(), px0.data_ptr(), table.data_ptr(),
                                       S, B, n, o.data_ptr(), d.data_ptr(), stream)
    build.check(rc, "plu_camera_rays_table")
    profiling.count("launches.r2")
    return o, d
