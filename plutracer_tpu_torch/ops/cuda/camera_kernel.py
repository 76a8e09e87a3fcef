"""R2: the pass loop's camera stage on the card, a launch's strata at once.

``camera_rays_table_cuda(cam, px0, table, n)`` launches csrc/camera.cu:
the (S*B, 3) float32 origins and directions of a launch of S strata of
the B pixels px0, stratum j from the cell and the jitter keys (k_px,
k_lens) of row j of `table`, an (S, STRATUM_WORDS) int32 table on the
card (the cell, then k_px's and k_lens's words as int32 bit patterns:
the second part of render/renderer.launch_words' block). The pixel and
lens jitter uniform(k_px, (B, 2)) and uniform(k_lens, (B, 2)) are drawn
inside the kernel; bit-equal to ``renderer.camera_rays_table_plain`` on
the card. It replaces the camera stage that XLA fuses into the JAX
package's render_passes, jitter draw included
(plutracer_tpu/render/renderer.py:36-43, plutracer_tpu/ops/camera.py:
18-45): the pass loop makes one launch of it a pass-loop launch
(render/renderer.launch_rays_table).

The table is read on the card, so a launch captured in a CUDA graph
(parallel/sharded's train step) draws anew from the words written
before each replay; the camera is read from a table on the card too
(``camera_table``), built once a camera and kept on it. Each launch
counts once in utils/profiling's ``launches.r2``.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.utils import profiling

MAX_STRATA = 16  # the most strata a launch (csrc/camera.cu: PLU_MAX_STRATA)
STRATUM_WORDS = 5  # int32 words a row of the table (csrc/camera.cu)
_FIELDS = ("pos", "look", "right", "up", "inv_image_size", "w", "lens_radius", "focal_distance")


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
        raise ValueError(f"camera_rays_table_cuda: {what} must be a contiguous float32 {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"camera_rays_table_cuda: {what} on {t.device}, not {dev}")
    if t.data_ptr() % 8:
        raise ValueError(f"camera_rays_table_cuda: {what} must be 8-byte aligned")


def camera_rays_table_cuda(cam, px0: torch.Tensor, table: torch.Tensor, n: int):
    """Launch R2 on px0's CUDA device and its current stream (nothing
    copied to the card, no synchronisation): (o, d), (S*B, 3) float32
    each, views of one buffer. One launch for 1 <= S <= MAX_STRATA rows of
    a contiguous int32 table on px0's card; a cell outside [0, n * n) is
    the caller's to prevent (the table is read only on the card). Raises
    on anything else the kernel does not take, a CPU tensor included, and
    never falls back to the plain version."""
    from plutracer_tpu_torch.ops.cuda import build

    n = int(n)
    dev = px0.device
    if dev.type != "cuda":
        raise ValueError(f"camera_rays_table_cuda: needs CUDA tensors, got {dev}")
    if table.dim() != 2 or table.shape[1] != STRATUM_WORDS:
        raise ValueError(f"camera_rays_table_cuda: the table must be (S, {STRATUM_WORDS}), "
                         f"got {tuple(table.shape)}")
    S, B = table.shape[0], px0.shape[0]
    if not 1 <= S <= MAX_STRATA:
        raise ValueError(f"camera_rays_table_cuda: 1 to {MAX_STRATA} strata a launch, got {S}")
    if n < 1:
        raise ValueError(f"camera_rays_table_cuda: an n = {n} grid")
    if S * B >= 2**31:
        raise ValueError(f"camera_rays_table_cuda: {S} x {B} rays, at most 2**31 - 1")
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
