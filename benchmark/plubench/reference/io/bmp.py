"""24bpp BMP reading, for image textures (the reference renderer's
texture2d loader, src/texture.cpp:4-65)."""

from __future__ import annotations

import struct

import numpy as np


def read_bmp(path: str) -> np.ndarray:
    """Read a 24bpp BMP into an (H, W, 3) float32 array in [0,1], row 0 = top."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    data_pos = struct.unpack_from("<I", raw, 0x0A)[0] or 54
    w = struct.unpack_from("<i", raw, 0x12)[0]
    h = struct.unpack_from("<i", raw, 0x16)[0]
    bpp = struct.unpack_from("<H", raw, 0x1C)[0]
    if bpp != 24:
        raise ValueError(f"{path}: only 24bpp BMP supported, got {bpp}")
    flip = h > 0
    h = abs(h)
    row_size = (w * 3 + 3) & ~3
    rows = np.frombuffer(raw, np.uint8, count=row_size * h, offset=data_pos)
    rows = rows.reshape(h, row_size)[:, : w * 3].reshape(h, w, 3)
    bgr = rows[::-1] if flip else rows
    return (bgr[:, :, ::-1].astype(np.float32)) / 255.0
