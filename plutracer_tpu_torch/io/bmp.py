"""BMP codec (24bpp uncompressed), numpy based.

Replaces the reference's vendored stb-style writer and hand-rolled reader
(src/texture.cpp:4-194). Convention: array row 0 is the TOP image row
(matching the reference framebuffer, where pixel (0,0) is the top-left);
BMP files store rows bottom-up, so we flip on read/write.
"""

from __future__ import annotations

import struct

import numpy as np


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) float array in [0,1] (or uint8) as 24bpp BMP."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(np.nan_to_num(img, nan=0.0), 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w = img.shape[:2]
    row_size = (w * 3 + 3) & ~3
    data_size = row_size * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM",
        14 + 40 + data_size,
        0,
        0,
        14 + 40,
        40,
        w,
        h,
        1,
        24,
        0,
        data_size,
        2835,
        2835,
        0,
        0,
    )
    # BGR, bottom-up, rows padded to 4 bytes
    bgr = img[::-1, :, ::-1]
    rows = np.zeros((h, row_size), np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


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
