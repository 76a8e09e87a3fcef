"""Image I/O: BMP read/write and bitmap-font text drawing."""

from plutracer_tpu_torch.io.bmp import read_bmp, write_bmp
from plutracer_tpu_torch.io.font import draw_text

__all__ = ["read_bmp", "write_bmp", "draw_text"]
