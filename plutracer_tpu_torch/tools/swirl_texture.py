"""Write scenes/swirl256.bmp, the 256x256 image texture of
scenes/textured256.urn (65,536 texels: an atlas far past the 4,096-texel
VMEM cap of the JAX package's TPU kernel). The image is the sinusoidal
colour swirl of scenes/swirl.bmp, drawn at 256x256:

    python -m plutracer_tpu_torch.tools.swirl_texture [--n 256] [--out PATH]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from plutracer_tpu_torch.io.bmp import write_bmp

REPO = pathlib.Path(__file__).resolve().parents[2]


def swirl(n: int) -> np.ndarray:
    """(n, n, 3) float32 in [0, 1]: the swirl of scenes/swirl.bmp (n = 64)
    at n x n."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / n
    ang = np.arctan2(y - 0.5, x - 0.5)
    r = np.hypot(x - 0.5, y - 0.5)
    img = np.stack([
        0.55 + 0.45 * np.sin(9.0 * r * np.pi + 3.0 * ang),
        0.50 + 0.45 * np.sin(7.0 * x * np.pi + 2.0),
        0.50 + 0.45 * np.cos(6.0 * y * np.pi + 5.0 * r),
    ], axis=-1)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", default=str(REPO / "scenes" / "swirl256.bmp"))
    args = ap.parse_args(argv)
    write_bmp(args.out, swirl(args.n))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
