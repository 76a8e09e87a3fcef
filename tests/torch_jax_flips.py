"""Census of the pixels where the port's render_sharded and the JAX
package's disagree, by mesh and seed, on the CPU.

    python tests/torch_jax_flips.py [--seeds 0 1 2]

Demo-box 32x24, n = 2, on the 1x1, (2, 2) and (4, 2) meshes (JAX on 8
virtual CPU devices, the port on [cpu] * 8). For each mesh and seed it
prints the |log1p| difference's p99 and mean, the pixels over 0.05 (the
golden bound's p99 level) and, for each such pixel, its tile and both
packages' values. The two run the same estimator at the same keys in
different float32 arithmetic (XLA contracts products into FMAs), so a
lane at a knife edge can take another path; the mesh changes each
pixel's keys and so which lanes land there. tests/test_torch_parallel.py
holds the meshes within the bounds this census explains.
"""

import argparse
import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = " ".join([os.environ.get("XLA_FLAGS", ""),
                                    "--xla_force_host_platform_device_count=8",
                                    "--xla_cpu_multi_thread_eigen=false"])
REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from plutracer_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from plutracer_tpu.parallel.sharded import render_sharded as jax_render_sharded  # noqa: E402
from plutracer_tpu.scene import compile_scene as jax_compile  # noqa: E402
from plutracer_tpu.scene import load_scene_file as jax_load  # noqa: E402
from plutracer_tpu_torch import rng  # noqa: E402
from plutracer_tpu_torch.parallel import make_mesh, render_sharded  # noqa: E402
from plutracer_tpu_torch.scene import compile_scene, load_scene_file  # noqa: E402

W, H, N = 32, 24, 2
MESHES = ((1, 1), (2, 2), (4, 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    demo = str(REPO / "scenes" / "demo-box.urn")
    js = jax_compile(jax_load(demo, ["/res", f"{W}x{H}"]))
    ts = compile_scene(load_scene_file(demo, ["/res", f"{W}x{H}"]), device="cpu")
    cpu = torch.device("cpu")
    for shape in MESHES:
        rows = -(-W * H // shape[0])
        for seed in args.seeds:
            j = np.asarray(jax_render_sharded(js, W, H, N, jax.random.PRNGKey(seed),
                                              jax_mesh(shape)))
            p = render_sharded(ts, W, H, N, rng.PRNGKey(seed), make_mesh(shape, [cpu] * 8))
            p = p.numpy()
            diff = np.abs(np.log1p(np.maximum(p, 0.0)) - np.log1p(np.maximum(j, 0.0)))
            px = diff.max(-1)
            flips = np.argwhere(px > 0.05)
            print(f"mesh {shape} seed {seed}: p99 {np.quantile(diff, 0.99):.4g} "
                  f"mean {diff.mean():.4g} pixels over 0.05: {len(flips)}")
            for y, x in flips:
                print(f"    (y {y}, x {x}) tile {(y * W + x) // rows}: port {p[y, x]} "
                      f"jax {j[y, x]} |dlog1p| {px[y, x]:.3f}")


if __name__ == "__main__":
    main()
