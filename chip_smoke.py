"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from plutracer_tpu_torch/csrc, holds each
against its plain PyTorch version at the main path's shapes (demo-box at
512x512: 262,144 rays a pass), renders demo-box through the CLI at the
scene's own 512x512 and 64 samples per pixel, checks that the render went
through both kernels, and renders the demo-box, dof and textured0 goldens
on the card. Every phase asserts; any failure exits non-zero. Without a
CUDA device it exits 1 and prints no result.

The second-to-last line is one JSON object with each kernel's launches in
the main-path render, its largest difference from the plain version, and
both times (CUDA events, mean over repeated launches). The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

K1_SOURCE = "plutracer_tpu_torch/csrc/closest_hit.cu"
K2_SOURCE = "plutracer_tpu_torch/csrc/megakernel.cu"
K1_REPLACES = "plutracer_tpu/ops/pallas/intersect_kernel.py:36"
K2_REPLACES = "plutracer_tpu/ops/pallas/integrator_kernel.py:1019"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def knife_edge_check(out: torch.Tensor, ref: torch.Tensor, what: str):
    """tests/test_megakernel.py's bound: at most 2% of lanes with
    |log1p(a) - log1p(b)| > 1e-3, and log1p means within 0.02."""
    assert torch.isfinite(out).all(), f"{what}: non-finite radiance"
    a = torch.log1p(out.clamp(min=0.0)).double()
    b = torch.log1p(ref.clamp(min=0.0)).double()
    frac = ((a - b).abs() > 1e-3).double().mean().item()
    dmean = abs(a.mean().item() - b.mean().item())
    print(f"{what}: lanes over 1e-3 {frac:.6f} (bound 0.02), log1p mean diff {dmean:.3e} "
          f"(bound 0.02), lanes bit-equal {(out == ref).all(-1).double().mean().item():.6f}")
    assert frac <= 0.02 and dmean <= 0.02, what
    return (out - ref).abs().max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from plutracer_tpu.semantics import DEFAULT_OPTIONS
    from plutracer_tpu_torch import cli, rng
    from plutracer_tpu_torch.ops.camera import generate_rays
    from plutracer_tpu_torch.ops.cuda import build
    from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_cuda, ray_color_kernel
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
        closest_hit, closest_hit_cuda, closest_hit_plain,
    )
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.render.integrator import draw_uniforms, ray_color
    from plutracer_tpu_torch.render.renderer import pixel_centers, render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    dev = torch.device("cuda")
    card = card_line()

    # ---- 1. environment ----
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s wall ({lib.build_seconds:.2f} s nvcc) "
          f"-> {lib.path.name}")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # the main path's shapes: demo-box at its own 512x512, pass 0's rays
    scene = compile_scene(load_scene_file(str(ROOT / "scenes" / "demo-box.urn")), device=dev)
    W, H = 512, 512
    B = W * H
    key = rng.fold_in(rng.PRNGKey(7), 0)
    k_px, k_lens, k_path = rng.split(key, 3)
    px = pixel_centers(W, H, dev) + rng.uniform(k_px, (B, 2), dev) * 0.999 / 8
    o, d = generate_rays(scene.camera, px, rng.uniform(k_lens, (B, 2), dev) * 0.999 / 8)

    # ---- 3. K1 against its plain version: camera rays + extension rays ----
    f0, p0, t0_ = closest_hit(scene.prims_packed, o, d)
    hit_p = o + d * torch.where(f0, t0_, 1.0)[:, None]
    ext_d = uniform_sphere_sample(rng.uniform(rng.fold_in(k_path, 99), (B, 2), dev))
    k1_err = 0.0
    for what, (ro, rd) in (("camera", (o, d)), ("extension", (hit_p, ext_d))):
        f, p, t = closest_hit(scene.prims_packed, ro, rd)
        pf, pp, pt = closest_hit_plain(scene.prims_packed, ro, rd)
        torch.cuda.synchronize()
        assert torch.equal(f, pf) and torch.equal(p, pp), f"K1 winners differ ({what})"
        assert torch.equal(t, pt), f"K1 t not bit-equal ({what})"
        k1_err = max(k1_err, (t - pt).abs().max().item())
        print(f"K1 {what} rays: winners equal, t bit-equal, hit fraction "
              f"{f.double().mean().item():.4f}")
    k1_ms = time_ms(lambda: closest_hit(scene.prims_packed, hit_p, ext_d), reps=50)
    k1_plain_ms = time_ms(lambda: closest_hit_plain(scene.prims_packed, hit_p, ext_d), reps=10)
    print(f"K1 time at B={B}, P_pad={scene.prims_packed.shape[0]}: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms ({card})")

    # ---- 4. K2 against the plain ray_color, same uniforms ----
    u = draw_uniforms(k_path, B, DEFAULT_OPTIONS.max_bounces, dev)
    out = ray_color_kernel(scene, o, d, u, DEFAULT_OPTIONS)
    ref = ray_color(scene, o, d, u, DEFAULT_OPTIONS)
    torch.cuda.synchronize()
    k2_err = knife_edge_check(out, ref, f"K2 vs plain ray_color, demo-box 512x512 pass")
    k2_ms = time_ms(lambda: ray_color_cuda(scene, o, d, u, DEFAULT_OPTIONS), reps=20)
    k2_plain_ms = time_ms(lambda: ray_color(scene, o, d, u, DEFAULT_OPTIONS), reps=3, warmup=1)
    k1_primary_ms = time_ms(lambda: closest_hit(scene.prims_packed, o, d), reps=50)
    print(f"K2 time at B={B}, 8 bounces: ray_color_cuda {k2_ms:.4f} ms (of which the K1 "
          f"primary hit {k1_primary_ms:.4f} ms), plain ray_color {k2_plain_ms:.4f} ms ({card})")

    # ---- 5. the main path: the CLI at the scene's 512x512, 64 spp ----
    with tempfile.TemporaryDirectory() as tmp:
        bmp = pathlib.Path(tmp) / "demo-box.bmp"
        closest_hit_cuda.launches = 0
        ray_color_cuda.launches = 0
        res = cli.run([str(ROOT / "scenes" / "demo-box.urn"), "/o", str(bmp), "/seed", "7"])
        launches = {"K1": closest_hit_cuda.launches, "K2": ray_color_cuda.launches}
        assert bmp.exists() and bmp.stat().st_size > 512 * 512 * 3, "BMP not written"
    assert res.integrator == "kernel", res.integrator
    assert tuple(res.linear.shape) == (512, 512, 3) and res.linear.device.type == "cuda"
    assert torch.isfinite(res.linear).all(), "non-finite radiance in the main-path render"
    assert launches["K1"] >= 64 and launches["K2"] >= 64, launches
    samples = 512 * 512 * 64
    # one pass of that render by stage (CUDA events), to see where the time goes
    stages = {
        "threefry uniforms (8, B, 12)": lambda: draw_uniforms(k_path, B, 8, dev),
        "pixel + lens jitter (2 x (B, 2))": lambda: (rng.uniform(k_px, (B, 2), dev),
                                                     rng.uniform(k_lens, (B, 2), dev)),
        "camera rays": lambda: generate_rays(scene.camera, px, px),
        "K1 primary hit + K2": lambda: ray_color_cuda(scene, o, d, u, DEFAULT_OPTIONS),
    }
    for what, fn in stages.items():
        print(f"pass stage {what}: {time_ms(fn, reps=10):.4f} ms ({card})")
    print(f"main path: demo-box 512x512 64 spp through the CLI, launches {launches}, "
          f"render {res.render_seconds:.3f} s, mean radiance {res.linear.mean().item():.4f}")
    print(f"samples/s: {samples / res.render_seconds:.1f} ({card})")

    # ---- 6. goldens on the card (tests/test_golden.py bounds) ----
    for name in ("demo-box", "dof", "textured0"):
        gscene = compile_scene(
            load_scene_file(str(ROOT / "scenes" / f"{name}.urn"), ["/res", "64x48"]), device=dev)
        img = render(gscene, 64, 48, 2, rng.PRNGKey(42)).cpu().numpy()
        golden = np.load(ROOT / "tests" / "goldens" / f"repo-{name}.npz")["linear"].astype(np.float32)
        assert img.shape == golden.shape and np.isfinite(img).all(), name
        diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(golden, 0.0)))
        p99, mean = float(np.quantile(diff, 0.99)), float(diff.mean())
        print(f"golden repo-{name}: p99 {p99:.3e} (bound 0.05), mean {mean:.3e} (bound 0.01)")
        assert p99 < 0.05 and mean < 0.01, name

    kernels = [
        {"name": "K1 closest_hit", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 path megakernel", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
