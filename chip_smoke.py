"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from plutracer_tpu_torch/csrc and drives
both main paths of the port on the card:

1-2. environment and build (every .cu source by its own nvcc, together);
3-4. K1 (closest hit) and K2 (path megakernel) against their plain
     versions at the small-scene path's shapes (demo-box at 512x512:
     262,144 rays a pass);
5.   the small-scene path: demo-box through the CLI at its own 512x512
     and 64 samples per pixel, through K1 and K2;
6.   the demo-box, dof and textured0 goldens on the card;
7.   the K3 query (BVH closest hit) against K1 and K1 against its plain
     version: mesh1 camera and extension rays at 256x256, and a cloud of
     4,096 random spheres with 262,144 random rays;
8.   K3 (stream kernel) against the plain ray_color fed the same uniforms:
     mesh1 and mesh2 at 256x256, sphere-grid at its own 640x480;
9.   K4 (one-bounce kernel under the wavefront loop) against K3 for each
     reorder (none, compact, morton, morton5), and against its plain
     version, on the mesh1 pass; K4's launches timed alone and the whole
     loop;
10.  the big-scene path: mesh1 and mesh2 through the CLI at their own
     256x256 and 16 samples per pixel, through K3; then one mesh1 render
     with stream_wavefront, through K4;
11.  the sphere-grid, mesh0, mesh1, mesh2 and mesh-tex goldens through K3
     (each at its golden's size: 64x48, mesh2 24x18).

Every phase asserts and prints its seconds; any failure exits non-zero.
Without a CUDA device it exits 1 and prints no result.

The second-to-last line is one JSON object with each kernel's launches in
its main path's run (counts set to 0 just before, read just after), its
largest difference from the plain version, and both times (CUDA events,
mean over repeated launches; K4's per launch). The K3 query runs inside
K3 and K4 on the main path; its own launch is used only here, so its
entry reports 0 launches. The last line is {"ok": true, "device": ...}.
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
K3_SOURCE = "plutracer_tpu_torch/csrc/megakernel_stream.cu"
KQ_SOURCE = "plutracer_tpu_torch/csrc/bvh_closest.cuh"
K4_SOURCE = "plutracer_tpu_torch/csrc/megakernel_onebounce.cu"
K1_REPLACES = "plutracer_tpu/ops/pallas/intersect_kernel.py:36"
K2_REPLACES = "plutracer_tpu/ops/pallas/integrator_kernel.py:1019"
K3_REPLACES = "plutracer_tpu/ops/pallas/integrator_kernel.py:1883"
KQ_REPLACES = "plutracer_tpu/ops/pallas/integrator_kernel.py:1451"
K4_REPLACES = "plutracer_tpu/ops/pallas/integrator_kernel.py:1920"
PLAIN_CHUNK = 4096  # rays per closest_hit_plain call: it builds a (B, P) matrix


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


def structural_check(img, golden, what):
    """tests/test_torch_stream.py's structural_close: at most 3% of pixels
    whose largest channel |log1p(a) - log1p(b)| exceeds 0.05, mean at most
    0.01 (the triangle self-hit knife edge flips whole paths)."""
    assert img.shape == golden.shape and np.isfinite(img).all(), what
    diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(golden, 0.0)))
    frac, mean = float((diff.max(-1) > 0.05).mean()), float(diff.mean())
    print(f"golden repo-{what}: pixels over 0.05 {frac:.5f} (bound 0.03), mean {mean:.3e} "
          f"(bound 0.01), p99 {float(np.quantile(diff, 0.99)):.3e}")
    assert frac <= 0.03 and mean <= 0.01, what


class PhaseClock:
    """Prints each phase's wall seconds as the next begins."""

    def __init__(self):
        self.name, self.t0, self.start = None, 0.0, time.perf_counter()

    def __call__(self, name=None):
        now = time.perf_counter()
        if self.name is not None:
            print(f"phase {self.name}: {now - self.t0:.2f} s (total {now - self.start:.2f} s)")
        self.name, self.t0 = name, now


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
    phase = PhaseClock()

    # ---- 1. environment ----
    phase("1 environment")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")

    # ---- 2. build ----
    phase("2 build")
    t0 = time.perf_counter()
    lib = build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s wall ({lib.build_seconds:.2f} s nvcc) "
          f"-> {lib.path.name}")
    kernel = "?"
    for line in lib.compiler_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next(k for k in ("closest_hit_bvh_kernel", "closest_hit_kernel",
                                      "megakernel_stream", "megakernel_onebounce", "megakernel")
                          if k in line)
        if "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.strip()}")

    # the main path's shapes: demo-box at its own 512x512, pass 0's rays
    scene = compile_scene(load_scene_file(str(ROOT / "scenes" / "demo-box.urn")), device=dev)
    W, H = 512, 512
    B = W * H
    key = rng.fold_in(rng.PRNGKey(7), 0)
    k_px, k_lens, k_path = rng.split(key, 3)
    px = pixel_centers(W, H, dev) + rng.uniform(k_px, (B, 2), dev) * 0.999 / 8
    o, d = generate_rays(scene.camera, px, rng.uniform(k_lens, (B, 2), dev) * 0.999 / 8)

    # ---- 3. K1 against its plain version: camera rays + extension rays ----
    phase("3 K1")
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
    phase("4 K2")
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

    # ---- 5. the small-scene path: the CLI at the scene's 512x512, 64 spp ----
    phase("5 small-scene path")
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
    phase("6 goldens K1/K2")
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

    big = big_scene_phases(phase, dev, card)
    phase()

    kernels = [
        {"name": "K1 closest_hit", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 path megakernel", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        *big,
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def bit_equal_query(scene, o, d, what):
    """The K3 query against K1 on every ray (found and prim equal, t
    bit-equal on every hit; on a miss the query reports BIG where K1 may
    report a padding row about 1e30 away), and K1 against
    closest_hit_plain in chunks of PLAIN_CHUNK rays."""
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
        closest_hit, closest_hit_bvh, closest_hit_plain,
    )

    q = closest_hit_bvh(scene, o, d)
    k1 = closest_hit(scene.prims_packed, o, d)
    torch.cuda.synchronize()
    hits = k1[0]
    for name, a, b in (("found", q[0], k1[0]), ("prim", q[1], k1[1]),
                       ("t on hits", q[2][hits], k1[2][hits])):
        assert torch.equal(a, b), f"K3 query vs K1 ({what}): {name} differs on " \
                                  f"{(a != b).sum().item()} rays"
    for i in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(i, i + PLAIN_CHUNK)
        for name, a, b in zip(("found", "prim", "t"), (x[sl] for x in k1),
                              closest_hit_plain(scene.prims_packed, o[sl], d[sl])):
            assert torch.equal(a, b), f"K1 vs plain ({what}): {name} differs"
    print(f"K3 query {what}: winners equal to K1, t bit-equal on hits, K1 equal to plain; "
          f"hit fraction {hits.double().mean().item():.4f}")
    return (q[2][hits] - k1[2][hits]).abs().max().item() if hits.any() else 0.0


def query_times(scene, o, d, what, card):
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
        closest_hit, closest_hit_bvh, closest_hit_plain,
    )

    def plain_all():
        for i in range(0, o.shape[0], PLAIN_CHUNK):
            closest_hit_plain(scene.prims_packed, o[i:i + PLAIN_CHUNK], d[i:i + PLAIN_CHUNK])

    ms = time_ms(lambda: closest_hit_bvh(scene, o, d), reps=20)
    k1_ms = time_ms(lambda: closest_hit(scene.prims_packed, o, d), reps=5)
    plain_ms = time_ms(plain_all, reps=1, warmup=1)
    print(f"K3 query time {what}, B={o.shape[0]}, P={scene.num_prims}: kernel {ms:.4f} ms, "
          f"K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms ({plain_ms * PLAIN_CHUNK / o.shape[0]:.4f}"
          f" ms per {PLAIN_CHUNK}-ray chunk) ({card})")
    return ms, plain_ms


def step_times(scene, o, d, u, opts, step, passes):
    """Milliseconds of each call of `step` (CUDA events around it) in
    `passes` wavefront passes after one unrecorded pass, by bounce and
    then pass: the kernel (or plain step) alone, not the loop."""
    from plutracer_tpu_torch.render.wavefront import ray_color_wavefront

    events = []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        events.append((start, end))
        return out

    ray_color_wavefront(scene, o, d, u, opts, step=step)
    for _ in range(passes):
        ray_color_wavefront(scene, o, d, u, opts, step=timed)
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def big_scene_phases(phase, dev, card):
    """Phases 7-11: the stream tier (K3, its BVH query, K4). Returns the
    kernels' entries of the JSON line."""
    from plutracer_tpu.semantics import DEFAULT_OPTIONS
    from plutracer_tpu_torch import cli, rng
    from plutracer_tpu_torch.ops.camera import generate_rays
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
        closest_hit, closest_hit_bvh_cuda, closest_hit_cuda,
    )
    from plutracer_tpu_torch.ops.cuda.stream_kernel import (
        onebounce_cuda, onebounce_plain, ray_color_stream_cuda,
    )
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.render.integrator import draw_uniforms, kernel_tier, ray_color
    from plutracer_tpu_torch.render.renderer import pixel_centers, render
    from plutracer_tpu_torch.render.wavefront import SORTS, ray_color_wavefront
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.scene.loader import sphere_cloud

    def scene_rays(name, W, H, seed):
        scene = compile_scene(load_scene_file(str(ROOT / "scenes" / f"{name}.urn"),
                                              ["/res", f"{W}x{H}"]), device=dev)
        key = rng.fold_in(rng.PRNGKey(seed), 0)
        k_px, k_lens, k_path = rng.split(key, 3)
        px = pixel_centers(W, H, dev) + rng.uniform(k_px, (W * H, 2), dev) * 0.999 / 4
        o, d = generate_rays(scene.camera, px, rng.uniform(k_lens, (W * H, 2), dev) * 0.999 / 4)
        return scene, o, d, k_path

    # ---- 7. the K3 query against K1 and the plain brute force ----
    phase("7 K3 query")
    mesh1, o, d, k_path = scene_rays("mesh1", 256, 256, 7)
    f0, _, t0 = closest_hit(mesh1.prims_packed, o, d)
    hit_p = o + d * torch.where(f0, t0, 1.0)[:, None]
    ext_d = uniform_sphere_sample(rng.uniform(rng.fold_in(k_path, 99), (o.shape[0], 2), dev))
    q_err = bit_equal_query(mesh1, o, d, "mesh1 256x256 camera rays")
    q_err = max(q_err, bit_equal_query(mesh1, hit_p, ext_d, "mesh1 256x256 extension rays"))
    q_ms, q_plain_ms = query_times(mesh1, hit_p, ext_d, "mesh1 extension rays", card)
    cloud = compile_scene(sphere_cloud(4096, seed=0), device=dev)
    g = np.random.default_rng(1)
    co = torch.from_numpy(g.uniform(-12.0, 12.0, (262144, 3)).astype(np.float32)).to(dev)
    cd = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(262144, 3)).astype(np.float32)).to(dev), dim=-1)
    q_err = max(q_err, bit_equal_query(cloud, co, cd, "sphere cloud (4096 spheres, 262144 rays)"))
    query_times(cloud, co, cd, "sphere cloud", card)

    # ---- 8. K3 against the plain ray_color, same uniforms ----
    phase("8 K3")
    mb = DEFAULT_OPTIONS.max_bounces
    u = draw_uniforms(k_path, o.shape[0], mb, dev)
    k3_out = ray_color_stream_cuda(mesh1, o, d, u, DEFAULT_OPTIONS)
    k3_err = knife_edge_check(k3_out, ray_color(mesh1, o, d, u, DEFAULT_OPTIONS),
                              "K3 vs plain ray_color, mesh1 256x256 pass")
    k3_ms = time_ms(lambda: ray_color_stream_cuda(mesh1, o, d, u, DEFAULT_OPTIONS), reps=10)
    k3_plain_ms = time_ms(lambda: ray_color(mesh1, o, d, u, DEFAULT_OPTIONS), reps=2, warmup=1)
    print(f"K3 time mesh1 B={o.shape[0]}, 8 bounces: kernel {k3_ms:.4f} ms, plain ray_color "
          f"{k3_plain_ms:.4f} ms ({card})")
    # mesh2, the largest scene: K3's biggest tables (P = 102,403), the
    # plain version's queries through K1
    mesh2, m2o, m2d, m2_path = scene_rays("mesh2", 256, 256, 7)
    m2u = draw_uniforms(m2_path, m2o.shape[0], mb, dev)
    k3_err = max(k3_err, knife_edge_check(
        ray_color_stream_cuda(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS),
        ray_color(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS), "K3 vs plain ray_color, mesh2 256x256 pass"))
    print(f"K3 time mesh2 B={m2o.shape[0]}, P={mesh2.num_prims}: kernel "
          f"{time_ms(lambda: ray_color_stream_cuda(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS), reps=10):.4f}"
          f" ms, plain ray_color "
          f"{time_ms(lambda: ray_color(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS), reps=2, warmup=1):.4f}"
          f" ms ({card})")
    del mesh2, m2o, m2d, m2u
    grid, go, gd, g_path = scene_rays("sphere-grid", 640, 480, 7)
    gu = draw_uniforms(g_path, go.shape[0], mb, dev)
    k3_err = max(k3_err, knife_edge_check(
        ray_color_stream_cuda(grid, go, gd, gu, DEFAULT_OPTIONS),
        ray_color(grid, go, gd, gu, DEFAULT_OPTIONS), "K3 vs plain ray_color, sphere-grid 640x480"))
    print(f"K3 time sphere-grid B={go.shape[0]}: kernel "
          f"{time_ms(lambda: ray_color_stream_cuda(grid, go, gd, gu, DEFAULT_OPTIONS), reps=10):.4f}"
          f" ms, plain ray_color "
          f"{time_ms(lambda: ray_color(grid, go, gd, gu, DEFAULT_OPTIONS), reps=2, warmup=1):.4f}"
          f" ms ({card})")

    # ---- 9. K4 against K3 for each reorder (tests/test_megakernel.py:156-160) ----
    phase("9 K4")
    k4_err, k4_ms = 0.0, {}
    for sort in SORTS:
        opts = DEFAULT_OPTIONS.replace(stream_wavefront=True, stream_sort=sort)
        out = ray_color_wavefront(mesh1, o, d, u, opts)
        torch.cuda.synchronize()
        a = torch.log1p(out.clamp(min=0.0)).double()
        b = torch.log1p(k3_out.clamp(min=0.0)).double()
        frac = ((a - b).abs() > 1e-3).double().mean().item()
        dmean = abs(a.mean().item() - b.mean().item())
        k4_ms[sort] = time_ms(lambda: ray_color_wavefront(mesh1, o, d, u, opts), reps=5)
        print(f"K4 {sort} vs K3, mesh1 pass: lanes over 1e-3 {frac:.6f} (bound 0.005), log1p "
              f"mean diff {dmean:.3e} (bound 0.01), lanes bit-equal "
              f"{(out == k3_out).all(-1).double().mean().item():.6f}; {k4_ms[sort]:.4f} ms ({card})")
        assert torch.isfinite(out).all() and frac <= 0.005 and dmean <= 0.01, sort
        k4_err = max(k4_err, (out - k3_out).abs().max().item())
    opts = DEFAULT_OPTIONS.replace(stream_wavefront=True)
    k4_plain = ray_color_wavefront(mesh1, o, d, u, opts, step=onebounce_plain)
    knife_edge_check(ray_color_wavefront(mesh1, o, d, u, opts), k4_plain,
                     "K4 wavefront vs plain_bounce wavefront (morton), mesh1 pass")
    loop_plain_ms = time_ms(lambda: ray_color_wavefront(mesh1, o, d, u, opts,
                                                        step=onebounce_plain), reps=2, warmup=1)
    # each step alone (CUDA events around every launch), morton
    k4_step = step_times(mesh1, o, d, u, opts, onebounce_cuda, passes=5)
    plain_step = step_times(mesh1, o, d, u, opts, onebounce_plain, passes=2)
    k4_launch_ms = sum(k4_step) / len(k4_step)
    k4_plain_ms = sum(plain_step) / len(plain_step)
    by_bounce = [sum(k4_step[i::mb]) / (len(k4_step) // mb) for i in range(mb)]
    print(f"K4 launches alone (morton, mesh1 pass): {k4_launch_ms:.4f} ms per launch, "
          f"{k4_launch_ms * mb:.4f} ms per pass of {mb}, by bounce "
          f"{[round(x, 4) for x in by_bounce]}; plain_bounce {k4_plain_ms:.4f} ms per step, "
          f"{k4_plain_ms * mb:.4f} ms per pass ({card})")
    print(f"K4 wavefront loop (morton: K1 primary hit, {mb - 1} reorders, {mb} K4 launches) "
          f"{k4_ms['morton']:.4f} ms, plain_bounce loop {loop_plain_ms:.4f} ms; K3 "
          f"{k3_ms:.4f} ms for the same pass ({card})")

    # ---- 10. the big-scene path: mesh1 and mesh2 through the CLI, 256x256, 16 spp ----
    phase("10 big-scene path")
    launches = {}
    query_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("mesh1", "mesh2"):
            ray_color_stream_cuda.launches = closest_hit_bvh_cuda.launches = 0
            res = cli.run([str(ROOT / "scenes" / f"{name}.urn"), "/o", str(pathlib.Path(tmp) / "o.bmp"),
                           "/seed", "7"])
            launches[name] = ray_color_stream_cuda.launches
            query_launches += closest_hit_bvh_cuda.launches
            assert res.integrator == "kernel" and res.tier == "k3", (res.integrator, res.tier)
            assert tuple(res.linear.shape) == (256, 256, 3) and torch.isfinite(res.linear).all()
            assert launches[name] >= 16, launches
            print(f"main path: {name} 256x256 16 spp through the CLI, K3 launches "
                  f"{launches[name]}, render {res.render_seconds:.3f} s, mean radiance "
                  f"{res.linear.mean().item():.4f}; samples/s "
                  f"{256 * 256 * 16 / res.render_seconds:.1f} ({card})")
    # one pass of the mesh1 render by stage (CUDA events)
    k_px, k_lens = rng.split(rng.fold_in(rng.PRNGKey(7), 0), 3)[:2]
    B = o.shape[0]
    stages = {
        "threefry uniforms (8, B, 12)": lambda: draw_uniforms(k_path, B, mb, dev),
        "pixel + lens jitter (2 x (B, 2))": lambda: (rng.uniform(k_px, (B, 2), dev),
                                                     rng.uniform(k_lens, (B, 2), dev)),
        "camera rays": lambda: generate_rays(mesh1.camera, o[:, :2], o[:, :2]),
        "K3 (primary hit in the kernel)": lambda: ray_color_stream_cuda(mesh1, o, d, u,
                                                                        DEFAULT_OPTIONS),
    }
    for what, fn in stages.items():
        print(f"mesh1 pass stage {what}: {time_ms(fn, reps=10):.4f} ms, B={B} ({card})")
    wf = DEFAULT_OPTIONS.replace(stream_wavefront=True)
    assert kernel_tier(mesh1, wf) == "k4"
    onebounce_cuda.launches = closest_hit_cuda.launches = 0
    img = render(mesh1, 256, 256, 2, rng.PRNGKey(7), wf)
    torch.cuda.synchronize()
    k4_launches, k4_k1 = onebounce_cuda.launches, closest_hit_cuda.launches
    assert torch.isfinite(img).all() and k4_launches == 4 * mb and k4_k1 == 4, (k4_launches, k4_k1)
    print(f"main path: mesh1 256x256 4 spp render(..., stream_wavefront=True): K4 launches "
          f"{k4_launches}, K1 (primary hit) launches {k4_k1}")

    # ---- 11. goldens through K3, each at its golden's size (tests/test_golden.py) ----
    phase("11 goldens K3")
    for name in ("sphere-grid", "mesh0", "mesh1", "mesh2", "mesh-tex"):
        golden = np.load(ROOT / "tests" / "goldens" / f"repo-{name}.npz")["linear"].astype(np.float32)
        h, w = golden.shape[:2]
        gscene = compile_scene(
            load_scene_file(str(ROOT / "scenes" / f"{name}.urn"), ["/res", f"{w}x{h}"]), device=dev)
        assert kernel_tier(gscene, DEFAULT_OPTIONS) == "k3"
        before = ray_color_stream_cuda.launches
        img = render(gscene, w, h, 2, rng.PRNGKey(42)).cpu().numpy()
        assert ray_color_stream_cuda.launches == before + 4, name
        if name == "sphere-grid":
            diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(golden, 0.0)))
            p99, mean = float(np.quantile(diff, 0.99)), float(diff.mean())
            print(f"golden repo-{name}: p99 {p99:.3e} (bound 0.05), mean {mean:.3e} (bound 0.01)")
            assert img.shape == golden.shape and p99 < 0.05 and mean < 0.01, name
        else:
            structural_check(img, golden, name)

    k3_launches = launches["mesh1"] + launches["mesh2"]
    return [
        {"name": "K3 stream kernel", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": k3_launches, "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
        # the query runs inside every K3 launch (and K4's); standalone only here
        {"name": "K3 query bvh_closest (inside K3 and K4; own launch off the main path)",
         "route": "cuda", "source": KQ_SOURCE, "replaces": KQ_REPLACES,
         "launches": query_launches,
         "max_abs_err": q_err, "ms": q_ms, "plain_ms": q_plain_ms},
        {"name": "K4 one-bounce kernel (ms per launch)", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_launch_ms, "plain_ms": k4_plain_ms},
    ]


if __name__ == "__main__":
    sys.exit(main())
