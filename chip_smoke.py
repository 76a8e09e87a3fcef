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
     (each at its golden's size: 64x48, mesh2 24x18);
12.  K5, the telemetry of K2 and K3: the debug launches on a demo-box
     512x512 pass and a mesh1 256x256 pass against the plain
     ray_color(debug=True), radiance with debug on against off, times with
     and without, ptxas registers of both instantiations;
13.  gradients: the kernel path's autograd Function against plain autograd
     (demo-box 256x256 through K2, mesh1 128x128 through K3), finite, one
     central finite difference per field; forward and backward times;
14.  training: optimize_scene on demo-box 256x256, n = 2 (the flagship's
     phase-1 shape), from perturbed albedo: 8 steps of the log loss and 8
     of the ab loss, a 4 + 4 run resumed from its checkpoint against a
     straight 8, steps/s and samples/s, and one step of each loss split
     into the real make_train_step's halves (loss_and_grads, its forward
     traces, apply), the cost of deterministic algorithms, and what
     optimize_scene adds.

Every phase asserts and prints its seconds; any failure exits non-zero.
Without a CUDA device it exits 1 and prints no result.

The third-to-last line is one JSON object with each kernel's launches in
its main path's run (counts set to 0 just before, read just after), its
largest difference from the plain version, both times (CUDA events,
mean over repeated launches; K4's per launch), and its bound: the least
time the card could take for the work at these inputs, the larger of the
bytes it must move over HBM's 3.35 TB/s and the float32 operations its
code does on these inputs over 67 TFLOP/s (NVIDIA's H100 SXM peaks; see
``work_bound``). The path kernels' bounds count only the vertices the
pass runs (K5's cur channel) and each vertex's cheapest branch
(``SHADE_OPS``), so they are lower bounds. No single PyTorch call computes any of these functions,
so library_ms is null. The K3 query runs inside K3 and K4 on the main
path; its own launch is used only here, so its entry reports 0 launches.
The next line is the card's name and power limit; the last line is
{"ok": true, "device": ...}.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import statistics
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
K5_REPLACES = "plutracer_tpu/ops/pallas/integrator_kernel.py:1229"
PLAIN_CHUNK = 4096  # rays per closest_hit_plain call: it builds a (B, P) matrix

# NVIDIA H100 SXM peaks (data sheet): HBM3 bytes/s, float32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of one packed-row test (path_common.cuh packed_row_t,
# hand-counted: subtractions, products, sums, min/max, compares, the fold)
ROW_OPS = (50, 26, 60)  # sphere, box, triangle
# one BVH node test (the padded slab: 6 sub, 6 mul, 10 min/max, 3 compares)
NODE_OPS = 25
# path_vertex outside its three queries, on its cheapest branch, counted
# from path_common.cuh (an add, product, division, compare, select, min/max,
# fabs or transcendental counts 1; a negation 0): the hit detail of a
# sphere 47 (a box 51), the frame 19, a point light's sample 16, a mirror's
# two BSDF samples 96, and 109 for the emission test, the light pick, the
# MIS weights and NEE gates, the radiance and the throughput updates.
# Dearer branches (a triangle hit, a diffuse or glass BSDF, an area light's
# two pdfs) do more, so the vertex bound is a lower bound.
SHADE_OPS = 47 + 19 + 16 + 96 + 109
# K5's extra work per vertex: Ld's 3 sums and the channel sum's 2, the T
# max's 2, three selects and two int-to-float conversions (the 12 stores
# are bytes)
K5_OPS = 12
# phases 13 and 14: the gradient checks' scenes and sizes, the training size
GRAD_CASES = (("demo-box", 256), ("mesh1", 128))
TRAIN_RES = 256
SPLIT_ROUNDS = 5  # rounds of the train-step split (phase 14)


def work_bound(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def query_ops(scene) -> float:
    """Operations of one brute-force closest-hit query over the packed
    table (K1's and K2's queries test every row)."""
    return sum(r * ops for r, ops in zip(scene.packed_type_rows, ROW_OPS)) + 3


def walk_ops(scene) -> float:
    """A lower bound on one BVH walk's operations: a root-to-leaf path of
    node tests and one leaf's row test (the walk visits at least that)."""
    depth = max(1, int(np.ceil(np.log2(max(scene.num_prims, 2)))))
    return depth * NODE_OPS + max(ROW_OPS) + 3


def table_bytes(scene, bvh=False) -> float:
    """The scene tables a path kernel reads once (packed, prim, mat, tex,
    light rows; the BVH for the stream kernels; the atlas)."""
    n = (scene.prims_packed.numel() + scene.num_prims * 32 + scene.mat_type.shape[0] * 12
         + scene.tex_type.shape[0] * 12 + scene.num_lights * 8 + scene.atlas.numel())
    if bvh:
        n += scene.bvh.num_nodes * 9  # node min/max, skip, leaf row, line flag
    return 4.0 * n


def path_work(scene, B, live, q_ops, bvh=False):
    """(bytes, operations) of one path-kernel pass over B rays in which
    `live` vertices run (a path that ended or escaped does no more work;
    K5's cur channel counts the rest): the rays read and the radiance
    written once, the uniforms of the running vertices, the tables once
    (K2 also reads the primary hit K1 hands it); the primary query of every
    ray, and per running vertex its shading and three queries."""
    nbytes = B * (24 + 12) + live * 12 * 4 + table_bytes(scene, bvh) + (0 if bvh else B * 8)
    return nbytes, B * q_ops + live * (SHADE_OPS + 3 * q_ops)


def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


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


def ptxas_report(log: str):
    """{kernel: ptxas lines} from nvcc's -Xptxas -v output; a templated
    path kernel is named with its K5 instantiation, <debug> or <plain>."""
    import re

    out, kernel = {}, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next(k for k in ("closest_hit_bvh_kernel", "closest_hit_kernel",
                                    "megakernel_stream", "megakernel_onebounce", "megakernel")
                        if k in line)
            m = re.search(name + r"ILb([01])E", line)
            kernel = name + ("" if m is None else ("<debug>" if m.group(1) == "1" else "<plain>"))
        if "registers" in line or "spill" in line:
            out.setdefault(kernel, []).append(line.strip())
    return out


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

    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
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
    for kernel, lines in ptxas_report(lib.compiler_log).items():
        for line in lines:
            print(f"  ptxas {kernel}: {line}")

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

    k1_bound = work_bound(B * (24 + 8) + scene.prims_packed.numel() * 4.0, B * query_ops(scene))
    print(f"bound: K1 {k1_bound[0]:.6f} ms ({k1_bound[1]}) at B={B}")

    big, mesh1_pass = big_scene_phases(phase, dev, card)
    # K2's bound counts the vertices the pass runs: phase 12 reads them
    k5, k2_bound = telemetry_phase(phase, card, lib, (scene, o, d, u, k2_ms), mesh1_pass)
    gradient_phase(phase, dev, card)
    training_phase(phase, dev, card)
    phase()

    kernels = [
        entry("K1 closest_hit", K1_SOURCE, K1_REPLACES, launches["K1"], k1_err, k1_ms,
              k1_plain_ms, k1_bound),
        entry("K2 path megakernel", K2_SOURCE, K2_REPLACES, launches["K2"], k2_err, k2_ms,
              k2_plain_ms, k2_bound),
        *big,
        k5,
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
    kernels' entries of the JSON line and the mesh1 pass (scene, o, d, u,
    K3 ms)."""
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
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

    # bounds at the timed shapes. K3's and K4's work depends on the data:
    # only the vertices a path reaches run (K5's cur channel counts them on
    # the timed pass), and each query is at least a root-to-leaf walk
    _, tele = ray_color_stream_cuda(mesh1, o, d, u, DEFAULT_OPTIONS, debug=True)
    live = tele[:, 8].sum(1).double().cpu()  # running vertices per bounce
    vert_ops = SHADE_OPS + 3 * walk_ops(mesh1)
    B = o.shape[0]
    k3_bound = work_bound(*path_work(mesh1, B, live.sum().item(), walk_ops(mesh1), bvh=True))
    q_bound = work_bound(B * 32 + table_bytes(mesh1, True), B * walk_ops(mesh1))
    k4_bound = work_bound(B * (16 * 4 * 2 + 48) + table_bytes(mesh1, True),
                          live.mean().item() * vert_ops)
    print(f"bounds (mesh1 256x256 pass, {int(live.sum().item())} running vertices of "
          f"{B * mb}): K3 {k3_bound[0]:.6f} ms ({k3_bound[1]}), query {q_bound[0]:.6f} ms "
          f"({q_bound[1]}), K4 {k4_bound[0]:.6f} ms a launch ({k4_bound[1]})")

    k3_launches = launches["mesh1"] + launches["mesh2"]
    return [
        entry("K3 stream kernel", K3_SOURCE, K3_REPLACES, k3_launches, k3_err, k3_ms,
              k3_plain_ms, k3_bound),
        # the query runs inside every K3 launch (and K4's); standalone only here
        entry("K3 query bvh_closest (inside K3 and K4; own launch off the main path)",
              KQ_SOURCE, KQ_REPLACES, query_launches, q_err, q_ms, q_plain_ms, q_bound),
        entry("K4 one-bounce kernel (ms per launch)", K4_SOURCE, K4_REPLACES, k4_launches,
              k4_err, k4_launch_ms, k4_plain_ms, k4_bound),
    ], (mesh1, o, d, u, k3_ms)


def channel_report(dbg, ref, what, stream=False):
    """K5 against the plain ray_color(debug=True): per channel the largest
    difference and the fraction of lanes equal at every vertex. Asserts
    every channel equal on every lane and vertex (K2 and K3 run the plain
    version's IEEE operations, so their state is bit-equal). K3's xt is
    compared where either query hit (on a miss the walk reports BIG where
    K1 may report a padding row near 1e30)."""
    from plutracer_tpu_torch.ops.cuda import DBG_CHANNELS

    assert dbg.shape == ref.shape, (tuple(dbg.shape), tuple(ref.shape))
    worst = 0.0
    for c, name in enumerate(DBG_CHANNELS):
        a, b = dbg[:, c], ref[:, c]
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        if stream and name == "xt":
            same |= (a >= 1e5) & (b >= 1e5)
        lanes = same.all(0).double().mean().item()
        diff = torch.where(same, 0.0, (a - b).abs()).max().item()
        worst = max(worst, diff if np.isfinite(diff) else float("inf"))
        print(f"K5 {what} channel {c:2d} {name:12s}: lanes equal {lanes:.6f}, "
              f"largest difference {diff:.6e}")
        bad = int((~same).any(0).sum().item())
        assert bad == 0, f"K5 {what}: channel {name} differs on {bad} lanes"
    return worst


def telemetry_phase(phase, card, lib, demo_pass, mesh1_pass):
    """Phase 12: K5 in K2 (demo-box 512x512 pass) and in K3 (mesh1
    256x256 pass). Returns K5's entry of the JSON line and K2's bound on
    the demo-box pass (the vertices it runs are read from K5's cur
    channel)."""
    from plutracer_tpu_torch.ops.cuda import DBG_C, DBG_CHANNELS
    from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_cuda, ray_color_kernel
    from plutracer_tpu_torch.ops.cuda.stream_kernel import ray_color_stream_cuda
    from plutracer_tpu_torch.render.integrator import ray_color
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS as OPTS

    phase("12 K5 telemetry")
    scene, o, d, u, k2_ms = demo_pass
    mesh1, mo, md, mu, k3_ms = mesh1_pass
    mb, B = OPTS.max_bounces, o.shape[0]
    # the path: one debug pass of each tier, counts set to 0 just before
    ray_color_cuda.debug_launches = ray_color_stream_cuda.debug_launches = 0
    L2, dbg2 = ray_color_kernel(scene, o, d, u, OPTS, debug=True)
    L3, dbg3 = ray_color_kernel(mesh1, mo, md, mu, OPTS.replace(stream_wavefront=True),
                                debug=True)
    torch.cuda.synchronize()
    k5_launches = {"K2": ray_color_cuda.debug_launches, "K3": ray_color_stream_cuda.debug_launches}
    print(f"K5 path: a demo-box 512x512 debug pass (K2) and a mesh1 256x256 debug pass (K3, "
          f"under stream_wavefront too), launches {k5_launches}")
    assert k5_launches == {"K2": 1, "K3": 1}, k5_launches
    assert dbg2.shape == (mb, DBG_C, B) and dbg3.shape == (mb, DBG_C, mo.shape[0])
    for what, L, plain_L in (("K2 demo-box", L2, ray_color_kernel(scene, o, d, u, OPTS)),
                             ("K3 mesh1", L3, ray_color_stream_cuda(mesh1, mo, md, mu, OPTS))):
        eq = torch.equal(L, plain_L)
        print(f"K5 {what}: radiance with debug on bit-equal to debug off: {eq}")
        assert eq, what
    ref_L2, ref2 = ray_color(scene, o, d, u, OPTS, debug=True)
    ref_L3, ref3 = ray_color(mesh1, mo, md, mu, OPTS, debug=True)
    knife_edge_check(L2, ref_L2, "K5 (K2) radiance vs plain ray_color(debug=True)")
    knife_edge_check(L3, ref_L3, "K5 (K3) radiance vs plain ray_color(debug=True)")
    err = max(channel_report(dbg2, ref2, "K2 demo-box 512x512"),
              channel_report(dbg3, ref3, "K3 mesh1 256x256", stream=True))
    k5_k2_ms = time_ms(lambda: ray_color_cuda(scene, o, d, u, OPTS, debug=True), reps=20)
    k2_again = time_ms(lambda: ray_color_cuda(scene, o, d, u, OPTS), reps=20)
    k5_k3_ms = time_ms(lambda: ray_color_stream_cuda(mesh1, mo, md, mu, OPTS, debug=True), reps=10)
    k3_again = time_ms(lambda: ray_color_stream_cuda(mesh1, mo, md, mu, OPTS), reps=10)
    plain_ms = time_ms(lambda: ray_color(scene, o, d, u, OPTS, debug=True), reps=3, warmup=1)
    print(f"K5 time: K2 demo-box B={B} debug {k5_k2_ms:.4f} ms vs plain instantiation "
          f"{k2_again:.4f} ms (phase 4: {k2_ms:.4f}); K3 mesh1 B={mo.shape[0]} debug "
          f"{k5_k3_ms:.4f} ms vs {k3_again:.4f} ms (phase 8: {k3_ms:.4f}); plain "
          f"ray_color(debug=True) demo-box {plain_ms:.4f} ms ({card})")
    for kernel, lines in ptxas_report(lib.compiler_log).items():
        if kernel.startswith(("megakernel<", "megakernel_stream<")):
            print(f"K5 ptxas {kernel}: {' | '.join(lines)}")
    live = dbg2[:, DBG_CHANNELS.index("cur")].sum().item()  # vertices the pass runs
    k2_bytes, k2_ops = path_work(scene, B, live, query_ops(scene))
    k2_bound = work_bound(k2_bytes, k2_ops)
    # K5 writes every vertex's channels, those of ended paths too
    bound = work_bound(k2_bytes + B * mb * DBG_C * 4, k2_ops + B * mb * K5_OPS)
    print(f"bounds (demo-box 512x512 pass, {int(live)} running vertices of {B * mb}): K2 "
          f"{k2_bound[0]:.6f} ms ({k2_bound[1]}), K5 (K2 debug) {bound[0]:.6f} ms ({bound[1]})")
    return entry("K5 telemetry (K2/K3 debug instantiation; ms: K2 demo-box pass)", K2_SOURCE,
                 K5_REPLACES, k5_launches["K2"] + k5_launches["K3"], err, k5_k2_ms, plain_ms,
                 bound), k2_bound


def make_loss(scene, w, h, backend, dtype=torch.float32):
    """tests/test_grad.py's make_loss: one render_pass (stratum 1, n = 2),
    pixels clipped at 20, the mean of squares (summed in `dtype`)."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.parallel.sharded import apply_params
    from plutracer_tpu_torch.render.renderer import render_pass
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    opts = DEFAULT_OPTIONS.replace(integrator_backend=backend)

    def loss(params):
        img = render_pass(apply_params(scene, params), rng.PRNGKey(0), 1, w, h, 2, opts)
        img = torch.clamp(img, max=20.0).to(dtype)
        return torch.sum(img * img) / img.numel()

    return loss


def loss_grads(loss, params):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    return dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))


def gradient_phase(phase, dev, card):
    """Phase 13: gradients through the kernel path's autograd Function
    (render/integrator.KernelRadiance) against plain autograd."""
    from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_cuda
    from plutracer_tpu_torch.ops.cuda.stream_kernel import ray_color_stream_cuda
    from plutracer_tpu_torch.parallel.sharded import get_params
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    phase("13 gradients")
    for (name, res), counter in zip(GRAD_CASES, (ray_color_cuda, ray_color_stream_cuda)):
        scene = compile_scene(load_scene_file(str(ROOT / "scenes" / f"{name}.urn"),
                                              ["/res", f"{res}x{res}"]), device=dev)
        params = get_params(scene)
        kernel_loss, plain_loss = (make_loss(scene, res, res, b) for b in ("kernel", "plain"))
        before = counter.launches
        got = loss_grads(kernel_loss, params)
        assert counter.launches == before + 1, "the Function's forward did not run the kernel"
        want = loss_grads(plain_loss, params)
        for f in got:
            g, w = got[f], want[f]
            assert torch.isfinite(g).all() and torch.isfinite(w).all(), f"{name} {f}"
            scale = w.abs().max().item()
            diff = (g - w).abs().max().item()
            print(f"gradient {name} {res}x{res} {f}: Function vs plain autograd largest "
                  f"difference {diff:.3e} of {scale:.3e}, bit-equal {torch.equal(g, w)}")
            assert diff <= 1e-5 * scale + 1e-12, f"{name} {f}"
        # one central difference per field at its largest entry (float64 sum)
        fd_loss = make_loss(scene, res, res, "kernel", torch.float64)
        g64 = loss_grads(fd_loss, params)
        for f, g in g64.items():
            if not g.abs().max() > 0:
                continue
            idx = np.unravel_index(int(g.abs().argmax()), g.shape)
            eps = 1e-2 * max(0.1, abs(float(params[f][idx])))
            plus, minus = dict(params), dict(params)
            delta = torch.zeros_like(params[f])
            delta[idx] = eps
            plus[f], minus[f] = params[f] + delta, params[f] - delta
            with torch.no_grad():
                fd = (fd_loss(plus).item() - fd_loss(minus).item()) / (2 * eps)
            ad = g[idx].item()
            print(f"gradient {name} {f}{tuple(int(i) for i in idx)}: autograd {ad:.6e}, "
                  f"central difference {fd:.6e}")
            assert abs(ad - fd) <= 2e-2 * abs(fd) + 1e-6, f"{name} {f}"
        with torch.no_grad():
            fwd_ms = time_ms(lambda: kernel_loss(params), reps=3, warmup=1)
        fb_ms = time_ms(lambda: loss_grads(kernel_loss, params), reps=3, warmup=1)
        plain_fb_ms = time_ms(lambda: loss_grads(plain_loss, params), reps=3, warmup=1)
        print(f"gradient time {name} {res}x{res} (B={res * res}): kernel forward {fwd_ms:.4f} ms, "
              f"Function forward + plain backward {fb_ms:.4f} ms, plain forward + backward "
              f"{plain_fb_ms:.4f} ms ({card})")


def training_phase(phase, dev, card):
    """Phase 14: optimize_scene on demo-box 256x256, n = 2."""
    import dataclasses

    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.diff.optim import Adam
    from plutracer_tpu_torch.diff.optimize import InverseRenderConfig, optimize_scene
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_cuda
    from plutracer_tpu_torch.parallel import sharded
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    phase("14 training")
    W = H = TRAIN_RES
    scene = compile_scene(load_scene_file(str(ROOT / "scenes" / "demo-box.urn"),
                                          ["/res", f"{W}x{H}"]), device=dev)
    target = render(scene, W, H, 4, rng.PRNGKey(11))  # 16 spp, through K1 + K2
    true = sharded.get_params(scene)
    init = dict(true)
    init["mat_color"] = true["mat_color"] * 0.5  # perturbed albedo
    log_cfg = InverseRenderConfig(width=W, height=H, n=2, steps=8, log_every=4,
                                  learning_rate=3e-2, loss_space="log",
                                  trainable=("mat_color",))
    ab_cfg = dataclasses.replace(log_cfg, loss_space="ab", learning_rate=1e-2,
                                 loss_downsample=8)
    runs = {}
    for what, cfg, start in (("log", log_cfg, init), ("ab", ab_cfg, None)):
        start = start if start is not None else runs["log"][0]
        stats = {}
        closest_hit_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = optimize_scene(scene, target, cfg, init_params=start, stats_out=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        passes = 2 if cfg.loss_space == "ab" else 1
        samples = W * H * passes * cfg.steps
        mae = (params["mat_color"] - true["mat_color"]).abs().mean().item()
        print(f"training {what}: {cfg.steps} steps in {wall:.3f} s, {cfg.steps / wall:.4f} steps/s, "
              f"{samples / wall:.1f} samples/s ({W}x{H} x {passes} pass(es) a step), K1 launches "
              f"{closest_hit_cuda.launches}, losses {[round(x, 6) for x in losses]}, albedo MAE "
              f"{(start['mat_color'] - true['mat_color']).abs().mean().item():.5f} -> {mae:.5f}, "
              f"nonfinite {stats} ({card})")
        assert all(np.isfinite(losses)) and len(losses) == cfg.steps
        assert stats["nonfinite_grad_frac_max"] == 0.0, stats
        assert closest_hit_cuda.launches > 0
        runs[what] = (params, losses, wall)
    # a run stopped after 4 steps and resumed from its checkpoint (warm:
    # its wall against the first log run's shows that run's warm-up)
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(pathlib.Path(tmp) / "train.ckpt.npz")
        t0 = time.perf_counter()
        optimize_scene(scene, target, dataclasses.replace(log_cfg, steps=4, checkpoint_path=ck),
                       init_params=init)
        params, losses = optimize_scene(scene, target,
                                        dataclasses.replace(log_cfg, checkpoint_path=ck),
                                        init_params=init)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3 / log_cfg.steps
    ref_params, ref_losses, _ = runs["log"]
    same = losses == ref_losses and all(torch.equal(params[k], ref_params[k]) for k in params)
    print(f"training resume: 4 + 4 steps from the checkpoint bit-equal to 8 straight: {same}; "
          f"{warm_ms:.4f} ms a step with checkpoints, against the first log run's "
          f"{runs['log'][2] * 1e3 / log_cfg.steps:.4f} ({card})")
    assert same
    # one step of each loss by part: the real make_train_step, built as
    # optimize_scene builds it, at step 0's key; CUDA events, the parts
    # interleaved over SPLIT_ROUNDS rounds (the eager step's times spread
    # from call to call), medians
    tflat = target.reshape(-1, 3)
    key = rng.fold_in(rng.PRNGKey(log_cfg.seed), 0)
    for what, cfg in (("log", log_cfg), ("ab", ab_cfg)):
        step = sharded.make_train_step(
            scene, W, H, cfg.n, optimizer=Adam(cfg.learning_rate), loss_space=cfg.loss_space,
            trainable=cfg.trainable, project_nonnegative=cfg.project_nonnegative,
            loss_downsample=cfg.loss_downsample, loss_clamp=cfg.loss_clamp)
        state = step.init(init)
        halves = lambda: step.loss_and_grads(init, tflat, key, 0)
        _, grads, nf = halves()
        apply_ms = time_ms(lambda: step.apply(init, state, grads, nf), reps=20)
        parts = {"step": [], "loss_and_grads": [], "forward traces": [], "nondeterministic": []}
        for _ in range(SPLIT_ROUNDS):
            parts["step"].append(time_ms(lambda: step(init, state, tflat, key, 0), 1, 0))
            lg, fwd = loss_and_grads_ms(sharded, halves)
            parts["loss_and_grads"].append(lg)
            parts["forward traces"].append(fwd)
            # the same half without torch's deterministic algorithms
            deterministic = sharded._deterministic
            sharded._deterministic = contextlib.nullcontext
            try:
                parts["nondeterministic"].append(time_ms(halves, 1, 0))
            finally:
                sharded._deterministic = deterministic
        med = {k: statistics.median(v) for k, v in parts.items()}
        spread = ", ".join(f"{k} {min(v):.1f}-{max(v):.1f}" for k, v in parts.items())
        print(f"training step split ({what} loss, {W}x{H}, medians of {SPLIT_ROUNDS}): step "
              f"{med['step']:.4f} ms = loss_and_grads {med['loss_and_grads']:.4f} (forward traces "
              f"{med['forward traces']:.4f}, backward and gradient filter "
              f"{med['loss_and_grads'] - med['forward traces']:.4f}) + apply (Adam) "
              f"{apply_ms:.4f} + remainder {med['step'] - med['loss_and_grads'] - apply_ms:.4f}; "
              f"loss_and_grads without deterministic algorithms {med['nondeterministic']:.4f} "
              f"(their cost {med['loss_and_grads'] - med['nondeterministic']:.4f}); optimize_scene "
              f"{runs[what][2] * 1e3 / cfg.steps:.4f} ms a step; ranges ms: {spread} ({card})")


def loss_and_grads_ms(sharded, fn):
    """(ms, forward-trace ms) of one call of fn, a train step's
    loss_and_grads: CUDA events around the call and around each call of
    the step's _trace_stratum inside it."""
    events = []
    trace = sharded._trace_stratum

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = trace(*args)
        end.record()
        events.append((start, end))
        return out

    sharded._trace_stratum = timed
    try:
        total = time_ms(fn, 1, 0)
    finally:
        sharded._trace_stratum = trace
    return total, sum(s.elapsed_time(e) for s, e in events)


if __name__ == "__main__":
    sys.exit(main())
