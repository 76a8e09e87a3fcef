"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from plutracer_tpu_torch/csrc and drives
both main paths of the port on the card:

1-2. environment and build (every .cu source by its own nvcc, together);
     ptxas registers, stack bytes and spills of every kernel and
     instantiation (none may spill);
3-4. K1 (closest hit) bit-equal to its plain version (found, prim, t) on
     demo-box's camera and extension rays at 512x512 (262,144 rays a
     pass), on mesh0's table of several shared-memory ring tiles, split
     across blocks for few rays, and on ragged batches; one launch a call; its
     kernel-only time (torch.profiler) and its wrapper's at every shape a
     path gives it (demo-box here, mesh1 and mesh2 in phase 7). K2 (path
     megakernel) bit-equal to ray_color_plain on every lane;
5.   the small-scene path: demo-box through the CLI at its own 512x512
     and 64 samples per pixel, through K1 and K2, bit-identical to the
     same render one stratum a launch; a CLI render with /profile DIR,
     whose trace in DIR holds K1, K2, R1 and R2 records;
6.   the demo-box, dof and textured0 goldens on the card;
7.   the K3 query (BVH closest hit) and K1 each against K1's plain
     version, and the query against K1: mesh1 camera and extension rays
     at 256x256, and a cloud of
     4,096 random spheres with 262,144 random rays; the mean node records
     and leaves a walk of the walk layout visits (its plain version) on
     mesh1 and mesh2;
8.   K3 (stream kernel) against ray_color_plain fed the same uniforms,
     bit-equal on every lane: mesh1 at the main path's 4 strata of 256x256
     a launch, mesh2 at 256x256, sphere-grid at its own 640x480;
9.   K4 (one-bounce kernel under the wavefront loop) bit-equal to K3 for
     each reorder (none, compact, morton, morton5) on the mesh1 and mesh2
     launches, every ray written once (radiance starts NaN, and the
     launches end B rays), no K1 launch; and to its plain version; the
     loop split by stage and bounce, K4's launches timed alone;
10.  the big-scene path: mesh1 and mesh2 through the CLI at their own
     256x256 and 16 samples per pixel, through K3 (4 strata a launch),
     each bit-identical to one stratum a launch; each scene's render and
     demo-box's at 512x512 and 64 samples per pixel timed batched and one
     stratum a launch, in turns; then one mesh1 render with
     stream_wavefront, through K4 alone (no K1 launch);
11.  the sphere-grid, mesh0, mesh1, mesh2 and mesh-tex goldens through K3
     (each at its golden's size: 64x48, mesh2 24x18);
12.  K5, the telemetry of K2 and K3: the debug launches on a demo-box
     512x512 pass and a mesh1 256x256 pass against the plain
     ray_color_plain(debug=True), radiance with debug on against off, times with
     and without, ptxas registers of both instantiations;
13.  gradients: the kernel path's autograd Function against plain autograd
     (demo-box 256x256 through K2, mesh1 128x128 through K3), finite, one
     central finite difference per field; forward and backward times;
14.  training: optimize_scene on demo-box 256x256, n = 2 (the flagship's
     phase-1 shape), from perturbed albedo: 8 steps of the log loss and 8
     of the ab loss, a 4 + 4 run resumed from its checkpoint against a
     straight 8, steps/s and samples/s, and one step of each loss (the
     captured step's replay, bit-equal to the eager halves from the same
     state) beside the real make_train_step's eager halves
     (loss_and_grads, its forward traces, apply), the cost of
     deterministic algorithms, and what optimize_scene adds; the
     benchmark's train cell's step (the Cornell box at 512x512) captured
     and replayed over two steps, bit-equal to its eager halves, its
     replay timed beside them;
15.  the flagship recipe (plutracer_tpu_torch/tools/inverse_flagship.py
     through its main(argv)) on demo-box at the tool's full 256x256: a
     256-spp target (K1 + K2), 20 phase-1 log steps and 10 phase-2 pooled
     ab steps (n = 4, 8x8 pooling, firefly clamp), every query of a train
     step through K1; a run interrupted in phase 2 after a phase-2
     checkpoint and rerun with the same flags, its parameters and loss
     history bit-equal to the straight run's; target seconds, steps/s a
     phase, albedo and emission errors, non-finite gradient fraction (0);
16.  recovery: supervise_render of demo-box 512x512, n = 8 (K1 + K2 in the
     worker) crashed after pass 20 with checkpoints every 16 passes, and of
     mesh1 256x256, n = 4 (K3) crashed after pass 6 with checkpoints every
     4, each image bit-equal to the in-process render at the same seed; a
     CLI /checkpoint render interrupted after its first checkpoint and
     resumed, bit-equal in linear radiance; supervised wall time against
     in-process;
17.  multi-device (parallel/): (a) render_sharded of demo-box 512x512, 64
     samples per pixel, on a 1x1 mesh in an NCCL world of 1 (K1 + K2, the
     launches counted), bit-equal to the same mesh with no process group;
     its wall time and samples/s beside render's; (b) the same render on a
     (2, 2) mesh of cuda:0 positions, in this process and in two gloo
     processes sharing the card (a tiles row each), bit-equal; (c) the
     (2, 2) mesh at 128x128, n = 2, through the kernels against the plain
     backend, bit-equal; (d) mesh1 256x256, 16 samples per pixel, on a
     (1, 2) mesh (K3), one process against two, bit-equal; (e) one train
     step each of the log and ab losses on demo-box 256x256, n = 2, on the
     (2, 2) mesh: parameters, Adam's state and loss bit-equal between one
     process and two; (f) dryrun_multichip(4) on four cuda:0 positions
     (its own process, beside (c)-(e) and the two-process jobs);
18.  tools: term_dump on demo-box 64x64, n = 2, on the card (its terms
     summed against its radiance, its linear image against render's at
     the same key), render_image against postprocess_image(render);
19.  routing: (a) ray_color_plain under intersect_backend "pallas"
     (K1), "bvh" (the K3 query) and "xla" (intersect_lite in ray chunks)
     on a mesh1 256x256 and a demo-box 512x512 stratum with the same
     uniforms: every query's winners equal, radiance bit-equal, each query
     site and the whole timed; (b) a mesh1 128x128 train step (log loss,
     n = 2) under "pallas" and "bvh": loss, gradients, parameters and
     Adam's leaves bit-equal, forward / backward / step ms, K1 and K3-query
     launches; (c) the scenes past the JAX package's TPU caps: textured256
     (a 65,536-texel atlas) and tables (20 materials, 10 textures, 12
     lights) through the CLI at their own settings (the kernel it routes
     to, samples/s), each kernel bit-equal to ray_color_plain on a
     stratum beside the plain stratum's time, K5 on textured256; demo-box
     with its tables filled to K2's 48 KB of shared memory (K2) and one
     material past it (K3); a cloud of 1,100,000 spheres with an area
     light: compile seconds and one K3 launch bit-equal to plain; on both
     K3-tier scenes K4 (stream_wavefront) bit-equal to the plain
     ray_color_plain and K5 (K3's debug launch) to ray_color_plain(debug=True);
20.  the scene-level API: (a) ops/intersect.query_closest under "pallas"
     (K1), "bvh" (the K3 query) and "xla" on one stratum's camera rays
     and one bounce's extension rays of demo-box 512x512 (262,144 rays),
     and under the two kernels on mesh2 256x256 (65,536): found, prim, t,
     p, norm, uv and dpdu bit-equal on hits, the gradient of sum(hit.p)
     with respect to prim_a bit-equal between the kernels, each engine's
     call timed; (b) ops/bvh.bvh_closest (the reference tree's lockstep
     skip-link traversal, plain torch) on mesh1's 65,536 camera rays
     against K1 and the K3 query (winners, t on hits), its steps and
     time; (c) render/integrator.estimate_direct at demo-box's and
     tables' 512x512 primary hits, one light drawn a ray, under the three
     engines with shading_normal_le_gate on and off: bit-equal, timed;
     (d) render.ray_color(scene, o, d, key), the JAX package's call, on a
     demo-box 512x512 stratum (K1 + K2) and a mesh1 256x256 stratum (K3):
     one kernel launch, bit-equal to ray_color_plain on
     draw_uniforms(key)'s uniforms; (e) render.elastic.pass_stack on a
     (1, 1) mesh of the card: its rows bit-equal to render_passes and,
     summed in stratum order, to render_elastic's image.
21.  R1, the threefry draw kernel (uniform_block_words: the key words
     on the card, sent by rng.device_words): bit-equal to its plain
     version (rng.uniform_block_plain, int64 tensor ops on the card) at a
     demo-box 512x512 stratum's path uniforms (8, 262,144, 12), a 4-strata
     mesh1 launch's (8, 4 x 65,536, 12), both launches' jitter blocks,
     ragged B (1, 127, 1,000,003) and blocks past 2^24 words, one launch
     a call; kernel-only (torch.profiler) and wrapper times beside the
     plain version's and the bound; demo-box 512x512 and mesh1 256x256
     renders, a demo-box 256x256 train step (loss and gradients; and
     captured, three replays) and a 1x1-mesh render_sharded through R1
     bit-equal to the same with plain-drawn uniforms (the draws before
     R1), R1 launches counted.
22.  launch devices: (a) over demo-box and mesh1 renders at 64x64, n = 2
     (K1 + K2, K3, and K4 under stream_wavefront; R1 and R2), a K3 query, K2's and
     K3's K5 launches and an R1 block, the launch helper
     (ops/cuda/build.on_device) entered exactly once a launch (its entries
     equal the sum of every wrapper's counters, K1's plan inside its
     launch's entry), each launch with its tensors' card current; the
     helper's own cost; (b) with two cards or more, launched while cuda:0
     is current: render_elastic of demo-box over [cuda:0, cuda:1], a
     (2, 1) mesh over both cards in one process, and K1's split path on
     mesh0 with cuda:1's tensors, each bit-equal to the same on cuda:0
     (with one card it prints that (b) was not run, and why).
23.  R2, the camera-stage kernel (the pixel and lens jitter drawn inside
     from each stratum's cell and key words, read from rows on the card,
     then the rays): bit-equal to its plain twin
     (renderer.camera_rays_table_plain: the jitter by
     rng.uniform_block_plain, then eager torch ops, on the card) on every
     lane of a demo-box 512x512 stratum, a dof 640x480 stratum (the thin
     lens), a 4-strata and a 16-strata mesh1 256x256 launch (cells out of
     order), the Cornell train cell's 512x512 stratum and ragged B (1,
     127, B - 77); kernel-only (torch.profiler) and wrapper times beside
     the plain twin's and the bound; the renders of demo-box, dof and
     mesh1, a demo-box train step (log and ab: eager, and captured for one
     step and a many of three), render_sharded on a 1x1 mesh and
     render_elastic through R2 bit-equal to the same with the plain camera
     rays (the captured step's twin captured as R2 is), each with one R2
     launch a pass-loop launch (as many as its R1 launches) and no eager
     camera op.
24.  G1, the table-row gather's backward (csrc/row_grad.cu): bit-equal to
     its plain twin (row_grad_kernel.row_grad_plain, int32 views) at
     every width (1, 8, 12, 32) over 1 to 20,000 rows and 0 to 262,144
     rays, the same bits over three calls, one launch a call; at the
     Cornell train step's material and light tables (512x512 rays) and
     prim fields of 2^16, 2^18 and 2^20 rows (sorted rays), bit-equal to
     the twin again and timed: kernel-only (torch.profiler) and wrapper,
     beside the twin's, torch's deterministic index_put_'s (library_ms)
     and the bound; a Cornell box 512x512 log step (n = 2,
     albedo and emission: the benchmark's train mix) launches G1 24 times,
     gives the same loss and gradients twice from one state, and G1's
     device time in it (torch.profiler) beside all its kernels'.

Every phase asserts and prints its seconds; any failure exits non-zero.
Without a CUDA device it exits 1 and prints no result.

The third-to-last line is one JSON object with each kernel's launches in
its main path's run (counts set to 0 just before, read just after), its
largest difference from the plain version, both times (CUDA events,
mean over repeated launches; K4's per launch), and its bound: the least
time the card could take for the work at these inputs, the larger of the
bytes it must move over HBM's 3.35 TB/s and the float32 operations its
code does on these inputs over 67 TFLOP/s (NVIDIA's H100 SXM peaks; see
``work_bound``). The path kernels' bounds count the work this run's data
needs: ray_color_plain replays the timed launch and yields the
vertices that run and the queries each issues (``issued_queries``), the
walks' node records and rows are counted by the walk's plain version
(``walk_work``), and each vertex outside its queries is counted at its
cheapest branch (``SHADE_OPS``). No single PyTorch call computes any of these functions,
so library_ms is null. The K3 query runs inside K3 and K4; its own
launch answers the plain path's queries under intersect_backend="bvh",
and its entry reports those launches in one mesh1 train step's
loss_and_grads (phase 19 (b)) and in phase 20's API calls; K1's entry
adds phase 20's launches to the demo-box render's. R1's entry counts
its launches in the CLI renders of phases 5 and 10 (one a pass-loop
launch: the path uniforms), and its bound is the larger of the bytes it
writes over HBM's rate and its 32-bit integer operations (R1_WORD_OPS a
word) over 128 a clock on each SM at the card's maximum SM clock;
torch's generators are Philox, not threefry, so no library call computes
its function. R2's entry counts its launches in the same CLI renders
(one a pass-loop launch); its bound is the largest of the bytes it moves
(R2_RAY_BYTES a ray, the pixel positions and the camera table once), its
jitter's integer operations (R1_WORD_OPS a word, two words a ray and two
more with a lens) at R1's rate, and its float32 operations (R2_RAY_OPS);
no single PyTorch call computes camera rays. G1's entry counts its
launches in phase 24's log step; its bound is the bytes it must move (a
ray's index and W floats read, the table's gradient written) over HBM's
rate; its library_ms is torch's
index_put_(accumulate=True) under deterministic algorithms at the same
shape, which the port no longer calls.
The next line is the card's name and power limit; the last line is
{"ok": true, "device": ...}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
K1_KERNELS = ("closest_hit_ring",)  # K1's launches (its two instantiations)
R1_SOURCE = "plutracer_tpu_torch/csrc/threefry.cu"
R1_REPLACES = "plutracer_tpu/render/integrator.py:283"
R1_KERNELS = ("threefry_uniform",)
# 32-bit integer operations of one R1 word (csrc/threefry.cu: 20 rounds
# of add, funnel shift and xor; 5 key injections of two adds, each step's
# key word plus its count hoisted out of the word; the counter's add; the
# final xor, shift, or and subtract), and the most 32-bit operations an
# H100 SM issues a clock: its 128 lanes, the 64 INT32 units and the
# integer multiply-add forms of the FP32 pipe (the compiler moves adds
# there: at 64 a clock R1 ran faster than the bound, PERF.md)
R1_WORD_OPS = 20 * 3 + 5 * 2 + 1 + 4
INT32_OPS_A_CLOCK = 128
# phase 21: the ragged batches, the blocks past 2^24 words (keys, words)
R1_RAGGED = (1, 127, 1_000_003)
R1_BIG = ((1, 2**24 + 3), (3, 2**24 + 1))
G1_SOURCE = "plutracer_tpu_torch/csrc/row_grad.cu"
G1_REPLACES = "none: XLA's scatter-add, the VJP of plutracer_tpu/ops/tables.py's gathers"
G1_KERNELS = ("row_grad_sorted", "row_grad")  # the first that a name holds names it
# (B, R, W): every width of the gather's tables, one and many chunks and sorted tiles
G1_CASES = [(B, R, W) for R in (1, 5, 31, 20000) for W in (1, 8, 12, 32)
            for B in (0, 1, 2047, 2049, 262144)]
G1_TIMED = (("mat", 12), ("light", 8))  # the Cornell train step's tables, B = 512^2
G1_FIELDS = ((2**16, 32), (2**18, 32), (2**20, 32))  # trainable prim fields: sorted rays
R2_SOURCE = "plutracer_tpu_torch/csrc/camera.cu"
R2_REPLACES = "plutracer_tpu/render/renderer.py:36"
R2_KERNELS = ("camera_rays",)
# the kernel records of a demo-box CLI render's trace, by name (words, and
# words that rule a name out): K1, K2, R1, R2
PROFILE_KERNELS = {"K1": (K1_KERNELS, ()), "K2": (("megakernel",), ("stream", "onebounce")),
                   "R1": (R1_KERNELS, ()), "R2": (R2_KERNELS, ())}
# the threefry words R2 draws a ray: the pixel jitter's two, and the lens
# jitter's two more where the camera has a lens (a pinhole never reads them)
R2_RAY_WORDS = (2, 4)  # pinhole, lens
# float32 operations of one R2 ray (csrc/camera.cu, hand-counted; a
# compare, select, division, sqrt, cos or sin counts 1): a pinhole ray's
# sample positions 14, film point 7, direction 15, norm and division 9 and
# the lens test 1; a lens ray adds the disk map's 20 (its products and
# sums, compares, selects, a division, the angle, cos, sin, the radius
# products) and the refocus's 24 (the focal division, the focal point,
# the lens origin, the difference, its norm and division)
R2_RAY_OPS = (46, 46 + 20 + 24)  # pinhole, lens
# bytes of one R2 ray: o and d, 24 written (the jitter is drawn in
# registers); each pixel position (8 bytes) and the camera table (68
# bytes) are read once a launch
R2_RAY_BYTES = 24
# phase 23: the launches held against the plain twin, (scene, resolution,
# strata, n): the main paths' (demo-box and dof one stratum a launch, mesh1
# 4), the most strata a launch takes, and the train cell's launch (one
# stratum of the Cornell box at 512x512, n = 2)
R2_CASES = (("demo-box", (512, 512), 1, 8), ("dof", (640, 480), 1, 8),
            ("mesh1", (256, 256), 4, 4), ("mesh1", (256, 256), 16, 4),
            ("cornell-box", (512, 512), 1, 2))
R2_RENDERS = (("demo-box", 512, 512, 2), ("dof", 640, 480, 2), ("mesh1", 256, 256, 4))
RAGGED = 77  # rays short of a whole block tile in phase 3's ragged batches
PLAIN_CHUNK = 4096  # rays per closest_hit_plain call: it builds a (B, P) matrix
WALK_RAYS = 16384  # rays of each set whose walks phase 7 counts (plain lockstep walks)
WORK_CHUNK = 262144  # rays per walk_closest_plain call when the bounds count walks
TURN_ROUNDS = 3  # rounds of phase 10's renders in turns (batched, one, one, batched)

# NVIDIA H100 SXM peaks (data sheet): HBM3 bytes/s, float32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of one packed-row test (path_common.cuh packed_row_t,
# hand-counted: subtractions, products, sums, min/max, compares, the fold)
ROW_OPS = (50, 26, 60)  # sphere, box, triangle
# one box test of the walk (the padded slab: 6 sub, 6 mul, 10 min/max, 3
# compares); a node record tests both children's boxes
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
# phase 15: the flagship's flags (the tool's width, its default phase-2
# grid and pooling, depth cut to 20 + 10 steps) and where phase 2 is cut
FLAGSHIP_ARGS = ("--res", "256", "--target-n", "16", "--steps", "20", "--phase2-steps", "10",
                 "--phase2-n", "4", "--phase2-downsample", "8", "--phase2-clamp", "10")
# phase 16: (scene, resolution, n, fault, checkpoint_every) of the supervised renders
SUPERVISED = (("demo-box", 512, 8, "crash:20", 16), ("mesh1", 256, 4, "crash:6", 4))
CLI_RES = 256  # phase 16's CLI /checkpoint render (demo-box, 16 spp)
# phase 17: the sharded renders' (resolution, n) and the train steps' size
MESH_RENDER = (512, 8)  # demo-box, (a) and (b)
MESH_CHECK = (128, 2)  # (c), kernel path against plain
MESH_K3 = (256, 4)  # mesh1 on (1, 2), (d)
MESH_TRAIN = (256, 2)  # demo-box, (e)
TERMS_RES = 64  # phase 18: term_dump and render_image, demo-box, n = 2
# (f): dryrun_multichip(4) in its own process, on the card's positions
DRYRUN = [sys.executable, "-m", "plutracer_tpu_torch.parallel.dryrun", "4"]
# phase 19: (a) one stratum of each scene at its resolution through the
# ray_color_plain under each intersect_backend; (b) the mesh1 train step's
# size (log loss, n = 2); (c) the scenes past the JAX package's TPU caps
# (CLI renders at their own settings) and the sphere cloud past 2^20
ROUTE_QUERY = (("mesh1", 256), ("demo-box", 512))
INTERSECT_BACKENDS = ("pallas", "bvh", "xla")
ROUTE_TRAIN = 128
BEYOND_CAPS = ("textured256", "tables")
FILLED_RES = 256  # demo-box with its tables filled to and past K2's shared memory
CLOUD_P, CLOUD_RES = 1_100_000, 64
# phase 20: (a) query_closest on one stratum's camera rays and one bounce's
# extension rays of each scene at its main path's shape ("xla" on
# demo-box only: a mesh stratum under "xla" takes seconds); (b)
# bvh_closest's rays on mesh1; (c) estimate_direct's scenes (512x512
# primary hits)
API_QUERY = (("demo-box", 512, INTERSECT_BACKENDS), ("mesh2", 256, ("pallas", "bvh")))
API_BVH_RES = 256  # mesh1, 65,536 camera rays
API_DIRECT = ("demo-box", "tables")
API_DIRECT_RES = 512
API_RAY_COLOR = (("demo-box", 512, "K2"), ("mesh1", 256, "K3"))  # one stratum's rays
API_PASS_STACK = (256, 4)  # demo-box, res and n


def work_bound(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def query_ops(scene) -> float:
    """Operations of one brute-force closest-hit query over the packed
    table (K1's and K2's queries test every row)."""
    return sum(r * ops for r, ops in zip(scene.packed_type_rows, ROW_OPS)) + 3


def walk_bytes(scene) -> float:
    """The walk layout the stream kernels' walk reads: node records and
    walk rows."""
    return 4.0 * (scene.walk_nodes.numel() + scene.walk_rows.numel())


def table_bytes(scene, walk=False) -> float:
    """The scene tables a path kernel reads once: prim, mat, tex and light
    rows and the atlas, with the packed table (K2's brute force) or the
    walk layout (K3's and K4's walk)."""
    n = (scene.num_prims * 32 + scene.mat_type.shape[0] * 12 + scene.tex_type.shape[0] * 12
         + scene.num_lights * 8 + scene.atlas.numel())
    return 4.0 * n + (walk_bytes(scene) if walk else 4.0 * scene.prims_packed.numel())


def walk_work(scene, o, d, any_hit=False):
    """(operations, walks, node records and leaves visited) of the walks
    of rays o, d over the scene's walk layout, counted by its plain version
    (walk_closest_plain visits what the kernel's walk visits): each node
    record tests two boxes, each row tested its type's row test."""
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import walk_closest_plain

    row_ops = torch.tensor(ROW_OPS, dtype=torch.float64, device=o.device)
    ops, visits = 0.0, 0
    for i in range(0, o.shape[0], WORK_CHUNK):
        *_, nodes, leaves, rows = walk_closest_plain(
            scene.prims_packed, scene.walk_nodes, scene.walk_rows, o[i:i + WORK_CHUNK],
            d[i:i + WORK_CHUNK], any_hit=any_hit, count=True)
        ops += 2 * NODE_OPS * nodes.sum().item() + (rows.double() @ row_ops).sum().item()
        visits += (nodes + leaves).sum().item()
    return ops, o.shape[0], visits


def issued_queries(scene, o, d, u, options):
    """What the kernels' default instantiation runs on a launch (csrc
    path_common.cuh path_vertex), replayed by ray_color_plain on the
    same uniforms: the running vertices (cur) of each bounce, and the rays
    of the queries they issue. A shadow ray where cur and gate_l's
    query-free factors hold (an any-hit walk for a point light), a
    NEE-BSDF ray where cur and gate_b's hold, an extension ray where the
    path lives on. Returns (running vertices per bounce, closest-hit rays
    (o, d), any-hit rays (o, d))."""
    from plutracer_tpu_torch.ops import bsdf
    from plutracer_tpu_torch.render import integrator

    live, closest, any_hit, alive = [], [], [], {}
    plain_bounce, nee = integrator.plain_bounce, integrator._nee_contributions
    nonzero = lambda v: (v * v).sum(-1) > 0.0

    def bounce(scene, tables, state, ui, i, options, debug=False, terms=False):
        alive["in"] = state.alive
        nxt = plain_bounce(scene, tables, state, ui, i, options, debug, terms)
        closest.append((nxt.o[nxt.alive], nxt.d[nxt.alive]))  # the extension rays
        return nxt

    def contributions(hit, frame, mtype, albedo, wwo, options, ls, bs, lrows, *rest):
        out = nee(hit, frame, mtype, albedo, wwo, options, ls, bs, lrows, *rest)
        cur = alive["in"] & hit.found
        f = bsdf.bsdf_F_nee(mtype, albedo, hit.norm, wwo, ls.wi)
        gate_l = cur & (ls.pdf > 0.0) & nonzero(ls.Li) & nonzero(f)
        gate_b = (cur & ~ls.is_delta & nonzero(bs.f) & (bs.pdf > 0.0)
                  & (bs.is_specular | (out[2] != 0.0)) & nonzero(lrows.intensity))
        live.append(int(cur.sum().item()))
        closest.append((hit.p[gate_l & ~ls.is_delta], ls.wi[gate_l & ~ls.is_delta]))
        any_hit.append((hit.p[gate_l & ls.is_delta], ls.wi[gate_l & ls.is_delta]))
        closest.append((hit.p[gate_b], bs.wwi[gate_b]))
        return out

    integrator.plain_bounce, integrator._nee_contributions = bounce, contributions
    try:
        with torch.no_grad():
            integrator.ray_color_plain(scene, o, d, u, options)
    finally:
        integrator.plain_bounce, integrator._nee_contributions = plain_bounce, nee
    cat = lambda rays: tuple(torch.cat(x) for x in zip(*rays))
    return live, cat(closest), cat(any_hit)


def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def scene_file(name: str) -> pathlib.Path:
    """The .urn file of a scene of scenes/, or of the benchmark's Cornell box."""
    if name == "cornell-box":
        return ROOT / "benchmark" / "scenes" / "cornell-box.urn"
    return ROOT / "scenes" / f"{name}.urn"


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


def lanes_equal(out: torch.Tensor, ref: torch.Tensor, what: str):
    """Radiance bit-equal on every lane (the kernels run their plain
    versions' IEEE operations); prints tests/test_megakernel.py's looser
    statistics beside it. Returns the largest difference (0.0)."""
    assert torch.isfinite(out).all(), f"{what}: non-finite radiance"
    a = torch.log1p(out.clamp(min=0.0)).double()
    b = torch.log1p(ref.clamp(min=0.0)).double()
    frac = ((a - b).abs() > 1e-3).double().mean().item()
    equal = (out == ref).all(-1)
    print(f"{what}: lanes bit-equal {equal.double().mean().item():.6f} of {out.shape[0]} "
          f"(bound: all), lanes over 1e-3 in log1p {frac:.6f}, log1p mean diff "
          f"{abs(a.mean().item() - b.mean().item()):.3e}")
    assert bool(equal.all()), f"{what}: {int((~equal).sum())} lanes differ"
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


def ptxas_table(log: str):
    """{kernel: (registers, stack bytes, spill stores, spill loads)} from
    nvcc's -Xptxas -v output, named as ptxas_report names them."""
    import re

    out = {}
    for kernel, lines in ptxas_report(log).items():
        text = " ".join(lines)
        num = lambda pat: int(re.search(pat, text).group(1))
        out[kernel] = (num(r"Used (\d+) registers"), num(r"(\d+) bytes stack frame"),
                       num(r"(\d+) bytes spill stores"), num(r"(\d+) bytes spill loads"))
    return out


def ptxas_report(log: str):
    """{kernel: ptxas lines} from nvcc's -Xptxas -v output; a templated
    path kernel is named with its K5 instantiation, <debug> or <plain>."""
    import re

    out, kernel = {}, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in ("closest_hit_bvh_kernel", *K1_KERNELS, *R1_KERNELS,
                                     *R2_KERNELS, *G1_KERNELS,
                                     "megakernel_stream", "megakernel_onebounce", "megakernel")
                         if k in line), re.search(r"function '([^']+)'", line).group(1))
            m = re.search(name + r"ILb([01])E", line)
            tags = ("<split>", "<one>") if name in K1_KERNELS else ("<debug>", "<plain>")
            kernel = name + ("" if m is None else tags[0] if m.group(1) == "1" else tags[1])
            width = re.search(name + r"ILi(\d+)E", line)
            kernel += "" if width is None else f"<W={width.group(1)}>"
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


def stratum_by_stratum(scene, w, h, n, key, options):
    """renderer.render's image traced one stratum a launch: the strata
    in order, each through render_passes alone."""
    from plutracer_tpu_torch.render.renderer import _finalize, render_passes

    acc = None
    for s in range(n * n):
        acc = render_passes(scene, key, s, w, h, n, 1, options, acc)
    return _finalize(acc, n * n, w, h)


@contextlib.contextmanager
def counting():
    """Count the kernels' launches inside the block, from 0: utils/profiling's
    record cleared, then recording on (the wrappers count only while it
    records; its spans add torch.profiler.record_function's cost to what the
    block times)."""
    from plutracer_tpu_torch.utils import profiling

    profiling.reset()
    with profiling.recording():
        yield


def replays() -> int:
    """The captured train steps' replays counted so far inside counting()."""
    from plutracer_tpu_torch.utils import profiling

    return profiling.counter("train.graph_replays")


def launched(kernel: str) -> int:
    """The launches of `kernel` (k1, k1_bvh, k2, k2_debug, k3, k3_debug, k4,
    r1, r2) counted so far inside counting(): launches.<kernel>."""
    from plutracer_tpu_torch.utils import profiling

    return profiling.counter(f"launches.{kernel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
    from plutracer_tpu_torch import cli, rng
    from plutracer_tpu_torch.ops.camera import generate_rays
    from plutracer_tpu_torch.ops.cuda import build
    from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_cuda, ray_color_kernel
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit, closest_hit_plain
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.render.integrator import draw_uniforms, ray_color_plain
    from plutracer_tpu_torch.render.renderer import (
        camera_rays_table_plain, launch_inputs, launch_rays_table, launch_words, pixel_centers,
        render,
    )
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
    ptxas = ptxas_table(lib.compiler_log)
    for kernel, (regs, stack, st, ld) in ptxas.items():
        print(f"ptxas {kernel}: {regs} registers, {stack} bytes stack frame, spill stores "
              f"{st} bytes, spill loads {ld} bytes")
    spills = {k: v[2:] for k, v in ptxas.items() if v[2] or v[3]}  # asserted at the end

    # the main path's shapes: demo-box at its own 512x512, pass 0's rays
    scene = compile_scene(load_scene_file(str(ROOT / "scenes" / "demo-box.urn")), device=dev)
    W, H = 512, 512
    B = W * H
    key = rng.fold_in(rng.PRNGKey(7), 0)
    k_px, k_lens, k_path = rng.split(key, 3)
    px = pixel_centers(W, H, dev) + rng.uniform(k_px, (B, 2), dev) * 0.999 / 8
    o, d = generate_rays(scene.camera, px, rng.uniform(k_lens, (B, 2), dev) * 0.999 / 8)

    # ---- 3. K1 against its plain version, bit for bit ----
    phase("3 K1")
    rows = scene.packed_type_rows
    f0, p0, t0_ = closest_hit(scene.prims_packed, o, d, rows)
    hit_p = o + d * torch.where(f0, t0_, 1.0)[:, None]
    ext_d = uniform_sphere_sample(rng.uniform(rng.fold_in(k_path, 99), (B, 2), dev))
    mesh0 = compile_scene(load_scene_file(str(ROOT / "scenes" / "mesh0.urn"), ["/res", "256x256"]),
                          device=dev)
    m0o, m0d, _ = main_path_rays(mesh0, 256, 256, 4, rng.PRNGKey(7), 1, DEFAULT_OPTIONS)
    m0f, _, m0t = closest_hit(mesh0.prims_packed, m0o, m0d, mesh0.packed_type_rows)
    m0p = m0o + m0d * torch.where(m0f, m0t, 1.0)[:, None]
    k1_err = 0.0
    cases = (("demo-box camera", scene, o, d), ("demo-box extension", scene, hit_p, ext_d),
             (f"demo-box ragged B={B - RAGGED}", scene, o[RAGGED:], d[RAGGED:]),
             ("mesh0 camera (a table of 11 ring tiles)", mesh0, m0o, m0d),
             ("mesh0 extension", mesh0, m0p, ext_d[:65536]),
             (f"mesh0 ragged B={65536 - RAGGED}", mesh0, m0p[RAGGED:], ext_d[RAGGED:65536]),
             ("mesh0 a ray tile (the table split across blocks)", mesh0, m0p[:256],
              ext_d[:256]))
    with counting():
        for what, sc, ro, rd in cases:
            before = launched("k1")
            got = closest_hit(sc.prims_packed, ro, rd, sc.packed_type_rows)
            assert launched("k1") == before + 1, what  # one launch a call
            k1_err = max(k1_err, k1_equal_plain(sc, ro, rd, got, what))
    k1_times(mesh0, m0o, m0d, "mesh0 camera", card)
    del mesh0, m0o, m0d, m0p
    k1_ms, _ = k1_times(scene, o, d, "demo-box primary", card)
    k1_times(scene, hit_p, ext_d, "demo-box extension", card)
    k1_times(scene, hit_p.repeat(3, 1)[:3 * 65536], ext_d.repeat(3, 1)[:3 * 65536],
             "demo-box train query shape (3 x 65,536)", card)
    k1_plain_ms = time_ms(lambda: closest_hit_plain(scene.prims_packed, hit_p, ext_d), reps=10)
    print(f"K1 plain at B={B}, P_pad={scene.prims_packed.shape[0]}: {k1_plain_ms:.4f} ms ({card})")

    # ---- 4. K2 against ray_color_plain, same uniforms ----
    phase("4 K2")
    u = draw_uniforms(k_path, B, DEFAULT_OPTIONS.max_bounces, dev)
    out = ray_color_kernel(scene, o, d, u, DEFAULT_OPTIONS)
    ref = ray_color_plain(scene, o, d, u, DEFAULT_OPTIONS)
    torch.cuda.synchronize()
    k2_err = lanes_equal(out, ref, f"K2 vs ray_color_plain, demo-box 512x512 pass")
    k2_ms = time_ms(lambda: ray_color_cuda(scene, o, d, u, DEFAULT_OPTIONS), reps=20)
    k2_plain_ms = time_ms(lambda: ray_color_plain(scene, o, d, u, DEFAULT_OPTIONS), reps=3, warmup=1)
    k1_primary_ms = time_ms(lambda: closest_hit(scene.prims_packed, o, d, rows), reps=50)
    print(f"K2 time at B={B}, 8 bounces: ray_color_cuda {k2_ms:.4f} ms (of which the K1 "
          f"primary hit {k1_primary_ms:.4f} ms), ray_color_plain {k2_plain_ms:.4f} ms ({card})")

    # ---- 5. the small-scene path: the CLI at the scene's 512x512, 64 spp ----
    phase("5 small-scene path")
    with tempfile.TemporaryDirectory() as tmp:
        bmp = pathlib.Path(tmp) / "demo-box.bmp"
        with counting():
            res = cli.run([str(ROOT / "scenes" / "demo-box.urn"), "/o", str(bmp), "/seed", "7"])
            launches = {"K1": launched("k1"), "K2": launched("k2"),
                        "R1": launched("r1"), "R2": launched("r2")}
        assert bmp.exists() and bmp.stat().st_size > 512 * 512 * 3, "BMP not written"
    assert res.integrator == "kernel", res.integrator
    assert tuple(res.linear.shape) == (512, 512, 3) and res.linear.device.type == "cuda"
    assert torch.isfinite(res.linear).all(), "non-finite radiance in the main-path render"
    # 262,144 rays a stratum: one stratum a launch
    assert launches["K1"] == 64 and launches["K2"] == 64, launches
    # one R1 launch a pass-loop launch: the path uniforms
    assert launches["R1"] == launches["K2"], launches
    # one R2 launch a pass-loop launch: the launch's jitter and camera rays
    assert launches["R2"] == launches["K2"], launches
    same = torch.equal(res.linear, stratum_by_stratum(scene, W, H, 8, rng.PRNGKey(7),
                                                      DEFAULT_OPTIONS))
    print(f"main path: the CLI render bit-identical to one stratum a launch: {same}")
    assert same
    samples = 512 * 512 * 64
    # one pass of that render by stage (CUDA events), to see where the time goes
    words = rng.key_words(key)
    path_keys = [rng.fold_in_words(rng.key_words(k_path), i) for i in range(8)]
    px0 = pixel_centers(W, H, dev)
    rows1 = torch.from_numpy(launch_words([words], [0], 0)).view(1, -1).to(dev)
    stages = {
        "threefry uniforms (8, B, 12), R1": lambda: draw_uniforms(k_path, B, 8, dev),
        "threefry uniforms (8, B, 12), plain (eager int64, the draw before R1)": lambda: (
            rng.uniform_block_plain(path_keys, 12 * B, dev)),
        "launch_inputs (host words, their copy, the R1 and R2 launches)": lambda: launch_inputs(
            scene, px0, launch_words([words], [0], 8), 1, 8, DEFAULT_OPTIONS),
        "camera stage, R2 (launch_rays_table: jitter and rays, one launch)": lambda: (
            launch_rays_table(scene, px0, rows1, 8)),
        "camera stage, plain (camera_rays_table_plain: the plain jitter draw, then the eager "
        "ops)": lambda: camera_rays_table_plain(scene.camera, px0, rows1, 8),
        "K1 primary hit + K2": lambda: ray_color_cuda(scene, o, d, u, DEFAULT_OPTIONS),
    }
    for what, fn in stages.items():
        print(f"pass stage {what}: {time_ms(fn, reps=10):.4f} ms ({card})")
    print(f"main path: demo-box 512x512 64 spp through the CLI, launches {launches}, "
          f"render {res.render_seconds:.3f} s, mean radiance {res.linear.mean().item():.4f}")
    print(f"samples/s: {samples / res.render_seconds:.1f} ({card})")
    # /profile DIR: profile_trace(DIR) around the render, a trace inside DIR
    # holding the path's kernels (CUDA recorded without being asked: the
    # card is in use)
    with tempfile.TemporaryDirectory() as tmp:
        prof = pathlib.Path(tmp) / "prof"
        cli.run([str(ROOT / "scenes" / "demo-box.urn"), "/res", "128x128", "/smp", "2",
                 "/o", str(pathlib.Path(tmp) / "p.bmp"), "/profile", str(prof)])
        (trace,) = prof.glob("*.pt.trace.json")
        names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
                 if e.get("cat") == "kernel"]
    found = {k: sum(any(w in x for w in words) and not any(w in x for w in unless)
                    for x in names)
             for k, (words, unless) in PROFILE_KERNELS.items()}
    print(f"/profile: {trace.name} in the directory, {len(names)} kernel records, of the path's "
          f"kernels {found}")
    assert all(found.values()), found

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

    # rays in, t, prim and found out, the table once
    k1_bound = work_bound(B * (24 + 9) + scene.prims_packed.numel() * 4.0, B * query_ops(scene))
    print(f"bound: K1 {k1_bound[0]:.6f} ms ({k1_bound[1]}) at B={B}")

    big, query_entry, mesh1_pass, r1_big, r2_big = big_scene_phases(phase, dev, card)
    # K2's bound counts the vertices the pass runs: phase 12 checks them
    k5, k2_bound = telemetry_phase(phase, card, lib, (scene, o, d, u, k2_ms), mesh1_pass)
    gradient_phase(phase, dev, card)
    train_k1 = training_phase(phase, dev, card)
    flagship_phase(phase, dev, card)
    recovery_phase(phase, dev, card)
    multi_device_phase(phase, dev, card)
    tools_phase(phase, dev, card)
    # the K3 query's own launches: the plain path's queries under
    # intersect_backend="bvh" (phase 19 (b))
    query_launches = routing_phase(phase, dev, card)
    api_launches = api_phase(phase, dev, card)
    r1 = rng_phase(phase, dev, card, launches["R1"] + r1_big)
    launch_devices_phase(phase, card)
    r2 = camera_phase(phase, dev, card, launches["R2"] + r2_big)
    g1 = row_grad_phase(phase, dev, card)
    phase()
    print(f"K1 launches by shape: demo-box primary (the 512x512 64-spp render) {launches['K1']}, "
          + ", ".join(f"{k} {v}" for k, v in train_k1.items())
          + f", the scene-level API's queries (phase 20) {api_launches['K1']}; the mesh renders "
          "(K3) and the wavefront render (K4) 0")
    assert not spills, f"ptxas spills (stores, loads) in {spills}"

    kernels = [
        entry("K1 closest_hit (ms: kernel-only, demo-box primary; launches: the demo-box render "
              "and the scene-level API's queries)",
              K1_SOURCE, K1_REPLACES, launches["K1"] + api_launches["K1"], k1_err, k1_ms,
              k1_plain_ms, k1_bound),
        entry("K2 path megakernel", K2_SOURCE, K2_REPLACES, launches["K2"], k2_err, k2_ms,
              k2_plain_ms, k2_bound),
        big[0],
        query_entry(query_launches + api_launches["K3 query"]),
        big[1],
        k5,
        r1,
        r2,
        g1,
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def k1_equal_plain(scene, o, d, got, what):
    """K1's answer `got` (found, prim, t) against closest_hit_plain on
    every ray, bit for bit, in chunks of PLAIN_CHUNK rays. Returns the
    largest difference of t (0.0)."""
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_plain

    torch.cuda.synchronize()
    for i in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(i, i + PLAIN_CHUNK)
        for name, a, b in zip(("found", "prim", "t"), (x[sl] for x in got),
                              closest_hit_plain(scene.prims_packed, o[sl], d[sl])):
            assert torch.equal(a, b), f"K1 vs plain ({what}): {name} differs on " \
                                      f"{(a != b).sum().item()} rays"
    print(f"K1 {what} (B={o.shape[0]}, rows {scene.prims_packed.shape[0]}, segments "
          f"{tuple(scene.packed_type_rows)}): found, prim and t bit-equal to plain; hit fraction "
          f"{got[0].double().mean().item():.4f}")
    return 0.0


def k1_times(scene, o, d, what, card, reps=20):
    """(kernel-only ms, wrapper ms) of K1 on rays o, d: the kernel's device
    time a launch from torch.profiler (its launches' names hold K1_KERNELS),
    and CUDA events around calls of the wrapper (checks, allocations, the
    launch). If the profiler records no device time, the wrapper's time
    stands for both, and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit

    rows = scene.packed_type_rows
    call = lambda: closest_hit(scene.prims_packed, o, d, rows)
    wrapper = time_ms(call, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if any(k in ev.key for k in K1_KERNELS)]
    dev_us = sum(getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
                 for ev in evs)
    # per recorded launch: the profiler may drop some of a run's records
    kernel = dev_us / 1e3 / sum(ev.count for ev in evs) if dev_us > 0 else wrapper
    how = "torch.profiler" if dev_us > 0 else "the profiler recorded none: wrapper time"
    # rays in, t, prim and found out, the table once; every row tested
    bound = work_bound(o.shape[0] * (24 + 9) + scene.prims_packed.numel() * 4.0,
                       o.shape[0] * query_ops(scene))
    print(f"K1 time {what} (B={o.shape[0]}, rows {scene.prims_packed.shape[0]}): kernel-only "
          f"{kernel:.4f} ms ({how}), wrapper {wrapper:.4f} ms a call; bound {bound[0]:.6f} ms "
          f"({bound[1]}) ({card})")
    return kernel, wrapper


def bit_equal_query(scene, o, d, what):
    """The K3 query and K1 each against K1's plain version
    (closest_hit_plain, in chunks of PLAIN_CHUNK rays), the oracle of both
    (they serve the same queries as alternatives: intersect_backend "bvh"
    and "pallas"): found and prim equal on every ray, t bit-equal on
    every hit for the query (on a miss it reports BIG where K1 and its
    plain version may report a padding row about 1e30 away) and on every
    ray for K1; and the query against K1 the same way."""
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
        closest_hit, closest_hit_bvh, closest_hit_plain,
    )

    q = closest_hit_bvh(scene, o, d)
    k1 = closest_hit(scene.prims_packed, o, d, scene.packed_type_rows)
    torch.cuda.synchronize()

    def winners_equal(got, want, who, sl=slice(None)):
        hits = want[0]
        for name, a, b in (("found", got[0], hits), ("prim", got[1], want[1]),
                           ("t on hits", got[2][hits], want[2][hits])):
            assert torch.equal(a, b), f"{who} ({what}, rays {sl}): {name} differs on " \
                                      f"{(a != b).sum().item()} rays"

    for i in range(0, o.shape[0], PLAIN_CHUNK):
        sl = slice(i, i + PLAIN_CHUNK)
        plain = closest_hit_plain(scene.prims_packed, o[sl], d[sl])
        winners_equal([x[sl] for x in q], plain, "K3 query vs K1 plain", sl)
        for name, a, b in zip(("found", "prim", "t"), (x[sl] for x in k1), plain):
            assert torch.equal(a, b), f"K1 vs plain ({what}): {name} differs"
    winners_equal(q, k1, "K3 query vs K1")
    hits = k1[0]
    print(f"K3 query {what}: winners equal to K1's plain version and to K1, t bit-equal on "
          f"hits; K1 equal to plain; hit fraction {hits.double().mean().item():.4f}")
    return (q[2][hits] - k1[2][hits]).abs().max().item() if hits.any() else 0.0


def query_times(scene, o, d, what, card):
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
        closest_hit, closest_hit_bvh, closest_hit_plain,
    )

    def plain_all():
        for i in range(0, o.shape[0], PLAIN_CHUNK):
            closest_hit_plain(scene.prims_packed, o[i:i + PLAIN_CHUNK], d[i:i + PLAIN_CHUNK])

    ms = time_ms(lambda: closest_hit_bvh(scene, o, d), reps=20)
    k1_ms = time_ms(lambda: closest_hit(scene.prims_packed, o, d, scene.packed_type_rows), reps=5)
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
    """Phases 7-11: the stream tier (K3, its BVH query, K4). Returns K3's
    and K4's entries of the JSON line, the K3 query's entry as a function
    of its launches (counted in phase 19), the mesh1 launch of the main
    path (scene, o, d, u, K3 ms): 4 strata of 256x256, 262,144 rays, and
    the R1 and R2 launches of phase 10's CLI renders."""
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
    from plutracer_tpu_torch import cli, rng
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit
    from plutracer_tpu_torch.ops.cuda.stream_kernel import (
        onebounce_cuda, onebounce_plain, ray_color_stream_cuda,
    )
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.render.integrator import draw_uniforms, kernel_tier, ray_color_plain
    from plutracer_tpu_torch.render.renderer import (
        camera_rays_table_plain, launch_inputs, launch_rays_table, launch_words, pixel_centers,
        render, strata_per_launch,
    )
    from plutracer_tpu_torch.render.wavefront import SORTS, ray_color_wavefront
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.scene.loader import sphere_cloud

    def load(name, W, H):
        return compile_scene(load_scene_file(str(ROOT / "scenes" / f"{name}.urn"),
                                             ["/res", f"{W}x{H}"]), device=dev)

    # ---- 7. the K3 query against K1 and the plain brute force ----
    phase("7 K3 query")
    mb = DEFAULT_OPTIONS.max_bounces
    mesh1 = load("mesh1", 256, 256)
    o, d, u = main_path_rays(mesh1, 256, 256, 4, rng.PRNGKey(7), 1, DEFAULT_OPTIONS)
    f0, _, t0 = closest_hit(mesh1.prims_packed, o, d, mesh1.packed_type_rows)
    hit_p = o + d * torch.where(f0, t0, 1.0)[:, None]
    ext_d = uniform_sphere_sample(rng.uniform(rng.fold_in(rng.PRNGKey(7), 99), (o.shape[0], 2),
                                              dev))
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
    mesh2 = load("mesh2", 256, 256)
    walk_visits(mesh1, "mesh1", (o, d), (hit_p, ext_d))
    m2o, m2d, m2u = main_path_rays(mesh2, 256, 256, 4, rng.PRNGKey(7), 1, DEFAULT_OPTIONS)
    f2, _, t2 = closest_hit(mesh2.prims_packed, m2o, m2d, mesh2.packed_type_rows)
    walk_visits(mesh2, "mesh2", (m2o, m2d),
                (m2o + m2d * torch.where(f2, t2, 1.0)[:, None], ext_d))
    # K1 at the big tables' shapes (the plain path's queries on a card)
    k1_times(mesh1, hit_p, ext_d, "mesh1 extension", card)
    mo4, md4, _ = main_path_rays(mesh1, 256, 256, 4, rng.PRNGKey(7), 4, DEFAULT_OPTIONS)
    k1_times(mesh1, mo4, md4, "mesh1 camera", card, reps=5)
    k1_times(mesh2, m2o, m2d, "mesh2 camera", card, reps=5)
    del mo4, md4

    # ---- 8. K3 against ray_color_plain, same uniforms ----
    phase("8 K3")
    per = strata_per_launch(mesh1, DEFAULT_OPTIONS, 256 * 256)
    assert per == 4, per
    # the main path's launch: strata 0-3 of mesh1 at 256x256, 16 spp
    bo, bd, bu = main_path_rays(mesh1, 256, 256, 4, rng.PRNGKey(7), per, DEFAULT_OPTIONS)
    B = bo.shape[0]
    k3_out = ray_color_stream_cuda(mesh1, bo, bd, bu, DEFAULT_OPTIONS)
    k3_err = lanes_equal(k3_out, ray_color_plain(mesh1, bo, bd, bu, DEFAULT_OPTIONS),
                         f"K3 vs ray_color_plain, mesh1 256x256 x {per} strata (one launch)")
    k3_ms = time_ms(lambda: ray_color_stream_cuda(mesh1, bo, bd, bu, DEFAULT_OPTIONS), reps=10)
    k3_one_ms = time_ms(lambda: ray_color_stream_cuda(mesh1, o, d, u, DEFAULT_OPTIONS), reps=10)
    k3_plain_ms = time_ms(lambda: ray_color_plain(mesh1, bo, bd, bu, DEFAULT_OPTIONS), reps=2, warmup=1)
    print(f"K3 time mesh1 B={B} ({per} strata), 8 bounces: kernel {k3_ms:.4f} ms "
          f"({k3_ms / per:.4f} ms a stratum; one stratum alone, B={o.shape[0]}: "
          f"{k3_one_ms:.4f} ms), ray_color_plain {k3_plain_ms:.4f} ms ({card})")
    # mesh2, the largest scene: K3's biggest tables (P = 102,403), the
    # plain version's queries through K1
    k3_err = max(k3_err, lanes_equal(
        ray_color_stream_cuda(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS),
        ray_color_plain(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS), "K3 vs ray_color_plain, mesh2 256x256 pass"))
    m2bo, m2bd, m2bu = main_path_rays(mesh2, 256, 256, 4, rng.PRNGKey(7), per, DEFAULT_OPTIONS)
    m2_ms = time_ms(lambda: ray_color_stream_cuda(mesh2, m2bo, m2bd, m2bu, DEFAULT_OPTIONS), reps=10)
    print(f"K3 time mesh2 B={m2bo.shape[0]} ({per} strata), P={mesh2.num_prims}: kernel "
          f"{m2_ms:.4f} ms ({m2_ms / per:.4f} ms a stratum; one stratum alone "
          f"{time_ms(lambda: ray_color_stream_cuda(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS), 10):.4f}"
          f" ms), ray_color_plain (one stratum) "
          f"{time_ms(lambda: ray_color_plain(mesh2, m2o, m2d, m2u, DEFAULT_OPTIONS), reps=2, warmup=1):.4f}"
          f" ms ({card})")
    del m2bo, m2bd, m2bu
    grid = load("sphere-grid", 640, 480)
    go, gd, gu = main_path_rays(grid, 640, 480, 4, rng.PRNGKey(7), 1, DEFAULT_OPTIONS)
    k3_err = max(k3_err, lanes_equal(
        ray_color_stream_cuda(grid, go, gd, gu, DEFAULT_OPTIONS),
        ray_color_plain(grid, go, gd, gu, DEFAULT_OPTIONS), "K3 vs ray_color_plain, sphere-grid 640x480"))
    print(f"K3 time sphere-grid B={go.shape[0]}: kernel "
          f"{time_ms(lambda: ray_color_stream_cuda(grid, go, gd, gu, DEFAULT_OPTIONS), reps=10):.4f}"
          f" ms, ray_color_plain "
          f"{time_ms(lambda: ray_color_plain(grid, go, gd, gu, DEFAULT_OPTIONS), reps=2, warmup=1):.4f}"
          f" ms ({card})")

    # ---- 9. K4 bit-equal to K3 for each reorder, on the main path's launches ----
    phase("9 K4")
    k4_err, k4_ms = 0.0, {}
    m2bo, m2bd, m2bu = main_path_rays(mesh2, 256, 256, 4, rng.PRNGKey(7), per, DEFAULT_OPTIONS)
    k3_m2 = ray_color_stream_cuda(mesh2, m2bo, m2bd, m2bu, DEFAULT_OPTIONS)
    for sort in SORTS:
        opts = DEFAULT_OPTIONS.replace(stream_wavefront=True, stream_sort=sort)
        for name, scene, rays, k3 in (("mesh1", mesh1, (bo, bd, bu), k3_out),
                                      ("mesh2", mesh2, (m2bo, m2bd, m2bu), k3_m2)):
            # every ray written once: out starts NaN, and the launches end B rays
            out = torch.full((B, 3), float("nan"), device=dev)
            waves = []
            with counting():
                before = (launched("k4"), launched("k1"))
                ray_color_wavefront(scene, *rays, opts, out=out, wave_out=waves)
                assert (launched("k4") - before[0], launched("k1") - before[1]) \
                    == (mb, 0)
            ended = int(waves[0].counts[mb:].sum().item())
            assert ended == B, f"K4 {sort} {name}: {ended} rays ended, not {B}"
            k4_err = max(k4_err, lanes_equal(out, k3, f"K4 {sort} vs K3, {name} launch (every "
                                                        f"ray written once)"))
        k4_ms[sort] = time_ms(lambda: ray_color_wavefront(mesh1, bo, bd, bu, opts), reps=5)
        print(f"K4 wavefront loop ({sort}, mesh1 B={B}) {k4_ms[sort]:.4f} ms; live lanes after "
              f"each launch {waves[0].counts[:mb].tolist()} of mesh2's ({card})")
        wavefront_split(mesh1, bo, bd, bu, opts, card)
    del m2bo, m2bd, m2bu, k3_m2
    opts = DEFAULT_OPTIONS.replace(stream_wavefront=True)
    lanes_equal(ray_color_wavefront(mesh1, bo, bd, bu, opts),
                ray_color_wavefront(mesh1, bo, bd, bu, opts, step=onebounce_plain),
                "K4 wavefront vs plain_bounce wavefront (morton), mesh1 launch")
    loop_plain_ms = time_ms(lambda: ray_color_wavefront(mesh1, bo, bd, bu, opts,
                                                        step=onebounce_plain), reps=2, warmup=1)
    # each step alone (CUDA events around every launch), morton
    k4_step = step_times(mesh1, bo, bd, bu, opts, onebounce_cuda, passes=5)
    plain_step = step_times(mesh1, bo, bd, bu, opts, onebounce_plain, passes=2)
    k4_launch_ms = sum(k4_step) / len(k4_step)
    k4_plain_ms = sum(plain_step) / len(plain_step)
    by_bounce = [sum(k4_step[i::mb]) / (len(k4_step) // mb) for i in range(mb)]
    print(f"K4 launches alone (morton, mesh1 B={B}): {k4_launch_ms:.4f} ms per launch, "
          f"{k4_launch_ms * mb:.4f} ms per pass of {mb}, by bounce "
          f"{[round(x, 4) for x in by_bounce]}; plain step {k4_plain_ms:.4f} ms per step, "
          f"{k4_plain_ms * mb:.4f} ms per pass ({card})")
    print(f"K4 wavefront loop (morton: {mb} K4 launches, launch 0 with the primary walk, "
          f"{mb - 1} argsorts) {k4_ms['morton']:.4f} ms, plain step loop {loop_plain_ms:.4f} ms; "
          f"K3 {k3_ms:.4f} ms for the same rays ({card})")

    # ---- 10. the big-scene path: mesh1 and mesh2 through the CLI, 256x256, 16 spp ----
    phase("10 big-scene path")
    launches = {}
    r1_launches = r2_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, scene in (("mesh1", mesh1), ("mesh2", mesh2)):
            with counting():
                res = cli.run([str(ROOT / "scenes" / f"{name}.urn"),
                               "/o", str(pathlib.Path(tmp) / "o.bmp"), "/seed", "7"])
                launches[name] = launched("k3")
                assert launched("k1_bvh") == 0  # the walk runs inside K3
                # the path uniforms of a launch of 4 strata: one R1 launch
                assert launched("r1") == launches[name], launched("r1")
                r1_launches += launched("r1")
                # and one R2 launch: the launch's jitter and camera rays
                assert launched("r2") == launches[name], launched("r2")
                r2_launches += launched("r2")
                assert res.integrator == "kernel" and res.tier == "k3", (res.integrator, res.tier)
                assert tuple(res.linear.shape) == (256, 256, 3) and torch.isfinite(res.linear).all()
                assert launches[name] == 16 // per, launches  # 4 strata a launch
                print(f"main path: {name} 256x256 16 spp through the CLI, K3 launches "
                      f"{launches[name]}, R1 launches {launched('r1')}, R2 launches "
                      f"{launched('r2')}, render {res.render_seconds:.3f} s, mean radiance "
                      f"{res.linear.mean().item():.4f}; samples/s "
                      f"{256 * 256 * 16 / res.render_seconds:.1f} ({card})")
                before = launched("k3")
                same = torch.equal(res.linear, stratum_by_stratum(
                    scene, 256, 256, 4, rng.PRNGKey(7), DEFAULT_OPTIONS))
                assert launched("k3") == before + 16
            print(f"main path: the {name} CLI render bit-identical to one stratum a launch "
                  f"(16 launches): {same}")
            assert same, name
    # the batched pass loop against one stratum a launch, timed in turns
    for name, scene, w, n in (("mesh1", mesh1, 256, 4), ("mesh2", mesh2, 256, 4),
                              ("demo-box", load("demo-box", 512, 512), 512, 8)):
        render_turns(scene, w, w, n, name, card)
    # one launch of the mesh1 render by stage (CUDA events)
    k_path = rng.split(rng.fold_in(rng.PRNGKey(7), 0), 3)[2]
    B1 = o.shape[0]
    launch_keys = [rng.fold_in_words(rng.key_words(rng.PRNGKey(7)), s) for s in range(per)]
    path_keys = [rng.fold_in_words(rng.key_words(k_path), i) for i in range(mb)]
    px0 = pixel_centers(256, 256, dev)
    rows4 = torch.from_numpy(launch_words(launch_keys, range(per), 0)).view(per, -1).to(dev)
    stages = {
        f"threefry uniforms (8, B, 12), one stratum, R1": lambda: draw_uniforms(
            k_path, B1, mb, dev),
        f"threefry uniforms (8, B, 12), one stratum, plain (the draw before R1)": lambda: (
            rng.uniform_block_plain(path_keys, 12 * B1, dev)),
        f"launch_inputs, {per} strata (host words, their copy, the R1 and R2 launches)": (
            lambda: launch_inputs(mesh1, px0, launch_words(launch_keys, range(per), mb), per, 4,
                                  DEFAULT_OPTIONS)),
        f"camera stage, {per} strata, R2 (launch_rays_table: jitter and rays, one launch)": (
            lambda: launch_rays_table(mesh1, px0, rows4, 4)),
        f"camera stage, {per} strata, plain (camera_rays_table_plain: the plain jitter draw, "
        "then the eager ops)": lambda: camera_rays_table_plain(mesh1.camera, px0, rows4, 4),
        f"K3 (primary hit in the kernel), {per} strata": lambda: ray_color_stream_cuda(
            mesh1, bo, bd, bu, DEFAULT_OPTIONS),
    }
    for what, fn in stages.items():
        print(f"mesh1 launch stage {what}: {time_ms(fn, reps=10):.4f} ms, B={B1} a stratum "
              f"({card})")
    wf = DEFAULT_OPTIONS.replace(stream_wavefront=True)
    assert kernel_tier(mesh1, wf) == "k4"
    with counting():
        img = render(mesh1, 256, 256, 2, rng.PRNGKey(7), wf)
        torch.cuda.synchronize()
        k4_launches, k4_k1 = launched("k4"), launched("k1")
    # the 4 strata in one wavefront loop: 8 K4 launches (the first finds
    # the primary hit), no K1 launch
    assert torch.isfinite(img).all() and k4_launches == mb and k4_k1 == 0, (k4_launches, k4_k1)
    print(f"main path: mesh1 256x256 4 spp render(..., stream_wavefront=True): K4 launches "
          f"{k4_launches}, K1 launches {k4_k1}")

    # ---- 11. goldens through K3, each at its golden's size (tests/test_golden.py) ----
    phase("11 goldens K3")
    for name in ("sphere-grid", "mesh0", "mesh1", "mesh2", "mesh-tex"):
        golden = np.load(ROOT / "tests" / "goldens" / f"repo-{name}.npz")["linear"].astype(np.float32)
        h, w = golden.shape[:2]
        gscene = load(name, w, h)
        assert kernel_tier(gscene, DEFAULT_OPTIONS) == "k3"
        with counting():
            before = launched("k3")
            img = render(gscene, w, h, 2, rng.PRNGKey(42)).cpu().numpy()
            assert launched("k3") == before + 1, name  # the 4 strata in one launch
        if name == "sphere-grid":
            diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(golden, 0.0)))
            p99, mean = float(np.quantile(diff, 0.99)), float(diff.mean())
            print(f"golden repo-{name}: p99 {p99:.3e} (bound 0.05), mean {mean:.3e} (bound 0.01)")
            assert img.shape == golden.shape and p99 < 0.05 and mean < 0.01, name
        else:
            structural_check(img, golden, name)

    # bounds at the timed shapes. K3's and K4's work depends on the data:
    # ray_color_plain replays the timed launch for the vertices that
    # run and the queries they issue (the running vertices checked against
    # K5's cur channel), and the plain walk counts every walk's records and
    # rows: the primary walks (K3 only), the closest-hit and any-hit walks
    # of the vertices
    live, closest_rays, any_rays = issued_queries(mesh1, bo, bd, bu, DEFAULT_OPTIONS)
    _, tele = ray_color_stream_cuda(mesh1, bo, bd, bu, DEFAULT_OPTIONS, debug=True)
    assert live == tele[:, 8].sum(1).long().tolist(), (live, tele[:, 8].sum(1).tolist())
    primary, closest_w, any_w = (walk_work(mesh1, bo, bd), walk_work(mesh1, *closest_rays),
                                 walk_work(mesh1, *any_rays, any_hit=True))
    n_live = sum(live)
    vert_ops = n_live * SHADE_OPS + closest_w[0] + any_w[0]
    k3_bound = work_bound(B * (24 + 12) + n_live * 12 * 4 + table_bytes(mesh1, walk=True),
                          primary[0] + vert_ops)
    # K4 a launch, the pass's work over its mb launches: the rays in and
    # the radiance out once; for each running vertex (under morton the
    # launch's lanes) its carry in and out (64 + 64 bytes), uniforms 48,
    # perm 8, its ray in and out 4 + 4, its key 4; the tables once a launch;
    # the primary walks (launch 0) and the vertices' work
    k4_bound = work_bound((B * (24 + 12) + n_live * (64 * 2 + 48 + 8 + 4 + 4 + 4)) / mb
                          + table_bytes(mesh1, walk=True), (primary[0] + vert_ops) / mb)
    B1 = hit_p.shape[0]
    query_w = walk_work(mesh1, hit_p, ext_d)
    q_bound = work_bound(B1 * (24 + 8) + walk_bytes(mesh1), query_w[0])
    per_walk = lambda w: w[2] / max(w[1], 1)
    print(f"bounds (mesh1 launch of {per} strata, B={B}): running vertices {n_live} of {B * mb} "
          f"(by bounce {live}); walks: {primary[1]} primary, {closest_w[1]} closest-hit and "
          f"{any_w[1]} any-hit from the vertices ({(closest_w[1] + any_w[1]) / n_live:.4f} a "
          f"running vertex); node records and leaves a walk: primary {per_walk(primary):.4f}, "
          f"closest-hit {per_walk(closest_w):.4f}, any-hit {per_walk(any_w):.4f}; K3 "
          f"{k3_bound[0]:.6f} ms ({k3_bound[1]}), K4 {k4_bound[0]:.6f} ms a launch "
          f"({k4_bound[1]}); query (B={B1}, {per_walk(query_w):.4f} a walk) {q_bound[0]:.6f} ms "
          f"({q_bound[1]})")

    k3_launches = launches["mesh1"] + launches["mesh2"]
    # the query runs inside every K3 and K4 launch; its own launch answers
    # the plain path's queries under intersect_backend="bvh"
    query_entry = lambda n: entry(
        "K3 query bvh_closest (inside K3 and K4, and its own launch for the plain path's "
        "queries under intersect_backend='bvh'; ms: mesh1 extension rays; launches: one mesh1 "
        "128x128 loss_and_grads and the scene-level API's queries)", KQ_SOURCE, KQ_REPLACES, n,
        q_err, q_ms, q_plain_ms, q_bound)
    return [
        entry("K3 stream kernel (ms: the mesh1 launch of 4 strata)", K3_SOURCE, K3_REPLACES,
              k3_launches, k3_err, k3_ms, k3_plain_ms, k3_bound),
        entry("K4 one-bounce kernel (ms per launch)", K4_SOURCE, K4_REPLACES, k4_launches,
              k4_err, k4_launch_ms, k4_plain_ms, k4_bound),
    ], query_entry, (mesh1, bo, bd, bu, k3_ms), r1_launches, r2_launches


def wavefront_split(scene, o, d, u, opts, card, passes=5):
    """render/wavefront.ray_color_wavefront's loop with CUDA events around
    each stage (the Wave's buffers, each argsort of the keys, each K4
    launch), mean of `passes` passes after one unrecorded; prints the split
    by stage and by bounce."""
    from plutracer_tpu_torch.ops.cuda.stream_kernel import onebounce_cuda
    from plutracer_tpu_torch.ops.tables import pack_tables
    from plutracer_tpu_torch.render.wavefront import Wave

    times = {}

    def stage(name, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = fn()
        b.record()
        times.setdefault(name, []).append((a, b))
        return r

    mb = opts.max_bounces
    for p in range(passes + 1):
        if p == 1:
            times.clear()
        tables = pack_tables(scene)
        wave = stage("buffers", lambda: Wave.start(scene, o, d, u, opts.stream_sort, mb))
        for i in range(mb):
            perm = None
            if i > 0 and opts.stream_sort != "none":
                perm = stage(f"argsort {i}", lambda: torch.argsort(wave.key, stable=True))
            stage(f"K4 {i}", lambda: onebounce_cuda(scene, tables, wave, i, perm, opts))
            wave.advance()
    torch.cuda.synchronize()
    mean = {k: sum(a.elapsed_time(b) for a, b in v) / len(v) for k, v in times.items()}
    k4 = sum(v for k, v in mean.items() if k.startswith("K4"))
    total = sum(mean.values())
    print(f"wavefront split ({opts.stream_sort}, B={o.shape[0]}): stages {total:.4f} ms = K4 "
          f"launches {k4:.4f} + host stages {total - k4:.4f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in mean.items()) + f" ({card})")
    return mean


def render_turns(scene, w, h, n, what, card):
    """A render batched as the pass loop traces it (renderer.render) and
    the same image one stratum a launch (stratum_by_stratum), timed in
    turns (batched, one, one, batched; TURN_ROUNDS rounds) after one
    unrecorded render of each: wall milliseconds of each render to a
    synchronize, and their medians."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.render.renderer import render, strata_per_launch
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    renders = {"batched": lambda: render(scene, w, h, n, rng.PRNGKey(7)),
               "one": lambda: stratum_by_stratum(scene, w, h, n, rng.PRNGKey(7), DEFAULT_OPTIONS)}
    times = {k: [] for k in renders}
    for fn in renders.values():
        fn()
    for k in ("batched", "one", "one", "batched") * TURN_ROUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renders[k]()
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    rate = lambda ms: w * h * n * n / ms * 1e3
    print(f"render in turns {what} {w}x{h} {n * n} spp: batched "
          f"({strata_per_launch(scene, DEFAULT_OPTIONS, w * h)} strata a launch) median "
          f"{med['batched']:.4f} ms ({rate(med['batched']):.1f} samples/s), one stratum a launch "
          f"median {med['one']:.4f} ms ({rate(med['one']):.1f} samples/s), one/batched "
          f"{med['one'] / med['batched']:.4f}; readings batched "
          f"{[round(x, 4) for x in times['batched']]}, one {[round(x, 4) for x in times['one']]} "
          f"({card})")
    return med


def main_path_rays(scene, w, h, n, key, strata, options):
    """The rays o, d and uniforms u the pass loop hands one launch: strata
    0..strata-1 of a w x h image with n x n strata, drawn as
    render/renderer draws them (fold_in(key, s) a stratum)."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.render.renderer import _stratum_rays, pixel_centers

    px0 = pixel_centers(w, h, scene.device)
    o, d, u = zip(*(_stratum_rays(scene, px0, rng.fold_in(key, s), s, n, options)
                    for s in range(strata)))
    return torch.cat(o), torch.cat(d), torch.cat(u, 1)


def walk_visits(scene, what, *rays):
    """Mean node records and leaves visited and rows tested per walk of
    the walk layout (walk_closest_plain, the kernel's walk step for step),
    on up to WALK_RAYS of each ray set; its answers checked against the
    query kernel's."""
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_bvh, walk_closest_plain

    for name, (o, d) in zip(("camera", "extension"), rays):
        o, d = o[:WALK_RAYS], d[:WALK_RAYS]
        found, prim, _, nodes, leaves, rows = walk_closest_plain(
            scene.prims_packed, scene.walk_nodes, scene.walk_rows, o, d, count=True)
        q = closest_hit_bvh(scene, o, d)
        assert torch.equal(found, q[0]) and torch.equal(prim, q[1]), what
        mean = lambda x: x.double().mean().item()
        print(f"walk visits {what} {name} rays (B={o.shape[0]}, P={scene.num_prims}): "
              f"{mean(nodes + leaves):.4f} node records and leaves ({mean(nodes):.4f} records), "
              f"{mean(rows.sum(1)):.4f} rows a walk ({scene.walk_nodes.shape[0]} records; the "
              f"reference tree has {scene.bvh.num_nodes} nodes)")


def channel_report(dbg, ref, what, stream=False):
    """K5 against ray_color_plain(debug=True): per channel the largest
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
    from plutracer_tpu_torch.render.integrator import ray_color_plain
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS as OPTS

    phase("12 K5 telemetry")
    scene, o, d, u, k2_ms = demo_pass
    mesh1, mo, md, mu, k3_ms = mesh1_pass
    mb, B = OPTS.max_bounces, o.shape[0]
    # the path: one debug pass of each tier, counts set to 0 just before
    with counting():
        L2, dbg2 = ray_color_kernel(scene, o, d, u, OPTS, debug=True)
        L3, dbg3 = ray_color_kernel(mesh1, mo, md, mu, OPTS.replace(stream_wavefront=True),
                                    debug=True)
        torch.cuda.synchronize()
        k5_launches = {"K2": launched("k2_debug"), "K3": launched("k3_debug")}
    print(f"K5 path: a demo-box 512x512 debug pass (K2) and a mesh1 debug launch of 4 strata "
          f"of 256x256 (K3, under stream_wavefront too), launches {k5_launches}")
    assert k5_launches == {"K2": 1, "K3": 1}, k5_launches
    assert dbg2.shape == (mb, DBG_C, B) and dbg3.shape == (mb, DBG_C, mo.shape[0])
    for what, L, plain_L in (("K2 demo-box", L2, ray_color_kernel(scene, o, d, u, OPTS)),
                             ("K3 mesh1", L3, ray_color_stream_cuda(mesh1, mo, md, mu, OPTS))):
        eq = torch.equal(L, plain_L)
        print(f"K5 {what}: radiance with debug on bit-equal to debug off: {eq}")
        assert eq, what
    ref_L2, ref2 = ray_color_plain(scene, o, d, u, OPTS, debug=True)
    ref_L3, ref3 = ray_color_plain(mesh1, mo, md, mu, OPTS, debug=True)
    lanes_equal(L2, ref_L2, "K5 (K2) radiance vs ray_color_plain(debug=True)")
    lanes_equal(L3, ref_L3, "K5 (K3) radiance vs ray_color_plain(debug=True)")
    err = max(channel_report(dbg2, ref2, "K2 demo-box 512x512"),
              channel_report(dbg3, ref3, "K3 mesh1 4 strata of 256x256", stream=True))
    k5_k2_ms = time_ms(lambda: ray_color_cuda(scene, o, d, u, OPTS, debug=True), reps=20)
    k2_again = time_ms(lambda: ray_color_cuda(scene, o, d, u, OPTS), reps=20)
    k5_k3_ms = time_ms(lambda: ray_color_stream_cuda(mesh1, mo, md, mu, OPTS, debug=True), reps=10)
    k3_again = time_ms(lambda: ray_color_stream_cuda(mesh1, mo, md, mu, OPTS), reps=10)
    plain_ms = time_ms(lambda: ray_color_plain(scene, o, d, u, OPTS, debug=True), reps=3, warmup=1)
    print(f"K5 time: K2 demo-box B={B} debug {k5_k2_ms:.4f} ms vs plain instantiation "
          f"{k2_again:.4f} ms (phase 4: {k2_ms:.4f}); K3 mesh1 B={mo.shape[0]} debug "
          f"{k5_k3_ms:.4f} ms vs {k3_again:.4f} ms (phase 8: {k3_ms:.4f}); plain "
          f"ray_color_plain(debug=True) demo-box {plain_ms:.4f} ms ({card})")
    for kernel, lines in ptxas_report(lib.compiler_log).items():
        if kernel.startswith(("megakernel<", "megakernel_stream<")):
            print(f"K5 ptxas {kernel}: {' | '.join(lines)}")
    # K2's work on the pass: the vertices that run and the queries they
    # issue, replayed by ray_color_plain (the running vertices checked
    # against K5's cur channel); each query a pass over the packed table.
    # K1's primary hit is part of K2's time.
    live, closest_rays, any_rays = issued_queries(scene, o, d, u, OPTS)
    assert live == dbg2[:, DBG_CHANNELS.index("cur")].sum(1).long().tolist(), live
    n_live, n_queries, q = sum(live), closest_rays[0].shape[0] + any_rays[0].shape[0], query_ops(scene)
    rays_bytes = B * (24 + 8 + 24 + 8 + 12)  # K1: o, d in, prim, t out; K2: the same in, L out
    k2_bound = work_bound(rays_bytes + n_live * 12 * 4 + table_bytes(scene),
                          B * q + n_live * SHADE_OPS + n_queries * q)
    # K5 runs every vertex of every ray with its three queries and writes
    # every vertex's channels
    bound = work_bound(rays_bytes + B * mb * (12 + DBG_C) * 4 + table_bytes(scene),
                       B * q + B * mb * (SHADE_OPS + 3 * q + K5_OPS))
    print(f"bounds (demo-box 512x512 pass): running vertices {n_live} of {B * mb} (by bounce "
          f"{live}), queries {n_queries} ({n_queries / n_live:.4f} a running vertex, "
          f"{any_rays[0].shape[0]} of them shadow rays of a point light); K2 {k2_bound[0]:.6f} "
          f"ms ({k2_bound[1]}), K5 (K2 debug) {bound[0]:.6f} ms ({bound[1]})")
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
    from plutracer_tpu_torch.parallel.sharded import get_params
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    phase("13 gradients")
    for (name, res), counter in zip(GRAD_CASES, ("k2", "k3")):
        scene = compile_scene(load_scene_file(str(ROOT / "scenes" / f"{name}.urn"),
                                              ["/res", f"{res}x{res}"]), device=dev)
        params = get_params(scene)
        kernel_loss, plain_loss = (make_loss(scene, res, res, b) for b in ("kernel", "plain"))
        with counting():
            before = launched(counter)
            got = loss_grads(kernel_loss, params)
            assert launched(counter) == before + 1, "the Function's forward did not run the kernel"
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
    """Phase 14: optimize_scene on demo-box 256x256, n = 2. Returns K1's
    launches in each train run (the plain forward's queries)."""
    import dataclasses

    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.diff.optim import Adam
    from plutracer_tpu_torch.diff.optimize import InverseRenderConfig, optimize_scene
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
    runs, k1_launches = {}, {}
    for what, cfg, start in (("log", log_cfg, init), ("ab", ab_cfg, None)):
        start = start if start is not None else runs["log"][0]
        stats = {}
        with counting():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, losses = optimize_scene(scene, target, cfg, init_params=start, stats_out=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            passes = 2 if cfg.loss_space == "ab" else 1
            samples = W * H * passes * cfg.steps
            mae = (params["mat_color"] - true["mat_color"]).abs().mean().item()
            print(f"training {what}: {cfg.steps} steps in {wall:.3f} s, "
                  f"{cfg.steps / wall:.4f} steps/s, {samples / wall:.1f} samples/s ({W}x{H} x "
                  f"{passes} pass(es) a step), K1 launches {launched('k1')}, losses "
                  f"{[round(x, 6) for x in losses]}, albedo MAE "
                  f"{(start['mat_color'] - true['mat_color']).abs().mean().item():.5f} -> "
                  f"{mae:.5f}, nonfinite {stats} ({card})")
            assert all(np.isfinite(losses)) and len(losses) == cfg.steps
            assert stats["nonfinite_grad_frac_max"] == 0.0, stats
            assert launched("k1") > 0
            runs[what] = (params, losses, wall)
            # on one card the step is captured once and replayed: the count is
            # its warm-up's and its capture's K1 calls, none from the replays
            k1_launches[f"the {what} train run's queries (a captured step)"] = launched("k1")
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
        loss, grads, nf = halves()
        # the captured step (its first call captures, then it replays) against
        # the eager halves from the same state, bit for bit
        eager = (*step.apply(init, state, grads, nf), loss)
        assert same_tree(step(init, state, tflat, key, 0), eager), f"{what}: captured != eager"
        print(f"training {what} step at {W}x{H}: the captured step's replay bit-equal to the "
              f"eager halves (parameters, Adam's state, loss {loss.item():.6f})")
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
              f"(captured, replayed) {med['step']:.4f} ms; eager: loss_and_grads "
              f"{med['loss_and_grads']:.4f} (forward traces "
              f"{med['forward traces']:.4f}, backward and gradient filter "
              f"{med['loss_and_grads'] - med['forward traces']:.4f}) + apply (Adam) "
              f"{apply_ms:.4f}; "
              f"loss_and_grads without deterministic algorithms {med['nondeterministic']:.4f} "
              f"(their cost {med['loss_and_grads'] - med['nondeterministic']:.4f}); optimize_scene "
              f"{runs[what][2] * 1e3 / cfg.steps:.4f} ms a step; ranges ms: {spread} ({card})")
    cornell_train_step(dev, card)
    return k1_launches


CORNELL_TRAIN = 512  # the train cell's resolution (benchmark/configs/cornell-box.json)


def cornell_train_step(dev, card):
    """Phase 14's last part: the benchmark's train cell's step
    (benchmark/traffic/train_step.json on the Cornell box at 512x512: log
    loss, n = 2, albedo Adam 3e-2 and a decaying emission Adam, diffuse
    albedo from 0.25 and a quarter of the emission, the non-diffuse
    materials masked), captured, against its eager halves bit for bit over
    two steps; the replay's and the eager step's times and the memory the
    capture holds."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.diff import optim
    from plutracer_tpu_torch.parallel import sharded
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.scene.types import MAT_DIFFUSE

    R = CORNELL_TRAIN
    sc = compile_scene(load_scene_file(str(scene_file("cornell-box")), ["/res", f"{R}x{R}"]),
                       device=dev)
    target = render(sc, R, R, 4, rng.PRNGKey(11)).reshape(-1, 3)
    diffuse = sc.mat_type == MAT_DIFFUSE
    params = dict(sharded.get_params(sc))
    params["mat_color"] = torch.where(diffuse[:, None], 0.25, params["mat_color"])
    params["light_intensity"] = params["light_intensity"] * 0.25
    opt = optim.MultiTransform(
        {"albedo": optim.Adam(3e-2), "emission": optim.Adam(optim.exponential_decay(1.0, 600, 0.1))},
        {"mat_color": "albedo", "light_intensity": "emission", "tex_c0": "albedo",
         "tex_c1": "albedo"})
    step = sharded.make_train_step(sc, R, R, 2, optimizer=opt, loss_space="log",
                                   trainable=("mat_color", "light_intensity"),
                                   grad_mask={"mat_color": diffuse.to(torch.float32)[:, None]})
    state = step.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses = []
    for i in range(2):
        key = rng.fold_in(rng.PRNGKey(5), i)
        loss, grads, nf = step.loss_and_grads(params, target, key, i)
        eager = (*step.apply(params, state, grads, nf), loss)
        got = step(params, state, target, key, i)  # the first call captures
        assert same_tree(got, eager), f"the Cornell train step {i}: captured != eager"
        params, state = got[0], got[1]
        losses.append(loss.item())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    key = rng.fold_in(rng.PRNGKey(5), 2)
    replay = [time_ms(lambda: step(params, state, target, key, 2), 1, 0) for _ in range(10)]
    eager = [time_ms(lambda: step.apply(params, state, *step.loss_and_grads(params, target, key,
                                                                              2)[1:]), 1, 0)
             for _ in range(3)]
    print(f"training Cornell box {R}x{R}, the train cell's step: 2 steps captured and replayed "
          f"bit-equal to the eager halves (parameters, both Adams' states, losses {losses}); "
          f"a replayed step {statistics.median(replay):.4f} ms (median of 10, "
          f"{min(replay):.2f}-{max(replay):.2f}), the eager halves {statistics.median(eager):.4f} "
          f"ms (median of 3); peak allocation over the step's inputs "
          f"{peak / 1e9:.3f} GB ({card})")


def flagship_phase(phase, dev, card):
    """Phase 15: the flagship tool through main(argv), straight and
    interrupted in phase 2 then rerun."""
    from plutracer_tpu_torch.tools import inverse_flagship as flagship

    phase("15 flagship")
    scene = ["--scene", str(ROOT / "scenes" / "demo-box.urn"), "--device", dev.type]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        with counting():
            ref = flagship.main([*scene, *FLAGSHIP_ARGS, "--out", str(tmp / "straight.json"),
                                 "--checkpoint", str(tmp / "straight")])
            launches = {"K1": launched("k1"), "K2": launched("k2")}
        real = flagship.optimize_scene

        def interrupting(scene, target, cfg, init_params=None, callback=None, stats_out=None):
            # stop phase 2 at its second chunk's callback: its first
            # checkpoint is written, the chunk's own is not (the crash to test)
            def cb(i, loss, params):
                callback(i, loss, params)
                if cfg.seed == 1 and i > 0:
                    raise KeyboardInterrupt

            return real(scene, target, cfg, init_params=init_params, callback=cb,
                        stats_out=stats_out)

        args = [*scene, *FLAGSHIP_ARGS, "--out", str(tmp / "rerun.json"), "--checkpoint",
                str(tmp / "rerun")]
        flagship.optimize_scene = interrupting
        try:
            flagship.main(args)
            raise AssertionError("the phase-2 interruption did not fire")
        except KeyboardInterrupt:
            pass
        finally:
            flagship.optimize_scene = real
        cut = int(np.load(tmp / "rerun" / "phase2.ckpt.npz")["next_i"])
        t0 = time.perf_counter()
        got = flagship.main(args)
        rerun_s = time.perf_counter() - t0
    same = got["losses"] == ref["losses"] and all(
        torch.equal(got["params"][k], v) for k, v in ref["params"].items())
    stats = ref["grad_sanitize_stats"]
    nf_max = max(stats["nonfinite_grad_frac_max"], stats["phase2"]["nonfinite_grad_frac_max"])
    t = ref["timings"]
    steps = ref["config"]["steps"], ref["config"]["phase2"]["steps"]
    print(f"flagship demo-box {ref['config']['res']}: target {t['target_render_s']:.4f} s "
          f"({ref['config']['target_spp']} spp, K1 + K2); phase 1 {steps[0] / t['phase1_s']:.4f} "
          f"steps/s (log, n = 2), phase 2 {steps[1] / t['phase2_s']:.4f} steps/s (pooled ab, "
          f"n = 4, clamp 10); albedo_mae "
          f"{ref['init']['albedo_mae']:.6f} -> {ref['final']['albedo_mae']:.6f}, emission_rel_err "
          f"{ref['init']['emission_rel_err']:.6f} -> {ref['final']['emission_rel_err']:.6f}; "
          f"nonfinite_grad_frac_max {nf_max}; launches {launches} ({card})")
    print(f"flagship resume: interrupted in phase 2 after its checkpoint at step {cut}, rerun "
          f"({rerun_s:.4f} s, phase 1 replayed) bit-equal to the straight run (parameters and "
          f"{len(ref['losses'])} losses): {same}")
    assert same and len(ref["losses"]) == sum(steps) and cut == 1
    assert all(np.isfinite(ref["losses"])) and nf_max == 0.0
    assert dev.type != "cuda" or (launches["K1"] > 0 and launches["K2"] > 0), launches


def recovery_phase(phase, dev, card):
    """Phase 16: supervised renders crashed and restarted, and a CLI
    /checkpoint render interrupted and resumed, against in-process
    renders."""
    from plutracer_tpu_torch import cli, rng
    from plutracer_tpu_torch.render import progressive
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.render.supervisor import supervise_render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    phase("16 recovery")
    for name, res, n, fault, every in SUPERVISED:
        path = str(ROOT / "scenes" / f"{name}.urn")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            r = supervise_render(path, res, res, n, 7, tmp, checkpoint_every=every,
                                 inject_fault=fault, poll=0.1, device=dev.type)
            sup_s = time.perf_counter() - t0
        scene = compile_scene(load_scene_file(path, ["/res", f"{res}x{res}"]), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scene, res, res, n, rng.PRNGKey(7))
        torch.cuda.synchronize()
        in_s = time.perf_counter() - t0
        same = np.array_equal(r.image, img.cpu().numpy())
        print(f"supervised {name} {res}x{res} n = {n}, {fault}, checkpoint every {every}: "
              f"restarts {r.restarts}, events {r.events}; bit-equal to the in-process render: "
              f"{same}; wall {sup_s:.4f} s supervised (two worker launches) against "
              f"{in_s:.4f} s in-process ({card})")
        assert same and r.restarts == 1
        assert any("exit code 13" in d for e, d in r.events if e == "failure"), r.events
    # the CLI: /checkpoint interrupted after its first checkpoint, then rerun
    path = str(ROOT / "scenes" / "demo-box.urn")
    real = progressive.render_passes
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(pathlib.Path(tmp) / "cli.ckpt.npz")
        args = [path, "/res", f"{CLI_RES}x{CLI_RES}", "/smp", "4", "/seed", "7", "/checkpoint",
                ck, "/o", str(pathlib.Path(tmp) / "cli.bmp"), "/device", dev.type]
        calls = []

        def interrupting(*a, **kw):
            calls.append(a[2])
            if len(calls) == 2:
                raise KeyboardInterrupt
            return real(*a, **kw)

        progressive.render_passes = interrupting
        try:
            cli.run(args)
            raise AssertionError("the CLI interruption did not fire")
        except KeyboardInterrupt:
            pass
        finally:
            progressive.render_passes = real
        cut = progressive.load_state(ck)[1]
        res = cli.run(args)
    scene = compile_scene(load_scene_file(path, ["/res", f"{CLI_RES}x{CLI_RES}"]), device=dev)
    same = torch.equal(res.linear, render(scene, CLI_RES, CLI_RES, 4, rng.PRNGKey(7)))
    print(f"CLI /checkpoint demo-box {CLI_RES}x{CLI_RES} 16 spp: interrupted after pass {cut}, resumed "
          f"bit-equal to the in-process render (linear radiance): {same}")
    assert same and cut == 8


def timed_render(fn):
    """(image, wall seconds) of fn(), ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = fn()
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0


def multi_device_phase(phase, dev, card):
    """Phase 17: render_sharded and the mesh train step on cuda:0
    positions, in one process and split over two gloo processes, and
    dryrun_multichip(4). The timed renders run alone; then the
    two-process jobs and the dry run (each its own processes) run beside
    this process's half of the comparisons."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.parallel import make_mesh, render_sharded
    from plutracer_tpu_torch.parallel.dryrun import mesh_jobs, run_processes
    from plutracer_tpu_torch.parallel.mesh import initialize_distributed
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    phase("17 multi-device")
    demo = str(ROOT / "scenes" / "demo-box.urn")
    res, n = MESH_RENDER
    samples = res * res * n * n
    scene = compile_scene(load_scene_file(demo, ["/res", f"{res}x{res}"]), device=dev)
    key = rng.PRNGKey(7)
    # (a) a 1x1 mesh in an NCCL world of 1: the path's K1 + K2 launches; the
    # first render also creates the NCCL communicator, the second is warm
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/rendezvous", num_processes=1, process_id=0,
                               backend="nccl", timeout=300.0)
        try:
            mesh = make_mesh((1, 1), devices=[dev])
            assert mesh.distributed
            with counting():
                img_a, cold_a = timed_render(lambda: render_sharded(scene, res, res, n, key, mesh))
                launches = {"K1": launched("k1"), "K2": launched("k2")}
            _, wall_a = timed_render(lambda: render_sharded(scene, res, res, n, key, mesh))
        finally:
            dist.destroy_process_group()
    img_1, wall_1 = timed_render(
        lambda: render_sharded(scene, res, res, n, key, make_mesh((1, 1), devices=[dev])))
    _, wall_r = timed_render(lambda: render(scene, res, res, n, key))
    same_a = torch.equal(img_a, img_1)
    print(f"multi-device (a) demo-box {res}x{res} {n * n} spp on a 1x1 mesh in an NCCL world "
          f"of 1: launches {launches}; bit-equal to the mesh with no process group: {same_a}; "
          f"wall {wall_a:.4f} s ({samples / wall_a:.1f} samples/s; the first call, with the "
          f"communicator's set-up, {cold_a:.4f} s), no process group {wall_1:.4f} s "
          f"({samples / wall_1:.1f}), render {wall_r:.4f} s ({samples / wall_r:.1f}) ({card})")
    assert same_a and bool(torch.isfinite(img_a).all())
    assert launches["K1"] == n * n and launches["K2"] == n * n, launches
    # (b) the (2, 2) mesh of cuda:0 positions in this process
    mesh4 = make_mesh((2, 2), devices=[dev] * 4)
    with counting():
        img_b, wall_b = timed_render(lambda: render_sharded(scene, res, res, n, key, mesh4))
        k2_b = launched("k2")
    print(f"multi-device (b) the same render on a (2, 2) mesh of cuda:0 positions in one "
          f"process: {k2_b} K2 launches (two half-size strata a launch), wall {wall_b:.4f} s "
          f"({samples / wall_b:.1f} samples/s, {wall_b / wall_1:.3f}x the 1x1 mesh's) ({card})")
    # 4 positions, each n^2 / 2 strata of half the rows, two a launch
    assert k2_b == 4 * (n * n // 2) // 2, k2_b
    # (b), (d), (e) in two gloo processes sharing the card, and the dry run
    kres, kn = MESH_K3
    tres, tn = MESH_TRAIN
    job = dict(scene=demo, seed=7)
    rows = [dict(job, kind="render", res=[res, res], n=n, shape=[2, 2])]
    rows += [dict(job, kind="train", res=[tres, tres], n=tn, shape=[2, 2], loss_space=ls)
             for ls in ("log", "ab")]
    spp_job = [dict(job, kind="render", scene=str(ROOT / "scenes" / "mesh1.urn"),
                    res=[kres, kres], n=kn, shape=[1, 2])]
    card0 = f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        two = pool.submit(run_processes, rows, [[card0] * 2] * 2, timeout=600)
        two_k3 = pool.submit(run_processes, spp_job, [[card0]] * 2, timeout=600)
        # (f) the dry run on four cuda:0 positions (the card in turn)
        dry = pool.submit(subprocess.run, DRYRUN, cwd=str(ROOT), capture_output=True,
                          text=True, timeout=600)
        # (c) the (2, 2) mesh through the kernels against the plain backend
        cres, cn = MESH_CHECK
        small = compile_scene(load_scene_file(demo, ["/res", f"{cres}x{cres}"]), device=dev)
        kern = render_sharded(small, cres, cres, cn, key, mesh4)
        plain = render_sharded(small, cres, cres, cn, key, mesh4,
                               DEFAULT_OPTIONS.replace(integrator_backend="plain"))
        same_c = torch.equal(kern, plain)
        print(f"multi-device (c) demo-box {cres}x{cres} n = {cn} on the (2, 2) mesh, kernel path "
              f"bit-equal to the plain backend: {same_c}")
        single = mesh_jobs(rows[1:], [dev] * 4)
        single_k3 = mesh_jobs(spp_job, [dev] * 2)
        ranks, ranks_k3, dry = two.result(), two_k3.result(), dry.result()
    both_s = time.perf_counter() - t0
    same_b = all(np.array_equal(r["j0_image"], img_b.cpu().numpy()) for r in ranks)
    same_d = all(np.array_equal(r["j0_image"], single_k3["j0_image"]) for r in ranks_k3)

    def ranks_key(name):  # one process's job i is the two processes' job i + 1
        i, rest = name[1:].split("_", 1)
        return f"j{int(i) + 1}_{rest}"

    same_e = all(np.array_equal(r[ranks_key(k)], v) for r in ranks for k, v in single.items())
    print(f"multi-device (b) two gloo processes, a tiles row each: image bit-equal to one "
          f"process's: {same_b}")
    print(f"multi-device (d) mesh1 {kres}x{kres} {kn * kn} spp on a (1, 2) mesh (K3), one "
          f"process and two bit-equal: {same_d}")
    print(f"multi-device (e) demo-box {tres}x{tres} n = {tn}, one train step each of log and ab "
          f"on the (2, 2) mesh: parameters, Adam's state and loss bit-equal between one process "
          f"and two: {same_e}; losses {float(single['j0_loss'])}, {float(single['j1_loss'])}")
    for line in dry.stdout.strip().splitlines():
        print(f"multi-device (f) {line}")
    print(f"multi-device: the two-process jobs (processes' start-up included), the dry run "
          f"and (c)-(e) in this process, side by side: {both_s:.4f} s ({card})")
    assert same_c and same_b and same_d and same_e
    assert np.isfinite(single["j0_loss"]) and np.isfinite(single["j1_loss"])
    assert dry.returncode == 0 and "phase-2 ok" in dry.stdout, dry.stdout[-2000:] + dry.stderr[-3000:]


def tools_phase(phase, dev, card):
    """Phase 18: term_dump on the card, render_image."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.tonemap import postprocess_image
    from plutracer_tpu_torch.render.renderer import render, render_image
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.tools import term_dump

    phase("18 tools")
    demo = str(ROOT / "scenes" / "demo-box.urn")
    res = TERMS_RES
    with tempfile.TemporaryDirectory() as tmp:
        out = term_dump.main([demo, str(pathlib.Path(tmp) / "demo"), "--res", str(res),
                              "--smp", "2", "--device", dev.type])
    scene = compile_scene(load_scene_file(demo, ["/res", f"{res}x{res}", "/smp", "2"]), device=dev)
    ref = render(scene, res, res, 2, rng.PRNGKey(0)).cpu().numpy()
    top = float(np.abs(ref).max())
    lin_err = float(np.abs(out["linear"] - ref).max())
    print(f"tools: term_dump demo-box {res}x{res} n = 2 on {dev}: max |sum(terms) - L| "
          f"{out['self_check']:.3e} (bound 1e-5 x {top:.4f}); the linear image (float64 sum of "
          f"the plain passes) against render's (float32 sum, K1 + K2) max diff {lin_err:.3e} "
          f"(bound 1e-6 x {top:.4f})")
    assert out["self_check"] <= 1e-5 * top and lin_err <= 1e-6 * top
    img = render_image(scene, res, res, 2, seed=0)
    same = torch.equal(img, postprocess_image(render(scene, res, res, 2, rng.PRNGKey(0))))
    print(f"tools: render_image bit-equal to postprocess_image(render): {same}")
    assert same


def traced_ray_color(scene, o, d, u, options):
    """The ray_color_plain with CUDA events around every closest-hit query
    (intersect.query_lite: the primary hit, then one batched query a
    bounce) and around the whole. Returns (radiance, [(found, prim, t)] by
    query, [ms] by query, whole ms)."""
    from plutracer_tpu_torch.ops import intersect
    from plutracer_tpu_torch.render.integrator import ray_color_plain

    calls, query = [], intersect.query_lite
    event = lambda: torch.cuda.Event(enable_timing=True)

    def timed(*args):
        a, b = event(), event()
        a.record()
        out = query(*args)
        b.record()
        calls.append((out, a, b))
        return out

    start, end = event(), event()
    intersect.query_lite = timed
    try:
        start.record()
        L = ray_color_plain(scene, o, d, u, options)
        end.record()
    finally:
        intersect.query_lite = query
    torch.cuda.synchronize()
    return (L, [out for out, _, _ in calls], [a.elapsed_time(b) for _, a, b in calls],
            start.elapsed_time(end))


def cloud_with_area_light(n):
    """sphere_cloud(n) (its point light) with one area light added: an
    emitting sphere of radius 2 above the cloud."""
    from plutracer_tpu_torch.scene.loader import sphere_cloud
    from plutracer_tpu_torch.scene.types import (
        LIGHT_AREA, MAT_EMISSION, PRIM_SPHERE, LightDesc, MaterialDesc, PrimDesc,
    )

    desc = sphere_cloud(n, seed=0)
    f32 = lambda *v: np.array(v, np.float32)
    pid = desc.add_prim(PrimDesc(PRIM_SPHERE, a=f32(0.0, 15.0, 0.0), b=f32(2.0, 0.0, 0.0),
                                 material=desc.add_material(MaterialDesc(MAT_EMISSION))))
    desc.prims[pid].light = desc.add_light(LightDesc(LIGHT_AREA, intensity=np.full(3, 50.0, np.float32),
                                                     prim=pid))
    return desc


def filled_demo_box(dev, res, extra):
    """demo-box with unused materials appended until K2's shared-memory
    copy of its tables holds K2_SMEM_MAX bytes, within one row (extra = 0:
    K2 with 48 KB of tables), or one material row more (extra = 1: K3)."""
    import dataclasses

    from plutracer_tpu_torch.render.integrator import K2_SMEM_MAX, k2_smem_bytes
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    s = compile_scene(load_scene_file(str(ROOT / "scenes" / "demo-box.urn"), ["/res", f"{res}x{res}"]),
                      device=dev)
    n = (K2_SMEM_MAX - k2_smem_bytes(s)) // 48 + extra  # a material row is 48 bytes
    grow = lambda x: torch.cat([x, x[:1].expand(n, *x.shape[1:])])
    return dataclasses.replace(s, **{f: grow(getattr(s, f)) for f in
                                     ("mat_type", "mat_color", "mat_tex", "mat_eta", "mat_k")})


def tree_leaves(x):
    """The tensors of a nest of dicts, lists, tuples and NamedTuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tree_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tree_leaves(v)]
    return []


def routing_phase(phase, dev, card):
    """Phase 19: the routing layer. (a) ray_color_plain under each
    intersect_backend on a mesh1 and a demo-box stratum: every query's
    winners equal across the backends, radiance bit-equal, each query site
    and the whole timed; (b) a mesh1 128x128 train step (log loss, n = 2)
    under "pallas" and "bvh": loss, gradients, parameters and Adam's leaves
    bit-equal, times and launches; (c) the scenes past the JAX package's
    TPU caps: the CLI's route and samples/s, the kernel bit-equal to the
    ray_color_plain on a stratum and the plain stratum's time, K5 on the
    atlas scene; K2 at its 48 KB of shared memory and a scene one row
    past it (K3); the sphere cloud past 2^20 primitives: compile seconds
    and one K3 launch bit-equal to plain; K4 and K5 on both K3-tier
    scenes against ray_color_plain and ray_color_plain(debug=True). Returns
    the K3 query's launches in (b)'s "bvh" loss_and_grads."""
    from plutracer_tpu_torch import cli, rng
    from plutracer_tpu_torch.diff.optim import Adam
    from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_kernel
    from plutracer_tpu_torch.parallel import sharded
    from plutracer_tpu_torch.render.integrator import (
        k2_smem_bytes, kernel_tier, ray_color_plain, resolve_integrator_backend,
    )
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.scene.compile import compile_numpy, scene_from_numpy
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS as OPTS

    phase("19 routing")
    by = lambda b: OPTS.replace(intersect_backend=b)
    load = lambda name, w, h=None: compile_scene(load_scene_file(
        str(ROOT / "scenes" / f"{name}.urn"), ["/res", f"{w}x{h or w}"]), device=dev)

    # (a) the plain path's queries under each backend, one stratum
    for name, res in ROUTE_QUERY:
        scene = load(name, res)
        o, d, u = main_path_rays(scene, res, res, 2, rng.PRNGKey(7), 1, OPTS)
        runs = {}
        for b in INTERSECT_BACKENDS:
            if b != "xla":  # warm: the kernels are built; "xla" runs once (seconds)
                ray_color_plain(scene, o, d, u, by(b))
            runs[b] = traced_ray_color(scene, o, d, u, by(b))
        L0, q0, _, _ = runs["pallas"]
        for b, (L, q, ms, whole) in runs.items():
            assert len(q) == len(q0) == OPTS.max_bounces + 1, (b, len(q))
            for i, (x, y) in enumerate(zip(q, q0)):
                for what, a, c in (("found", x[0], y[0]), ("prim", x[1], y[1]),
                                   ("t on hits", x[2][y[0]], y[2][y[0]])):
                    assert torch.equal(a, c), f"{name} {b} query {i}: {what} differs on " \
                                              f"{(a != c).sum().item()} rays"
            same = torch.equal(L, L0)
            print(f"routing (a) {name} {res}x{res} stratum (B={o.shape[0]}, P={scene.num_prims}) "
                  f"intersect_backend={b}: every query's winners (found, prim) and t on hits "
                  f"equal to pallas's; radiance bit-equal {same} (largest difference "
                  f"{(L - L0).abs().max().item():.3e}); ray_color_plain {whole:.4f} ms, queries "
                  f"{sum(ms):.4f} ms: primary {ms[0]:.4f}, by bounce (3 x B rays) "
                  f"{[round(x, 4) for x in ms[1:]]} ({card})")
            assert same, f"{name} {b}: radiance differs"
        del runs

    # (b) a mesh1 train step under "pallas" and "bvh"
    W = ROUTE_TRAIN
    mesh1 = load("mesh1", W)
    target = render(mesh1, W, W, 2, rng.PRNGKey(11))  # K3
    tflat = target.reshape(-1, 3)
    true = sharded.get_params(mesh1)
    init = dict(true)
    init["mat_color"] = true["mat_color"] * 0.5
    key = rng.fold_in(rng.PRNGKey(0), 0)
    got, steps, query_launches = {}, {}, 0
    for b in ("pallas", "bvh"):
        step = steps[b] = sharded.make_train_step(mesh1, W, W, 2, optimizer=Adam(3e-2),
                                                  options=by(b), loss_space="log")
        state = step.init(init)
        with counting():
            loss, grads, nf = step.loss_and_grads(init, tflat, key, 0)
            params, new_state = step.apply(init, state, grads, nf)
            torch.cuda.synchronize()
            launches = {"K1": launched("k1"), "K3 query": launched("k1_bvh")}
        print(f"routing (b) mesh1 {W}x{W} log train step, n = 2, intersect_backend={b}: loss "
              f"{float(loss):.9g}, non-finite {float(nf)}; launches in one loss_and_grads "
              f"{launches}")
        assert launches["K1" if b == "pallas" else "K3 query"] > 0
        assert launches["K3 query" if b == "pallas" else "K1"] == 0, launches
        query_launches += launches["K3 query"]
        got[b] = (loss, grads, params, new_state)
    # the two steps timed in turns (pallas, bvh, bvh, pallas), CUDA events
    parts = {b: {"step": [], "loss_and_grads": [], "forward": []} for b in steps}
    state = steps["pallas"].init(init)
    for _ in range(2):
        for b in ("pallas", "bvh", "bvh", "pallas"):
            step = steps[b]
            parts[b]["step"].append(time_ms(lambda: step(init, state, tflat, key, 0), 1, 0))
            lg, fwd = loss_and_grads_ms(sharded, lambda: step.loss_and_grads(init, tflat, key, 0))
            parts[b]["loss_and_grads"].append(lg)
            parts[b]["forward"].append(fwd)
    for b, part in parts.items():
        med = {k: statistics.median(v) for k, v in part.items()}
        print(f"routing (b) intersect_backend={b} (medians of 4 in turns): step {med['step']:.4f} "
              f"ms, loss_and_grads {med['loss_and_grads']:.4f} ms = forward {med['forward']:.4f} "
              f"+ backward {med['loss_and_grads'] - med['forward']:.4f}; readings step "
              f"{[round(x, 2) for x in part['step']]}, forward "
              f"{[round(x, 2) for x in part['forward']]} ({card})")
    for what, x, y in zip(("loss", "gradients", "parameters", "Adam's state"), *got.values()):
        xs, ys = tree_leaves(x), tree_leaves(y)
        assert len(xs) == len(ys) and xs, what
        assert all(torch.equal(a, c) for a, c in zip(xs, ys)), f"train step: {what} differ"
    print(f"routing (b): loss, every gradient ({len(tree_leaves(got['bvh'][1]))} fields), the "
          f"parameters and Adam's {len(tree_leaves(got['bvh'][3]))} leaves bit-equal between "
          "pallas and bvh")
    del mesh1, target, got

    # (c) scenes past the TPU caps: the CLI's route, kernel against plain
    def kernel_vs_plain(scene, o, d, u, what):
        tier = kernel_tier(scene, OPTS)
        with counting():
            out = ray_color_kernel(scene, o, d, u, OPTS)
            assert launched(tier) == 1, what
        lanes_equal(out, ray_color_plain(scene, o, d, u, OPTS), f"routing (c) {what} {tier} vs "
                                                          f"ray_color_plain, one stratum")
        k_ms = time_ms(lambda: ray_color_kernel(scene, o, d, u, OPTS), reps=5)
        p_ms = time_ms(lambda: ray_color_plain(scene, o, d, u, OPTS), reps=1, warmup=0)
        print(f"routing (c) {what}: one stratum (B={o.shape[0]}) {tier} {k_ms:.4f} ms, plain "
              f"ray_color_plain {p_ms:.4f} ms ({p_ms / k_ms:.1f}x) ({card})")
        return tier

    def k4_k5_vs_plain(scene, o, d, u, what):
        # K4 (the wavefront loop under stream_wavefront) and K5 (K3's debug
        # launch) on a K3-tier scene: one call each, counts set to 0 just
        # before, each against its plain version on every lane
        wf = OPTS.replace(stream_wavefront=True)
        assert kernel_tier(scene, wf) == "k4", what
        with counting():
            L4 = ray_color_kernel(scene, o, d, u, wf)
            L5, dbg = ray_color_kernel(scene, o, d, u, OPTS, debug=True)
            torch.cuda.synchronize()
            got = {"K4": launched("k4"), "K5": launched("k3_debug")}
        assert got == {"K4": OPTS.max_bounces, "K5": 1}, (what, got)
        ref_L, ref = ray_color_plain(scene, o, d, u, OPTS, debug=True)
        lanes_equal(L4, ref_L, f"routing (c) {what} K4 (stream_wavefront) vs ray_color_plain")
        lanes_equal(L5, ref_L, f"routing (c) {what} K5 radiance vs ray_color_plain(debug=True)")
        channel_report(dbg, ref, f"{what} (K3)", stream=True)
        k4_ms = time_ms(lambda: ray_color_kernel(scene, o, d, u, wf), reps=3)
        print(f"routing (c) {what}: launches {got}; K4 wavefront loop (B={o.shape[0]}) "
              f"{k4_ms:.4f} ms ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        for name in BEYOND_CAPS:
            with counting():
                res = cli.run([str(ROOT / "scenes" / f"{name}.urn"),
                               "/o", str(pathlib.Path(tmp) / "o.bmp"), "/seed", "7"])
                launches = {k: launched(k.lower()) for k in ("K2", "K3", "K1")}
            h, w = res.linear.shape[:2]
            n = load_scene_file(str(ROOT / "scenes" / f"{name}.urn")).samples
            scene = load(name, w, h)
            assert res.integrator == "kernel" and res.tier == kernel_tier(scene, OPTS), res.tier
            assert torch.isfinite(res.linear).all()
            print(f"routing (c) {name} {w}x{h} {n * n} spp through the CLI: the kernel integrator "
                  f"({res.tier}), M={scene.mat_type.shape[0]}, T={scene.tex_type.shape[0]}, "
                  f"L={scene.num_lights}, atlas {scene.atlas.shape[0]} texels, K2 shared memory "
                  f"{k2_smem_bytes(scene)} bytes; launches {launches}; render "
                  f"{res.render_seconds:.3f} s, samples/s {w * h * n * n / res.render_seconds:.1f} "
                  f"({card})")
            o, d, u = main_path_rays(scene, w, h, n, rng.PRNGKey(7), 1, OPTS)
            kernel_vs_plain(scene, o, d, u, name)
            if name == "textured256":  # K5 on the 65,536-texel atlas
                L5, dbg = ray_color_kernel(scene, o, d, u, OPTS, debug=True)
                ref_L, ref = ray_color_plain(scene, o, d, u, OPTS, debug=True)
                lanes_equal(L5, ref_L, "routing (c) K5 textured256 radiance vs ray_color_plain(debug=True)")
                channel_report(dbg, ref, "textured256 (K2)")
    for extra, what in ((0, "K2 with 48 KB of tables"),
                        (1, "one material past K2's shared memory (K3)")):
        scene = filled_demo_box(dev, FILLED_RES, extra)
        assert kernel_tier(scene, OPTS) == ("k2", "k3")[extra], what
        o, d, u = main_path_rays(scene, FILLED_RES, FILLED_RES, 2, rng.PRNGKey(7), 1, OPTS)
        what = f"demo-box + {scene.mat_type.shape[0] - 8} materials, {what}"
        kernel_vs_plain(scene, o, d, u, what)
        if extra:
            k4_k5_vs_plain(scene, o, d, u, what)
    # the sphere cloud past 2^20 primitives, with one area light
    t0 = time.perf_counter()
    desc = cloud_with_area_light(CLOUD_P)
    t1 = time.perf_counter()
    leaves = compile_numpy(desc)
    t2 = time.perf_counter()
    cloud = scene_from_numpy(leaves).to(dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    assert cloud.num_prims == CLOUD_P + 1 and resolve_integrator_backend(cloud, OPTS, dev) == "kernel"
    print(f"routing (c) sphere cloud P={cloud.num_prims} (point + area light): description "
          f"{t1 - t0:.2f} s, compile (host) {t2 - t1:.2f} s, to the card {t3 - t2:.2f} s; walk "
          f"depth {leaves['walk_depth']}, {cloud.walk_nodes.shape[0]} records ({card})")
    o, d, u = main_path_rays(cloud, CLOUD_RES, CLOUD_RES, 1, rng.PRNGKey(7), 1, OPTS)
    assert kernel_vs_plain(cloud, o, d, u, f"sphere cloud {CLOUD_RES}x{CLOUD_RES}") == "k3"
    k4_k5_vs_plain(cloud, o, d, u, f"sphere cloud {CLOUD_RES}x{CLOUD_RES}")
    return query_launches


def api_phase(phase, dev, card):
    """Phase 20: the scene-level API on the card. (a) query_closest under
    each engine on a stratum's camera rays and a bounce's extension rays
    (demo-box 512x512, mesh2 256x256): found and prim equal, t, p, norm,
    uv and dpdu bit-equal on hits, the gradient of sum(hit.p) with respect
    to prim_a bit-equal between "pallas" and "bvh", each query timed; (b)
    bvh_closest (the reference tree's lockstep skip-link traversal, plain
    torch) on mesh1's 65,536 camera rays against K1 and the K3 query:
    winners equal, t equal on hits, its steps and time; (c) estimate_direct
    at demo-box's and tables' 512x512 primary hits, one light drawn a ray,
    under each engine with shading_normal_le_gate on and off: bit-equal;
    (d) render.ray_color(scene, o, d, key), the JAX package's call, on
    demo-box 512x512 (K1 + K2) and mesh1 256x256 (K3) strata: one kernel
    launch, bit-equal to ray_color_plain on draw_uniforms(key)'s uniforms;
    (e) render.elastic.pass_stack(scene, key, strata, w, h, n, options,
    mesh) on a (1, 1) mesh of the card (demo-box 256x256, 16 strata): each
    row bit-equal to that stratum's render_passes, and the rows summed in
    stratum order over spp bit-equal to render_elastic's image.
    Returns the K1 and K3-query launches of (a) and (c)'s API calls (the
    counts set to 0 just before each, read just after)."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops import bsdf, tables, texture
    from plutracer_tpu_torch.ops.bvh import bvh_closest
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit, closest_hit_bvh
    from plutracer_tpu_torch.ops.intersect import query_closest
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.parallel.sharded import _deterministic
    from plutracer_tpu_torch.render.integrator import estimate_direct
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS as OPTS

    phase("20 scene-level API")
    by = lambda b, **kw: OPTS.replace(intersect_backend=b, **kw)
    load = lambda name, res: compile_scene(load_scene_file(
        str(ROOT / "scenes" / f"{name}.urn"), ["/res", f"{res}x{res}"]), device=dev)
    counters = {"K1": "k1", "K3 query": "k1_bvh"}
    made = {k: 0 for k in counters}

    def counted(fn):
        with counting():
            out = fn()
            torch.cuda.synchronize()
            for k, c in counters.items():
                made[k] += launched(c)
        return out

    def query_and_grad(scene, o, d, b):
        a = scene.prim_a.clone().requires_grad_(True)
        with _deterministic():
            h = query_closest(dataclasses.replace(scene, prim_a=a), o, d, by(b))
            (g,) = torch.autograd.grad(h.p.sum(), a)
        return h, g

    # (a) query_closest under each engine
    for name, res, engines in API_QUERY:
        scene = load(name, res)
        o, d, _ = main_path_rays(scene, res, res, 2, rng.PRNGKey(7), 1, OPTS)
        f0, _, t0 = closest_hit(scene.prims_packed, o, d, scene.packed_type_rows)
        ext = (o + d * torch.where(f0, t0, 1.0)[:, None],
               uniform_sphere_sample(rng.uniform(rng.PRNGKey(99), (o.shape[0], 2), dev)))
        for rays, (ro, rd) in (("camera", (o, d)), ("extension", ext)):
            got = {b: counted(lambda: query_and_grad(scene, ro, rd, b)) for b in engines}
            h0, g0 = got["pallas"]
            f = h0.found
            for b, (h, g) in got.items():
                assert torch.equal(h.found, f) and torch.equal(h.prim[f], h0.prim[f]), (name, b)
                for field in ("t", "p", "norm", "uv", "dpdu"):
                    x, y = getattr(h, field)[f], getattr(h0, field)[f]
                    assert torch.equal(x, y), f"{name} {rays} {b}: {field} differs on " \
                                              f"{(x != y).reshape(x.shape[0], -1).any(-1).sum().item()} hits"
            g_bvh = got["bvh"][1]
            assert g0.abs().max() > 0 and torch.equal(g_bvh, g0), f"{name} {rays}: gradient differs"
            ms = {b: time_ms(lambda: query_closest(scene, ro, rd, by(b)), reps=3, warmup=1)
                  for b in engines}
            print(f"api (a) query_closest {name} {res}x{res} {rays} rays (B={ro.shape[0]}, "
                  f"P={scene.num_prims}), engines {list(engines)}: found, prim, t, p, norm, uv, "
                  f"dpdu bit-equal on hits (hit fraction {f.double().mean().item():.4f}); "
                  f"d sum(p) / d prim_a bit-equal pallas vs bvh; ms "
                  + ", ".join(f"{b} {v:.4f}" for b, v in ms.items()) + f" ({card})")
        del scene, got

    # (b) bvh_closest over the reference's tree against both kernels
    mesh1 = load("mesh1", API_BVH_RES)
    o, d, _ = main_path_rays(mesh1, API_BVH_RES, API_BVH_RES, 2, rng.PRNGKey(7), 1, OPTS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    f, p, t, steps = bvh_closest(mesh1, mesh1.bvh, o, d, count=True)
    end.record()
    torch.cuda.synchronize()
    bvh_ms = start.elapsed_time(end)
    for who, want in (("K1", closest_hit(mesh1.prims_packed, o, d, mesh1.packed_type_rows)),
                      ("K3 query", closest_hit_bvh(mesh1, o, d))):
        assert torch.equal(f, want[0]) and torch.equal(p[f], want[1][f]), who
        assert torch.equal(t[f], want[2][f]), who
    k1_ms = time_ms(lambda: closest_hit(mesh1.prims_packed, o, d, mesh1.packed_type_rows), reps=5)
    q_ms = time_ms(lambda: closest_hit_bvh(mesh1, o, d), reps=5)
    print(f"api (b) bvh_closest mesh1 {API_BVH_RES}x{API_BVH_RES} camera rays (B={o.shape[0]}, "
          f"P={mesh1.num_prims}, {mesh1.bvh.num_nodes} nodes): winners and t on hits equal to K1's "
          f"and the K3 query's (hit fraction {f.double().mean().item():.4f}); {steps} lockstep "
          f"steps, {bvh_ms:.4f} ms ({bvh_ms / steps:.4f} ms a step); K1 {k1_ms:.4f} ms, K3 query "
          f"{q_ms:.4f} ms ({card})")
    del mesh1

    # (c) estimate_direct at the primary hit under each engine, both gates
    for name in API_DIRECT:
        scene = load(name, API_DIRECT_RES)
        o, d, _ = main_path_rays(scene, API_DIRECT_RES, API_DIRECT_RES, 2, rng.PRNGKey(7), 1,
                                 OPTS)
        B = o.shape[0]
        h = query_closest(scene, o, d)
        packed = tables.pack_tables(scene)
        mat = tables.gather_prim(packed, h.prim).material
        u = rng.uniform(rng.PRNGKey(3), (B, 8), dev)
        li = torch.clamp((u[:, 7] * scene.num_lights).to(torch.int32), max=scene.num_lights - 1)
        args = (scene, h, bsdf.make_frame(h.norm, h.dpdu), tables.gather_mat(packed, mat).mtype,
                texture.eval_color(scene, mat, h.uv), -d, li, u)
        for gate in (False, True):
            out, ms = {}, {}
            for b in INTERSECT_BACKENDS:
                opts = by(b, shading_normal_le_gate=gate)
                out[b] = counted(lambda: estimate_direct(*args, opts))
                ms[b] = time_ms(lambda: estimate_direct(*args, opts), reps=2, warmup=0)
            L0 = out["pallas"]
            assert torch.isfinite(L0).all() and L0.abs().max() > 0, name
            for b, L in out.items():
                assert torch.equal(L, L0), f"{name} gate={gate} {b}: differs on " \
                                           f"{(L != L0).any(-1).sum().item()} rays"
            print(f"api (c) estimate_direct {name} {API_DIRECT_RES}x{API_DIRECT_RES} primary hits "
                  f"(B={B}, L={scene.num_lights}), shading_normal_le_gate={gate}: bit-equal "
                  f"under {list(INTERSECT_BACKENDS)} (lit rays "
                  f"{(L0.abs().amax(-1) > 0).double().mean().item():.4f}); ms "
                  + ", ".join(f"{b} {v:.4f}" for b, v in ms.items()) + f" ({card})")
        del scene
    print(f"api: launches of the API calls {made}")
    assert made["K1"] > 0 and made["K3 query"] > 0, made

    # (d) render.ray_color(scene, o, d, key): the kernel tier, bit-equal to
    # the plain integrator on the key's uniforms
    from plutracer_tpu_torch import render as render_pkg
    from plutracer_tpu_torch.render.integrator import draw_uniforms, ray_color_plain

    key = rng.PRNGKey(11)
    for name, res, kernel in API_RAY_COLOR:
        kernel = kernel.lower()
        scene = load(name, res)
        o, d, _ = main_path_rays(scene, res, res, 2, rng.PRNGKey(7), 1, OPTS)
        with counting():
            got = render_pkg.ray_color(scene, o, d, key)
            torch.cuda.synchronize()
            assert launched(kernel) == 1, (name, launched(kernel))
        u = draw_uniforms(key, o.shape[0], OPTS.max_bounces, dev)
        lanes_equal(got, ray_color_plain(scene, o, d, u, OPTS),
                    f"api (d) render.ray_color(scene, o, d, key) {name} {res}x{res} vs "
                    "ray_color_plain on draw_uniforms(key)")
        ms = time_ms(lambda: render_pkg.ray_color(scene, o, d, key), reps=3, warmup=1)
        print(f"api (d) render.ray_color {name} {res}x{res} (B={o.shape[0]}): {ms:.4f} ms, "
              f"uniforms and the kernel ({card})")
        del scene, o, d, u, got

    # (e) pass_stack on a (1, 1) mesh of the card against render_passes and
    # render_elastic
    from plutracer_tpu_torch.parallel.mesh import make_mesh
    from plutracer_tpu_torch.render.elastic import pass_stack, render_elastic
    from plutracer_tpu_torch.render.renderer import render_passes

    res, n = API_PASS_STACK
    scene = load("demo-box", res)
    key = rng.PRNGKey(7)
    rows = pass_stack(scene, key, range(n * n), res, res, n, OPTS,
                      make_mesh((1, 1), devices=[dev]))
    assert rows.shape == (n * n, res * res, 3) and rows.dtype == np.float32, rows.shape
    for s in range(n * n):
        want = render_passes(scene, key, s, res, res, n, 1).cpu().numpy()
        assert np.array_equal(rows[s], want), f"api (e) pass_stack row {s} differs"
    acc = np.zeros((res * res, 3), np.float32)
    for r in rows:
        acc = acc + r
    img = (acc / np.float32(n * n)).reshape(res, res, 3)
    assert np.array_equal(img, render_elastic(scene, res, res, n, 7, devices=[dev]))
    print(f"api (e) pass_stack demo-box {res}x{res} {n * n} strata on a (1, 1) mesh of {dev}: "
          f"each row bit-equal to its stratum's render_passes, the stratum-order sum over "
          f"spp bit-equal to render_elastic")
    return made


def loss_and_grads_ms(sharded, fn):
    """(ms, forward-trace ms) of one call of fn, a train step's
    loss_and_grads: CUDA events around the call and around each call of
    the step's trace_launch inside it."""
    events = []
    trace = sharded.trace_launch

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = trace(*args)
        end.record()
        events.append((start, end))
        return out

    sharded.trace_launch = timed
    try:
        total = time_ms(fn, 1, 0)
    finally:
        sharded.trace_launch = trace
    return total, sum(s.elapsed_time(e) for s, e in events)


@contextlib.contextmanager
def plain_draws():
    """rng.uniform_block_words drawing with its plain twin on every device:
    the pass loop's, the train step's (eager and captured: only device
    ops, so the plain draw is captured as R1 is) and render_sharded's
    draws as they were before R1 (eager int64 tensor ops), for
    bit-equality checks."""
    from plutracer_tpu_torch import rng

    real = rng.uniform_block_words
    rng.uniform_block_words = lambda words, n: rng.uniform_block_plain(
        words.to(torch.int64) & 0xFFFFFFFF, n, words.device)
    try:
        yield
    finally:
        rng.uniform_block_words = real


def card_words(table: torch.Tensor, dev) -> torch.Tensor:
    """A (K, 2) int64 table of uint32 key words on `dev` as the int32 bit
    patterns R1 reads, sent as every launch's are (rng.device_words)."""
    from plutracer_tpu_torch import rng

    return rng.device_words(table.numpy().astype(np.uint32).view(np.int32), dev)


def same_tree(a, b) -> bool:
    """Two results (tensors, arrays, numbers, and dicts, tuples and lists
    of them) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def int32_rate():
    """(32-bit integer operations a second, max SM MHz, SMs):
    INT32_OPS_A_CLOCK an SM a clock at the card's maximum SM clock
    (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_A_CLOCK * sms * mhz * 1e6, mhz, sms


def r1_bound(K: int, n: int):
    """(bound ms, "bytes" or "operations") of an R1 block of K keys and n
    words a key: the output written once and the keys read once, against
    R1_WORD_OPS INT32 operations a word at int32_rate()."""
    rate, mhz, sms = int32_rate()
    t_bytes = (K * n * 4 + K * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = K * n * R1_WORD_OPS / rate * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), mhz, sms


def r2_bound(rays: int, pixels: int, lens: bool):
    """(bound ms, "bytes" or "operations") of an R2 launch of `rays` rays
    over `pixels` pixel positions: the largest of its bytes (o and d
    written, the positions and the camera table read once) over HBM's
    rate, its jitter's integer operations (R2_RAY_WORDS threefry words a
    ray of R1_WORD_OPS each) at int32_rate(), and its float32 operations
    (R2_RAY_OPS a ray) over FP32_OPS_PER_S."""
    t_bytes = (rays * R2_RAY_BYTES + pixels * 8 + 17 * 4) / HBM_BYTES_PER_S * 1e3
    t_int = rays * R2_RAY_WORDS[lens] * R1_WORD_OPS / int32_rate()[0] * 1e3
    t_fp = rays * R2_RAY_OPS[lens] / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= max(t_int, t_fp) else (max(t_int, t_fp),
                                                                   "operations")


def r1_times(keys, n, what, card, reps=20):
    """(kernel-only ms, wrapper ms, plain ms, bound) of an R1 block: the
    kernel's device time a launch from torch.profiler, CUDA events around
    calls of rng.uniform_block (the key words' copy, the checks, the
    launch) and of the plain version."""
    from torch.profiler import ProfilerActivity, profile

    from plutracer_tpu_torch import rng

    dev = torch.device("cuda")
    table = rng.key_table(keys)
    call = lambda: rng.uniform_block(table, n, dev)
    wrapper = time_ms(call, reps)
    plain = time_ms(lambda: rng.uniform_block_plain(table, n, dev), reps=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if any(k in ev.key for k in R1_KERNELS)]
    dev_us = sum(getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
                 for ev in evs)
    kernel = dev_us / 1e3 / sum(ev.count for ev in evs) if dev_us > 0 else wrapper
    how = "torch.profiler" if dev_us > 0 else "the profiler recorded none: wrapper time"
    bound, mhz, sms = r1_bound(table.shape[0], n)
    print(f"R1 time {what} ({table.shape[0]} keys x {n} words): kernel-only {kernel:.4f} ms "
          f"({how}), wrapper {wrapper:.4f} ms a call, plain {plain:.4f} ms; bound "
          f"{bound[0]:.6f} ms ({bound[1]}; {sms} SMs at {mhz:.0f} MHz) ({card})")
    return kernel, wrapper, plain, bound


def rng_phase(phase, dev, card, main_launches):
    """Phase 21: R1 against its plain version, bit for bit, at the main
    paths' shapes and past them; its times; renders, a train step and
    render_sharded through R1 against the same with plain-drawn
    uniforms. Returns R1's kernels-line entry (launches: main_launches,
    the CLI renders' of phases 5 and 10)."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.cuda.rng_kernel import uniform_block_words
    from plutracer_tpu_torch.parallel import make_mesh, render_sharded, sharded
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    phase("21 R1 threefry")
    mb = DEFAULT_OPTIONS.max_bounces
    base = rng.key_words(rng.PRNGKey(7))

    def launch_tables(strata, B):
        """(path keys, jitter keys, path words a key, jitter words a key) of
        a pass-loop launch of `strata` strata of B rays (renderer.launch_words'
        keys; R2 draws the jitter words itself)."""
        trip = [rng.split_words(rng.fold_in_words(base, j), 3) for j in range(strata)]
        path = [rng.fold_in_words(t[2], i) for i in range(mb) for t in trip]
        return path, [t[0] for t in trip] + [t[1] for t in trip], 12 * B, 2 * B

    demo = launch_tables(1, 512 * 512)
    mesh1 = launch_tables(4, 256 * 256)
    cases = [
        ("demo-box 512x512 stratum: path uniforms (8, 262,144, 12)", demo[0], demo[2]),
        ("demo-box 512x512 stratum: jitter (2, 262,144, 2)", demo[1], demo[3]),
        ("mesh1 256x256 launch of 4 strata: path uniforms (8, 4 x 65,536, 12)", mesh1[0],
         mesh1[2]),
        ("mesh1 256x256 launch of 4 strata: jitter (2, 4, 65,536, 2)", mesh1[1], mesh1[3]),
    ]
    for B in R1_RAGGED:
        keys, jit, n_path, n_jit = launch_tables(1, B)
        cases += [(f"ragged B={B}: path uniforms", keys, n_path),
                  (f"ragged B={B}: jitter", jit, n_jit),
                  (f"ragged B={B}: one key, B words", keys[:1], B)]
    for K, n in R1_BIG:
        cases.append((f"{K} key(s) x {n} words (past 2^24)", demo[0][:K], n))
    for what, keys, n in cases:
        table = rng.key_table(keys)
        with counting():
            before = launched("r1")
            got = uniform_block_words(card_words(table, dev), n)
            assert launched("r1") == before + 1, what  # one launch a call
        want = rng.uniform_block_plain(table, n, dev)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (table.shape[0], n), what
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        assert differ == 0, f"R1 vs plain ({what}): {differ} words differ"
        print(f"R1 {what}: {table.shape[0] * n} words bit-equal to plain, mean "
              f"{got.double().mean().item():.6f}")
        del got, want
    r1_ms, _, r1_plain_ms, bound = r1_times(demo[0], demo[2], "demo-box stratum path uniforms",
                                           card)
    r1_times(demo[1], demo[3], "demo-box stratum jitter", card)
    r1_times(mesh1[0], mesh1[2], "mesh1 launch path uniforms", card)
    r1_times(mesh1[1], mesh1[3], "mesh1 launch jitter", card)

    # the path through R1 against plain-drawn uniforms, bit for bit
    def load(name, res):
        return compile_scene(load_scene_file(str(ROOT / "scenes" / f"{name}.urn"),
                                             ["/res", f"{res}x{res}"]), device=dev)

    for name, res, n in (("demo-box", 512, 2), ("mesh1", 256, 4)):
        sc = load(name, res)
        with counting():
            img = render(sc, res, res, n, rng.PRNGKey(7))
            torch.cuda.synchronize()
            made = launched("r1")
            with plain_draws():
                ref = render(sc, res, res, n, rng.PRNGKey(7))
            assert launched("r1") == made and made > 0, (name, made)
        assert torch.equal(img, ref), f"{name}: the render through R1 differs from plain draws"
        print(f"R1 {name} {res}x{res} {n * n} spp render: bit-equal to plain-drawn uniforms, "
              f"R1 launches {made}")
        del sc, img, ref
    sc = load("demo-box", TRAIN_RES)
    target = render(sc, TRAIN_RES, TRAIN_RES, 2, rng.PRNGKey(11))
    params = sharded.get_params(sc)
    step = sharded.make_train_step(sc, TRAIN_RES, TRAIN_RES, 2, loss_space="log",
                                   trainable=("mat_color",))
    with counting():
        got = step.loss_and_grads(params, target.reshape(-1, 3), rng.PRNGKey(3), 1)
        torch.cuda.synchronize()
        made = launched("r1")
        with plain_draws():
            want = step.loss_and_grads(params, target.reshape(-1, 3), rng.PRNGKey(3), 1)
        assert made > 0 and launched("r1") == made, made
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), "train step loss"
    for f in got[1]:
        assert torch.equal(got[1][f], want[1][f]), f"train step gradient {f}"
    print(f"R1 demo-box {TRAIN_RES}x{TRAIN_RES} log train step: loss {got[0].item():.6f} and "
          f"gradients bit-equal to plain-drawn uniforms, R1 launches {made}")

    def captured_steps():
        """Three steps of a new step (captured at its first call, replayed):
        its draws from the key words on the card (R1's table entry)."""
        fresh = sharded.make_train_step(sc, TRAIN_RES, TRAIN_RES, 2, loss_space="log",
                                        trainable=("mat_color",))
        return fresh.many(params, fresh.init(params), target.reshape(-1, 3), rng.PRNGKey(3),
                          0, 3)

    with counting():
        got = captured_steps()
        torch.cuda.synchronize()
        made = launched("r1")
        with plain_draws():
            want = captured_steps()
        assert made > 0 and launched("r1") == made and replays() == 6, (made, replays())
    assert same_tree(got, want), "the captured train step through R1 differs from plain draws"
    print(f"R1 demo-box {TRAIN_RES}x{TRAIN_RES} log train step, captured, 3 replays: parameters, "
          f"Adam's state and losses {got[2].tolist()} bit-equal to the same captured with "
          f"plain-drawn uniforms, R1 launches {made} (the warm-up's and the capture's)")
    mesh = make_mesh((1, 1), devices=[dev])
    with counting():
        img = render_sharded(sc, TRAIN_RES, TRAIN_RES, 2, rng.PRNGKey(5), mesh)
        torch.cuda.synchronize()
        made = launched("r1")
    with plain_draws():
        ref = render_sharded(sc, TRAIN_RES, TRAIN_RES, 2, rng.PRNGKey(5), mesh)
    assert made > 0 and torch.equal(img, ref), made
    print(f"R1 render_sharded demo-box {TRAIN_RES}x{TRAIN_RES} 4 spp on a 1x1 mesh: bit-equal "
          f"to plain-drawn uniforms, R1 launches {made}")
    return entry("R1 threefry uniforms (ms: kernel-only, a demo-box 512x512 stratum's path "
                 "uniforms (8, 262,144, 12); launches: the CLI renders of demo-box, mesh1 and "
                 "mesh2)", R1_SOURCE, R1_REPLACES, main_launches, 0.0, r1_ms, r1_plain_ms, bound)


LAUNCH_RES = 64  # phase 22's renders: demo-box and mesh1 at 64x64, n = 2
ENTRY_REPS = 10000  # phase 22: empty entries of the launch helper timed


@contextlib.contextmanager
def checked_launches():
    """Phase 22: every entry of build.on_device (each kernel launch) goes
    through the real helper (and its entry count) and checks that the
    device it made current is the tensors' device; yields the device
    index of each entry."""
    from plutracer_tpu_torch.ops.cuda import build

    real = build.on_device
    seen = []

    @contextlib.contextmanager
    def on_device(dev):
        with real(dev) as stream:
            want = torch.device(dev)
            want = torch.cuda.current_device() if want.index is None else want.index
            assert torch.cuda.current_device() == want, (torch.cuda.current_device(), dev)
            seen.append(want)
            yield stream

    build.on_device = on_device
    try:
        yield seen
    finally:
        build.on_device = real


def launch_devices_phase(phase, card):
    """Phase 22: (a) over a small render (K1, K2, R1, R2), a batched mesh1
    launch (K3), a K4 wavefront render, the K3 query, K5 and an R1 block,
    the launch helper's entries equal the sum of the wrappers' launch
    counters (K1's plan inside its launch's entry), and in each launch
    the current device is the tensors'; the helper's own cost. (b) with
    two cards or more: render_elastic over [cuda:0, cuda:1], a (2, 1) mesh
    over them in one process and K1's split path with cuda:1's tensors,
    each bit-equal to the same on cuda:0 alone, launched while cuda:0 is
    current."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.cuda import build
    from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_kernel
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit, closest_hit_plain
    from plutracer_tpu_torch.ops.intersect import query_lite
    from plutracer_tpu_torch.parallel import make_mesh, render_sharded
    from plutracer_tpu_torch.render.elastic import render_elastic
    from plutracer_tpu_torch.render.integrator import draw_uniforms
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.ops.tables import _rows, pack_tables
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
    from plutracer_tpu_torch.utils import profiling

    phase("22 launch devices")
    res, n = LAUNCH_RES, 2
    cuda0 = torch.device("cuda", 0)

    def load(name, dev, w=res):
        return compile_scene(load_scene_file(str(ROOT / "scenes" / f"{name}.urn"),
                                             ["/res", f"{w}x{w}"]), device=dev)

    counters = ("k1", "k1_bvh", "k2", "k2_debug", "k3", "k3_debug", "k4", "r1", "r2", "g1")
    demo, mesh1 = load("demo-box", cuda0), load("mesh1", cuda0)
    o = torch.zeros((1024, 3), device=cuda0)
    g = torch.Generator().manual_seed(22)
    d = torch.nn.functional.normalize(torch.randn((1024, 3), generator=g), dim=-1).to(cuda0)
    with counting(), checked_launches() as seen:
        render(demo, res, res, n, rng.PRNGKey(3))  # K1 + K2 + R1 + R2
        render(mesh1, res, res, n, rng.PRNGKey(3))  # K3 (the strata batched) + R1 + R2
        render(mesh1, res, res, n, rng.PRNGKey(3), DEFAULT_OPTIONS.replace(stream_wavefront=True))
        query_lite(mesh1, o, d, DEFAULT_OPTIONS.replace(intersect_backend="bvh"))  # K3 query
        u = draw_uniforms(rng.PRNGKey(4), 1024, DEFAULT_OPTIONS.max_bounces, cuda0)  # R1
        ray_color_kernel(demo, o, d, u, DEFAULT_OPTIONS, debug=True)  # K1 + K5 (K2's)
        ray_color_kernel(mesh1, o, d, u, DEFAULT_OPTIONS, debug=True)  # K5 (K3's)
        table = pack_tables(demo).mat.clone().requires_grad_(True)
        torch.autograd.grad(_rows(table, o[:, 0].long()).sum(), table)  # G1
        torch.cuda.synchronize()
        entries = profiling.counter("device_entries")
        counts = {f"launches.{k}": launched(k) for k in counters}
    total = sum(counts.values())
    print(f"launch devices (a): helper entries {entries}, wrappers' launches {total} {counts}; "
          f"current device = the tensors' in {len(seen)} launches")
    assert entries == total == len(seen) and all(counts.values()), (entries, counts)
    assert set(seen) == {0}, set(seen)
    # the helper's cost: entries of an empty block on the current card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENTRY_REPS):
        with build.on_device(cuda0):
            pass
    entry_us = (time.perf_counter() - t0) / ENTRY_REPS * 1e6
    print(f"launch devices (a): one entry of build.on_device (the card already current) "
          f"{entry_us:.3f} us, host clock, mean of {ENTRY_REPS} ({card})")

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"launch devices (b): not run: {cards} card (needs 2)")
        return
    cuda1 = torch.device("cuda", 1)
    torch.cuda.set_device(cuda0)
    with checked_launches() as seen:
        one = render_elastic(demo, res, res, n, 7, devices=[cuda0])
        two = render_elastic(demo, res, res, n, 7, devices=[cuda0, cuda1])
        mesh_one = render_sharded(demo, res, res, n, rng.PRNGKey(7),
                                  make_mesh((2, 1), devices=[cuda0] * 2))
        mesh_two = render_sharded(demo, res, res, n, rng.PRNGKey(7),
                                  make_mesh((2, 1), devices=[cuda0, cuda1]))
        # a ray tile of mesh0's camera rays: the table split across blocks
        mesh0 = {dev: load("mesh0", dev, 256) for dev in (cuda0, cuda1)}
        ro, rd, _ = main_path_rays(mesh0[cuda0], 256, 256, 1, rng.PRNGKey(7), 1, DEFAULT_OPTIONS)
        ro, rd = ro[:256].cpu(), rd[:256].cpu()
        hits = {dev: closest_hit(mesh0[dev].prims_packed, ro.to(dev), rd.to(dev),
                                 mesh0[dev].packed_type_rows) for dev in mesh0}
        torch.cuda.synchronize(cuda0)
        torch.cuda.synchronize(cuda1)
    want = closest_hit_plain(mesh0[cuda0].prims_packed.cpu(), ro, rd)
    same_k1 = all(torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), c)
                  for a, b, c in zip(hits[cuda0], hits[cuda1], want))
    same_elastic = np.array_equal(one, two)
    same_mesh = torch.equal(mesh_one, mesh_two.to(mesh_one.device))
    print(f"launch devices (b) with cuda:0 current: render_elastic demo-box {res}x{res} "
          f"n = {n} over [cuda:0, cuda:1] bit-equal to [cuda:0]: {same_elastic}; a (2, 1) mesh "
          f"over cuda:0 and cuda:1 in one process bit-equal to two cuda:0 positions: "
          f"{same_mesh}; K1 split path (mesh0, 256 rays) on cuda:1 bit-equal to cuda:0 and "
          f"to plain: {same_k1}; launches on cuda:1 {seen.count(1)} of {len(seen)}")
    assert same_elastic and same_mesh and same_k1 and seen.count(1) > 0


@contextlib.contextmanager
def plain_camera():
    """renderer.launch_rays_table computing with camera_rays_table_plain on
    every device: the pass loop's, the train step's (eager and captured:
    only device ops, so the twin is captured as R2 is) and the sharded
    and elastic renders' camera rays as they were before R2, for
    bit-equality checks."""
    from plutracer_tpu_torch.render import renderer

    real = renderer.launch_rays_table
    renderer.launch_rays_table = lambda scene, px0, table, n: renderer.camera_rays_table_plain(
        scene.camera, px0, table, n)
    try:
        yield
    finally:
        renderer.launch_rays_table = real


@contextlib.contextmanager
def no_eager_camera():
    """Fail if the plain camera stage's eager ops run
    (renderer.generate_rays, which camera_rays_table_plain calls)."""
    from plutracer_tpu_torch.render import renderer

    real = renderer.generate_rays

    def refuse(*_args):
        raise AssertionError("an eager camera op ran on the card")

    renderer.generate_rays = refuse
    try:
        yield
    finally:
        renderer.generate_rays = real


def r2_equal(o, d, po, pd, what):
    """R2's rays against the plain twin's, every lane bit for bit (int32
    views: signed zeros and NaN payloads count). Returns the largest
    difference (0.0)."""
    torch.cuda.synchronize()
    differ = [int((a.view(torch.int32) != b.view(torch.int32)).any(-1).sum())
              for a, b in ((o, po), (d, pd))]
    print(f"R2 {what}: {o.shape[0]} rays, lanes differing o {differ[0]}, d {differ[1]} (bound: "
          f"none); finite {bool(torch.isfinite(o).all() and torch.isfinite(d).all())}")
    assert differ == [0, 0], f"R2 vs plain ({what}): {differ} lanes differ"
    return max((o - po).abs().max().item(), (d - pd).abs().max().item())


def r2_rows(keys, strata, dev) -> torch.Tensor:
    """The (S, 5) int32 rows R2 reads on the card: launch_words of the
    strata's keys and cells with no bounces, sent by rng.device_words."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.render.renderer import launch_words

    return rng.device_words(launch_words(keys, strata, 0), dev).view(len(strata), -1)


def r2_times(scene, px0, table, n, what, card, reps=50):
    """(kernel-only ms, wrapper ms, plain ms, bound) of an R2 launch: the
    kernel's device time a launch from torch.profiler, CUDA events around
    calls of launch_rays_table (the checks, the output's allocation, the
    launch) and of camera_rays_table_plain (the plain jitter draw and the
    eager ops); the bound from the bytes this launch moves and its rays'
    integer and float operations."""
    from torch.profiler import ProfilerActivity, profile

    from plutracer_tpu_torch.render.renderer import camera_rays_table_plain, launch_rays_table

    call = lambda: launch_rays_table(scene, px0, table, n)
    wrapper = time_ms(call, reps)
    plain = time_ms(lambda: camera_rays_table_plain(scene.camera, px0, table, n), reps=10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if any(k in ev.key for k in R2_KERNELS)]
    dev_us = sum(getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
                 for ev in evs)
    kernel = dev_us / 1e3 / sum(ev.count for ev in evs) if dev_us > 0 else wrapper
    how = "torch.profiler" if dev_us > 0 else "the profiler recorded none: wrapper time"
    S = table.shape[0]
    lens = bool(scene.camera.lens_radius.item() > 0.0)
    bound = r2_bound(S * px0.shape[0], px0.shape[0], lens)
    print(f"R2 time {what} ({S} strata x {px0.shape[0]} pixels, "
          f"{'lens' if lens else 'pinhole'}): kernel-only {kernel:.4f} ms ({how}), wrapper "
          f"{wrapper:.4f} ms a call, plain {plain:.4f} ms; bound {bound[0]:.6f} ms ({bound[1]}) "
          f"({card})")
    return kernel, wrapper, plain, bound


def camera_phase(phase, dev, card, main_launches):
    """Phase 23: R2 (its rows, read on the card, to rays) against
    camera_rays_table_plain (the plain jitter draw, then the eager ops) on
    every lane at the main paths' launches, the most strata a launch
    takes, the train cell's Cornell stratum and ragged B; its times;
    renders, eager and captured train steps and the sharded and elastic
    renders through R2 against the same with the plain camera rays, one
    R2 launch a pass-loop launch (as many as R1's) and no eager camera
    op. Returns R2's kernels-line entry (launches: main_launches, the CLI
    renders' of phases 5 and 10)."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.parallel import make_mesh, render_sharded, sharded
    from plutracer_tpu_torch.render.elastic import render_elastic
    from plutracer_tpu_torch.render.renderer import (
        camera_rays_table_plain, launch_rays_table, pixel_centers, render,
    )
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    phase("23 R2 camera rays")
    base = rng.key_words(rng.PRNGKey(7))

    def load(name, w, h):
        return compile_scene(load_scene_file(str(scene_file(name)), ["/res", f"{w}x{h}"]),
                             device=dev)

    err, times = 0.0, {}
    for name, (w, h), S, n in R2_CASES:
        sc = load(name, w, h)
        # the cells out of order: 5j + 3 mod n^2 (a permutation at S = n^2)
        strata = [(5 * j + 3) % (n * n) for j in range(S)]
        table = r2_rows([rng.fold_in_words(base, j) for j in range(S)], strata, dev)
        for B in (w * h, 1, 127, w * h - RAGGED):
            what = f"{name} {w}x{h}, {S} strata, B={B}"
            px0 = pixel_centers(w, h, dev)[:B].contiguous()
            with counting():
                before = launched("r2")
                o, d = launch_rays_table(sc, px0, table, n)
                assert launched("r2") == before + 1  # one launch a call
            err = max(err, r2_equal(o, d, *camera_rays_table_plain(sc.camera, px0, table, n),
                                    what))
        times[(name, S)] = r2_times(sc, pixel_centers(w, h, dev), table, n, f"{name} {w}x{h}",
                                    card)
        del sc, px0, o, d

    def through_r2(what, run, path_launches=None, replayed=0):
        """run() through R2 (counted, no eager camera op) and with the plain
        camera rays; the outputs bit-equal; one R2 launch a pass-loop launch
        (as many as the R1 launches, and path_launches where given), and
        `replayed` captured train steps replayed."""
        with counting():
            with no_eager_camera():
                got = run()
            torch.cuda.synchronize()
            made, draws, replays_made = launched("r2"), launched("r1"), replays()
            with plain_camera():
                want = run()
            assert launched("r2") == made and made > 0, (what, made)
        assert made == draws and replays_made == replayed, (what, made, draws, replays_made)
        if path_launches is not None:
            assert made == path_launches, (what, made, path_launches)
        assert same_tree(got, want), what
        print(f"R2 {what}: bit-equal to the plain camera rays, R2 launches {made} (R1 {draws}), "
              f"{replays_made} replays, no eager camera op")

    for name, w, h, n in R2_RENDERS:
        sc = load(name, w, h)
        through_r2(f"{name} {w}x{h} {n * n} spp render", lambda: render(sc, w, h, n,
                                                                          rng.PRNGKey(7)))
        del sc
    sc = load("demo-box", TRAIN_RES, TRAIN_RES)
    target = render(sc, TRAIN_RES, TRAIN_RES, 2, rng.PRNGKey(11)).reshape(-1, 3)
    params = sharded.get_params(sc)
    for loss_space, traced in (("log", 1), ("ab", 2)):
        step = sharded.make_train_step(sc, TRAIN_RES, TRAIN_RES, 2, loss_space=loss_space,
                                       trainable=("mat_color", "light_intensity"))
        through_r2(f"demo-box {TRAIN_RES}x{TRAIN_RES} {loss_space} train step (loss, gradients)",
                   lambda: step.loss_and_grads(params, target, rng.PRNGKey(3), 1), traced)

        # the captured step (a new one a run: each captures at its first call),
        # one step and a many of 3: R2 in its warm-up and its capture, and
        # nothing launched by the replays
        def captured(k, loss_space=loss_space):
            fresh = sharded.make_train_step(sc, TRAIN_RES, TRAIN_RES, 2, loss_space=loss_space,
                                            trainable=("mat_color", "light_intensity"))
            state = fresh.init(params)
            if k == 1:
                return fresh(params, state, target, rng.PRNGKey(3), 1)
            return fresh.many(params, state, target, rng.PRNGKey(3), 0, k)

        for k in (1, 3):
            through_r2(f"demo-box {TRAIN_RES}x{TRAIN_RES} {loss_space} train step captured, "
                       f"{k} replay(s) (parameters, Adam's state, loss)", lambda: captured(k),
                       2 * traced, k)
    mesh = make_mesh((1, 1), devices=[dev])
    through_r2(f"render_sharded demo-box {TRAIN_RES}x{TRAIN_RES} 4 spp on a 1x1 mesh",
               lambda: render_sharded(sc, TRAIN_RES, TRAIN_RES, 2, rng.PRNGKey(5), mesh), 1)
    through_r2(f"render_elastic demo-box {TRAIN_RES}x{TRAIN_RES} 4 spp on [{dev}]",
               lambda: render_elastic(sc, TRAIN_RES, TRAIN_RES, 2, 5, devices=[dev]), 1)
    for (name, S), (kernel, wrapper, plain, bound) in times.items():
        print(f"R2 {name} launch of {S} strata: kernel-only / bound {kernel / bound[0]:.4f}, "
              f"plain / wrapper {plain / wrapper:.4f} ({card})")
    r2_ms, _, r2_plain_ms, bound = times[("demo-box", 1)]
    return entry("R2 camera stage, jitter and rays (ms: kernel-only, a demo-box 512x512 "
                 "stratum; launches: the CLI renders of demo-box, mesh1 and mesh2)", R2_SOURCE,
                 R2_REPLACES, main_launches, err, r2_ms, r2_plain_ms, bound)


def g1_case(B, R, W, dev, seed=5):
    """B rays' rows (half among the first three, so rows repeat) and a
    gradient of mixed magnitudes with some -0.0 entries."""
    g = torch.Generator().manual_seed(seed + B + R * W)
    idx = torch.randint(0, R, (B,), generator=g)
    idx[: B // 2] = torch.randint(0, min(R, 3), (B // 2,), generator=g)
    grad = torch.randn((B, W), generator=g) * 10.0 ** torch.randint(-3, 3, (B, 1), generator=g)
    grad[torch.rand((B, W), generator=g) < 0.05] = -0.0
    return idx.to(dev), grad.to(dev)


def g1_bound(B, R, W):
    """(bound ms, "bytes" or "operations") of a G1 call: each ray's index
    and W floats read once, the table's gradient written once; one add a
    value."""
    return work_bound(B * (8 + 4 * W) + R * W * 4, B * W)


def g1_times(idx, grad, shape, what, card, reps=50):
    """(kernel-only ms, wrapper ms, twin ms, library ms, bound, max |G1 -
    twin|) of G1 at one shape, its output asserted bit-equal (int32
    views) to the plain twin's: the kernels' device time a call from
    torch.profiler (a sorted call's sort excluded), CUDA events around
    calls of the wrapper (its sort included), of the plain twin and of
    torch's index_put_(accumulate=True) under deterministic algorithms
    (the backward G1 replaces: its sort, then a warp a run of equal
    rows)."""
    from torch.profiler import ProfilerActivity, profile

    from plutracer_tpu_torch.ops.cuda.row_grad_kernel import row_grad_cuda, row_grad_plain
    from plutracer_tpu_torch.parallel.sharded import _deterministic

    call = lambda: row_grad_cuda(idx, grad, shape)
    got, want = call(), row_grad_plain(idx, grad, shape)
    err = (got - want).abs().max().item()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"G1 {what}: not bit-equal to its twin (max |diff| {err})")
    wrapper = time_ms(call, reps)
    twin = time_ms(lambda: row_grad_plain(idx, grad, shape), reps=3, warmup=1)
    with _deterministic():
        zeros = torch.zeros(shape, device=grad.device)
        library = time_ms(lambda: zeros.clone().index_put_((idx,), grad, accumulate=True),
                          reps=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if any(k in ev.key for k in G1_KERNELS)]
    dev_us = sum(getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
                 for ev in evs)
    kernel = dev_us / 1e3 / sum(ev.count for ev in evs) if dev_us > 0 else wrapper
    how = "torch.profiler" if dev_us > 0 else "the profiler recorded none: wrapper time"
    bound = g1_bound(idx.numel(), shape[0], grad.numel() // max(idx.numel(), 1))
    print(f"G1 time {what}: kernel-only {kernel:.4f} ms ({how}), wrapper {wrapper:.4f} ms a "
          f"call, twin {twin:.4f} ms, library (torch's deterministic index_put_) "
          f"{library:.4f} ms; bound {bound[0]:.6f} ms ({bound[1]}); bit-equal to the twin, "
          f"max |diff| {err} ({card})")
    return kernel, wrapper, twin, library, bound, err


def row_grad_phase(phase, dev, card):
    """Phase 24: G1 bit-equal to its plain twin at every width, one and
    many chunks and tiles of sorted rays, the same bits over three calls;
    bit-equal again and timed at the Cornell train step's shapes and on
    prim fields (G1_FIELDS), beside the twin's, torch's deterministic
    index_put_'s and the bound; a log
    train step's G1 launches, its bits twice from one state and G1's
    device time in it. Returns
    G1's kernels-line entry (launches: those of one Cornell box 512x512
    log step, n = 2, the benchmark's train mix)."""
    from torch.profiler import ProfilerActivity, profile

    from plutracer_tpu_torch.ops.cuda.row_grad_kernel import row_grad_cuda, row_grad_plain
    from plutracer_tpu_torch.parallel import sharded
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch import rng

    phase("24 G1 row gradient")
    for B, R, W in G1_CASES:
        idx, grad = g1_case(B, R, W, dev)
        shape = (R,) if W == 1 else (R, W)
        grad = grad.reshape((B,) + shape[1:])
        with counting():
            got = [row_grad_cuda(idx, grad, shape) for _ in range(3)]
            assert launched("g1") == (3 if B else 0)
        want = row_grad_plain(idx, grad, shape)
        same = all(torch.equal(g.view(torch.int32), want.view(torch.int32)) for g in got)
        assert same, f"G1 (B, R, W) = {(B, R, W)}: not bit-equal to its twin"
    print(f"G1: bit-equal to row_grad_plain (int32 views) on {len(G1_CASES)} shapes, three "
          "calls each")
    cornell = compile_scene(load_scene_file(str(ROOT / "benchmark" / "scenes" /
                                                "cornell-box.urn")), device=dev)
    B = 512 * 512
    times = {}
    for name, W in G1_TIMED:
        R = {"mat": cornell.mat_type.shape[0], "light": cornell.light_type.shape[0]}[name]
        idx, grad = g1_case(B, R, W, dev)
        times[name] = g1_times(idx, grad, (R, W), f"{name} table ({R}, {W}), B = {B}", card)
    for R, W in G1_FIELDS:
        idx, grad = g1_case(B, R, W, dev)
        g1_times(idx, grad, (R, W), f"prim field ({R}, {W}), B = {B}", card, reps=10)

    target = render(cornell, 512, 512, 2, rng.PRNGKey(11)).reshape(-1, 3)
    params = dict(sharded.get_params(cornell))
    step = sharded.make_train_step(cornell, 512, 512, 2, loss_space="log",
                                   trainable=("mat_color", "light_intensity"))
    with counting():
        got = step.loss_and_grads(params, target, rng.PRNGKey(3), 1)
        made = launched("g1")
    again = step.loss_and_grads(params, target, rng.PRNGKey(3), 1)
    same = torch.equal(got[0], again[0]) and all(torch.equal(got[1][f], again[1][f])
                                                 for f in got[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step.loss_and_grads(params, target, rng.PRNGKey(3), 1)
        torch.cuda.synchronize()
    records = [e for e in prof.profiler.kineto_results.events()  # kernels, copies, fills:
               if "CUDA" in str(e.device_type()) and not e.name().startswith("plu.")]  # no spans
    ms = lambda evs: sum(e.duration_ns() for e in evs) / 1e6
    g1_ms = ms(e for e in records if any(k in e.name() for k in G1_KERNELS))
    print(f"G1 in a Cornell box 512x512 log step (n = 2, albedo and emission): {made} launches; "
          f"loss and gradients bit-equal from one state twice: {same}; G1's device time "
          f"{g1_ms:.4f} ms of the step's {ms(records):.4f} ms of device records "
          f"(torch.profiler) ({card})")
    assert made == 24 and same
    kernel, wrapper, twin, library, bound, err = times["mat"]
    e = entry("G1 row_grad (ms: kernel-only, the Cornell material table (M, 12), B = 512^2)",
              G1_SOURCE, G1_REPLACES, made, err, kernel, twin, bound)
    e["library_ms"] = library
    return e


if __name__ == "__main__":
    sys.exit(main())
