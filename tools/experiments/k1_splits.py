"""Times K1 (csrc/closest_hit.cu) with the table split across 1, 2, 4, 8
and 16 blocks, on one NVIDIA GPU, beside the split count its launch plan
(``plu_closest_hit_plan``) picks.

    python3 tools/experiments/k1_splits.py

Shapes: camera rays of demo-box and sphere-grid at 512x512 (262,144),
mesh0 and mesh1 at 256x256 (65,536), mesh1's camera rays with extension
directions, mesh1 at 4 strata (262,144), mesh2 at 256x256. Each split
count's answer is held bit-equal to closest_hit_plain on the first 2,048
rays. CUDA events around back-to-back
raw launches into preallocated outputs; the card's SM clock, power draw
and temperature after each shape (nvidia-smi). Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
SPLITS = (1, 2, 4, 8, 16)
CHECK_RAYS = 2048


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_splits: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line, main_path_rays
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.cuda import build
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_plain
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    lib = build.load().lib
    key = rng.PRNGKey(7)
    card = card_line()
    cases = []
    for name, w, n, strata in (("demo-box", 512, 8, 1), ("sphere-grid", 512, 4, 1),
                               ("mesh0", 256, 4, 1), ("mesh1", 256, 4, 1), ("mesh1", 256, 4, 4),
                               ("mesh2", 256, 4, 1)):
        s = compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"),
                                          ["/res", f"{w}x{w}"]), device="cuda")
        o, d, _ = main_path_rays(s, w, w, n, key, strata, DEFAULT_OPTIONS)
        cases.append((f"{name} camera", s, o.contiguous(), d.contiguous()))
        if name == "mesh1" and strata == 1:
            e = uniform_sphere_sample(rng.uniform(rng.fold_in(key, 99), (o.shape[0], 2), "cuda"))
            cases.append(("mesh1 camera origins, extension directions", s, o.contiguous(),
                          e.contiguous()))
    for what, s, o, d in cases:
        B, P = o.shape[0], s.prims_packed.shape[0]
        tiles = ctypes.c_int(0)
        plan = lib.plu_closest_hit_plan(P, B, ctypes.byref(tiles))
        t = torch.empty(B, device="cuda")
        p = torch.empty(B, dtype=torch.int32, device="cuda")
        f = torch.empty(B, dtype=torch.bool, device="cuda")
        want = closest_hit_plain(s.prims_packed, o[:CHECK_RAYS], d[:CHECK_RAYS])
        ms = {}
        for sp in SPLITS:
            pt = torch.empty(sp * B, device="cuda")
            pk = torch.empty(sp * B, dtype=torch.int32, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            ar = build.arrivals(o.device, tiles.value, stream)

            def call():
                build.check(lib.plu_closest_hit(
                    s.prims_packed.data_ptr(), P, s.packed_type_rows[0], s.packed_type_rows[1],
                    o.data_ptr(), d.data_ptr(), t.data_ptr(), p.data_ptr(), f.data_ptr(), B, sp,
                    pt.data_ptr(), pk.data_ptr(), ar.data_ptr(), stream), "plu_closest_hit")

            call()
            torch.cuda.synchronize()
            got = (f[:CHECK_RAYS], p[:CHECK_RAYS], t[:CHECK_RAYS])
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (what, sp)
            reps = 3 if B * P > 2e9 else 10
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                call()
            b.record()
            torch.cuda.synchronize()
            ms[sp] = round(a.elapsed_time(b) / reps, 4)
        print(f"K1 {what} (B={B}, rows {P}, {tiles.value} ray tiles): the plan's splits {plan}; "
              f"ms by splits {ms}; equal to plain on the first {CHECK_RAYS} rays; clock, power, "
              f"temperature {smi()} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
