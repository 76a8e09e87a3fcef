"""Times, on one NVIDIA GPU, the brute-force closest hit (K1) alone and the
wavefront loop of a package whose loop reorders a (16, B) carry on the
host (the loop before the lane-major carry), split by stage.

    python3 tools/experiments/carry_loop_split.py ROOT

ROOT holds that package (``plutracer_tpu_torch/`` with the host-side
``wavefront.reorder``, for example unpacked with ``git archive`` into an
ignored directory). It prints:

- K1 at the shapes the paths give it (demo-box's primary rays, a
  demo-box 256x256 train step's batched query, mesh1's extension and
  camera rays, mesh2's camera rays): the kernel's own device time from
  torch.profiler (``closest_hit_kernel``; "not recorded" if the profiler
  shows no device time) and the wrapper's time per call (CUDA events);
- the loop at the mesh1 launch of 4 strata of 256x256 (B = 262,144) for
  each sort, every stage between CUDA events: the primary hit, each
  reorder (key and sort, carry gather, uniform gather), each K4 launch by
  bounce, and the final scatter; means over PASSES passes;
- a stable argsort of B int32 keys against the cumsum partition of B
  flags (compact's two ways of ordering the lanes).

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
PASSES = 5
REPS = 20


def card_line():
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def events_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, name, reps):
    """Mean device milliseconds a launch of the kernels whose name holds
    `name`, from torch.profiler; None if the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            dev = getattr(ev, "device_time_total", None)
            if dev is None:
                dev = getattr(ev, "cuda_time_total", 0.0)
            total += dev
            n += ev.count
    # per recorded launch: the profiler may drop some of a run's records
    return total / 1e3 / n if n and total > 0 else None


def k1_shapes(dev):
    """{shape: (scene, o, d)} at the shapes the paths give K1; extension
    rays leave from their camera ray's first hit."""
    from chip_smoke import main_path_rays
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    key = rng.PRNGKey(7)

    def load(name, res):
        return compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"), ["/res", res]),
                             device=dev)

    def bounce(scene, o, d, copies, salt):
        f, _, t = closest_hit(scene.prims_packed, o, d)
        p = (o + d * torch.where(f, t, 1.0)[:, None]).repeat(copies, 1)
        return p, uniform_sphere_sample(rng.uniform(rng.fold_in(key, salt), (p.shape[0], 2), dev))

    out = {}
    demo = load("demo-box", "512x512")
    out["demo-box primary, B=262144"] = (demo, *main_path_rays(demo, 512, 512, 8, key, 1,
                                                               DEFAULT_OPTIONS)[:2])
    demo256 = load("demo-box", "256x256")
    o, d, _ = main_path_rays(demo256, 256, 256, 2, key, 1, DEFAULT_OPTIONS)
    # the plain vertex's batched query: shadow, NEE-BSDF and extension rays
    out["demo-box 256x256 train query, B=3x65536"] = (demo256, *bounce(demo256, o, d, 3, 98))
    mesh1 = load("mesh1", "256x256")
    o, d, _ = main_path_rays(mesh1, 256, 256, 4, key, 4, DEFAULT_OPTIONS)
    out["mesh1 extension, B=65536"] = (mesh1, *bounce(mesh1, o[:65536], d[:65536], 1, 99))
    out["mesh1 camera, B=262144"] = (mesh1, o, d)
    mesh2 = load("mesh2", "256x256")
    o, d, _ = main_path_rays(mesh2, 256, 256, 4, key, 1, DEFAULT_OPTIONS)
    out["mesh2 camera, B=65536"] = (mesh2, o, d)
    return out


def k1_times(dev, card):
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit

    for what, (scene, o, d) in k1_shapes(dev).items():
        o, d = o.contiguous(), d.contiguous()
        reps = 3 if scene.prims_packed.shape[0] * o.shape[0] > 2e9 else REPS
        call = lambda: closest_hit(scene.prims_packed, o, d)
        wrapper = events_ms(call, reps)
        kern = kernel_ms(call, "closest_hit_kernel", reps)
        print(f"K1 {what}, rows {scene.prims_packed.shape[0]}: kernel-only "
              f"{'not recorded' if kern is None else f'{kern:.4f} ms'} (torch.profiler), wrapper "
              f"{wrapper:.4f} ms a call ({card})")


def loop_split(dev, card):
    from chip_smoke import main_path_rays
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops import intersect
    from plutracer_tpu_torch.ops.cuda.stream_kernel import onebounce_cuda
    from plutracer_tpu_torch.ops.tables import pack_tables
    from plutracer_tpu_torch.render import wavefront as wf
    from plutracer_tpu_torch.render.integrator import PathState
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    mesh1 = compile_scene(load_scene_file(str(REPO / "scenes" / "mesh1.urn"), ["/res", "256x256"]),
                          device=dev)
    o, d, u = main_path_rays(mesh1, 256, 256, 4, rng.PRNGKey(7), 4, DEFAULT_OPTIONS)
    B, mb = o.shape[0], DEFAULT_OPTIONS.max_bounces
    for sort in wf.SORTS:
        opts = DEFAULT_OPTIONS.replace(stream_wavefront=True, stream_sort=sort)
        times = {}

        def stage(name, fn):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            r = fn()
            b.record()
            times.setdefault(name, []).append((a, b))
            return r

        for p in range(PASSES + 1):
            if p == 1:
                times.clear()
            tables = pack_tables(mesh1)
            found, prim, t = stage("primary hit (K1)", lambda: intersect.query_lite(mesh1, o, d))
            carry = stage("initial carry", lambda: wf.carry_of(PathState(
                o=o, d=d, T=torch.ones_like(o), L=torch.zeros_like(o),
                prev_spec=torch.zeros(B, dtype=torch.bool, device=dev),
                alive=torch.ones(B, dtype=torch.bool, device=dev), prim=prim, t=t)))
            us = u.permute(0, 2, 1)
            orig = torch.arange(B, device=dev)
            lo, hi = wf.scene_bounds(mesh1)
            for i in range(mb):
                if i > 0 and sort != "none":
                    perm = stage(f"reorder key+sort {i}", lambda: wf.reorder(carry, sort, lo, hi))
                    carry = stage(f"carry gather {i}", lambda: carry[:, perm])
                    orig = stage(f"orig gather {i}", lambda: orig[perm])
                ui = stage(f"uniform gather {i}", lambda: us[i][:, orig])
                carry = stage(f"K4 bounce {i}", lambda: onebounce_cuda(mesh1, tables, carry, ui, i, opts))
            L = torch.empty((B, 3), dtype=torch.float32, device=dev)

            def scatter():
                L[orig] = carry[9:12].T

            stage("final scatter", scatter)
        torch.cuda.synchronize()
        mean = {k: sum(a.elapsed_time(b) for a, b in v) / len(v) for k, v in times.items()}
        total = sum(mean.values())
        k4 = sum(v for k, v in mean.items() if k.startswith("K4"))
        print(f"loop split ({sort}, mesh1 B={B}): stages sum {total:.4f} ms, K4 launches {k4:.4f} ms, "
              f"host stages {total - k4:.4f} ms ({card})")
        for k, v in mean.items():
            print(f"  {sort} {k}: {v:.4f} ms")
        whole = events_ms(lambda: wf.ray_color_wavefront(mesh1, o, d, u, opts), 3, warmup=1)
        print(f"loop whole ({sort}): {whole:.4f} ms ({card})")
    g = torch.Generator(device="cpu").manual_seed(0)
    live = (torch.rand(B, generator=g) < 0.5).to(dev)
    key = torch.where(live, torch.randint(0, 2**30, (B,), generator=g).to(dev), 2**30).int()
    flags = torch.where(live, 0, 1).int()

    def partition():
        li = live.to(torch.int64)
        pos = torch.where(live, torch.cumsum(li, 0) - 1, li.sum() + torch.cumsum(1 - li, 0) - 1)
        return torch.empty(B, dtype=torch.int64, device=dev).scatter_(0, pos, torch.arange(B, device=dev))

    print(f"orderings at B={B}: stable argsort of int32 keys "
          f"{events_ms(lambda: torch.argsort(key, stable=True), REPS):.4f} ms, stable argsort of "
          f"0/1 keys {events_ms(lambda: torch.argsort(flags, stable=True), REPS):.4f} ms, cumsum "
          f"partition {events_ms(partition, REPS):.4f} ms ({card})")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("carry_loop_split: no CUDA device available", file=sys.stderr)
        return 1
    root = pathlib.Path(argv[0] if argv else REPO).resolve()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(root))
    import plutracer_tpu_torch

    assert pathlib.Path(plutracer_tpu_torch.__file__).is_relative_to(root), plutracer_tpu_torch
    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}; package {root}")
    k1_times(dev, card)
    loop_split(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
