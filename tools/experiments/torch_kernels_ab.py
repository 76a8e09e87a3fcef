"""A/B of the PyTorch/CUDA port's path kernels between two checkouts, on
one NVIDIA GPU.

    python3 tools/experiments/torch_kernels_ab.py EARLIER [--sweep]

EARLIER is a directory holding an earlier plutracer_tpu_torch/ (for
example unpacked from an earlier commit with ``git archive``). Each side
runs in a process of its own, with its own package, library build and C
interface, on the same inputs, drawn once by this checkout: K2 on a
demo-box 512x512 pass (with its K1 primary hit) and K5 there (K2's debug
launch), K3 on mesh1 and mesh2 256x256 at one stratum and at the pass
loop's 4 strata a launch and K5 on the mesh1 launch, the K3 query on
mesh1's extension rays, K1 at the shapes the paths give it (demo-box's
primary rays, a demo-box 256x256 train step's batched query, mesh1's
extension and camera rays, mesh2's camera rays; its kernel-only device
time from torch.profiler beside the wrapper's), and K4 under the wavefront
loop of the mesh1 4-strata launch (a launch, and the whole loop under
morton and none). The sides run in turns (earlier, new, new, earlier;
ROUNDS rounds); every output is held bit-equal between them (the query's
t on hits, NaN equal to NaN in K5's channels), and each kernel's readings
and mean are printed.
Then the mean node visits a walk of the skip-link tree (the walk K3 made
before its walk layout, ``tree_walk``) and of the walk layout
(walk_closest_plain), on WALK_RAYS camera and extension rays of mesh1 and
mesh2.

--sweep then builds copies of this checkout's package, each with K1's
threads a block and rays a thread from K1_SWEEP, or K4's threads a block
and __launch_bounds__ minimum blocks from K4_SWEEP (the constants
rewritten in the copy), prints each build's ptxas registers, stack and
spills, holds its outputs bit-equal to this checkout's and times its
kernels.

Exits non-zero on any difference, and without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
ROUNDS = 2
# K1: (threads a block, rays a thread)
K1_SWEEP = ((64, 1), (128, 1), (256, 1), (64, 2), (128, 2), (256, 2), (64, 4), (128, 4))
# K4: (threads a block, __launch_bounds__' minimum blocks an SM; 0: none)
K4_SWEEP = ((64, 0), (128, 0), (128, 1), (128, 2), (256, 1), (64, 4))
# the scenes a worker loads: key, scene, resolution
SCENES = (("demo-box", "demo-box", "512x512"), ("demo-box 256", "demo-box", "256x256"),
          ("mesh1", "mesh1", "256x256"), ("mesh2", "mesh2", "256x256"))
K1_CASES = ("demo-box primary", "demo-box train query", "mesh1 extension", "mesh1 camera",
            "mesh2 camera")
K1_KERNELS = ("closest_hit_kernel", "closest_hit_ring")
K3_CASES = ("mesh1 one stratum", "mesh1 4 strata", "mesh2 one stratum", "mesh2 4 strata")
WALK_RAYS = 16384  # rays of each set whose walks are counted (plain lockstep walks)


def k1_call(scene, o, d):
    """The side's K1 wrapper on the scene's table: with the type segments
    where the wrapper takes them."""
    import inspect

    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit

    if "type_rows" in inspect.signature(closest_hit).parameters:
        return closest_hit(scene.prims_packed, o, d, scene.packed_type_rows)
    return closest_hit(scene.prims_packed, o, d)


def load_scenes():
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    return {key: compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"), ["/res", res]),
                               device="cuda")
            for key, name, res in SCENES}


def make_inputs(path):
    """Rays and uniforms of every case, drawn as the pass loop draws them
    (chip_smoke.main_path_rays), saved on the CPU."""
    from chip_smoke import main_path_rays
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

    key = rng.PRNGKey(7)
    scenes = load_scenes()

    def bounce(scene, o, d, copies, salt):
        f, _, t = k1_call(scene, o, d)
        p = (o + d * torch.where(f, t, 1.0)[:, None]).repeat(copies, 1)
        return p.contiguous(), uniform_sphere_sample(
            rng.uniform(rng.fold_in(key, salt), (p.shape[0], 2), "cuda")).contiguous()

    x = {"demo-box": main_path_rays(scenes["demo-box"], 512, 512, 8, key, 1, DEFAULT_OPTIONS)}
    o, d, _ = main_path_rays(scenes["demo-box 256"], 256, 256, 2, key, 1, DEFAULT_OPTIONS)
    x["K1 demo-box primary"] = x["demo-box"][:2]
    x["K1 demo-box train query"] = bounce(scenes["demo-box 256"], o, d, 3, 98)
    for name in ("mesh1", "mesh2"):
        o, d, u = main_path_rays(scenes[name], 256, 256, 4, key, 4, DEFAULT_OPTIONS)
        B = 256 * 256
        x[f"{name} 4 strata"] = (o, d, u)
        x[f"{name} one stratum"] = (o[:B], d[:B], u[:, :B].contiguous())
        if name == "mesh1":
            x["query"] = bounce(scenes[name], o[:B], d[:B], 1, 99)
            x["K1 mesh1 extension"] = x["query"]
            x["K1 mesh1 camera"] = (o, d)
        else:
            x["K1 mesh2 camera"] = (o[:B].contiguous(), d[:B].contiguous())
    torch.save({k: tuple(t.cpu() for t in v) for k, v in x.items()}, path)


def kernel_ms(fn, reps):
    """Mean device milliseconds a launch of K1's kernels (torch.profiler);
    None if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if any(k in ev.key for k in K1_KERNELS)]
    us = sum(getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
             for ev in evs)
    # per recorded launch: the profiler may drop some of a run's records
    return us / 1e3 / sum(ev.count for ev in evs) if us > 0 else None


def tree_walk(scene, o, d):
    """The walk of K3 and its query before the walk layout, in plain torch:
    the skip-link tree (scene.bvh) in depth-first order, one packed row a
    leaf, the node boxes padded by bvh_helpers' margin. A leaf folds the
    lexicographic minimum of (t, packed row); an internal node is entered
    when the ray's LINE crosses its box (its subtree holds a sphere) or its
    [0, best t] overlaps it, and the walk goes to node + 1 or past the
    subtree to its skip. Returns (found, prim, nodes visited) per ray; rays
    advance in lockstep."""
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import _slab, row_ts
    from plutracer_tpu_torch.ops.intersect import T_MAX, _BIG
    from plutracer_tpu_torch.scene.compile import bvh_helpers

    h = bvh_helpers(scene.prim_type.cpu(), scene.bvh.to("cpu"))
    dev, B, N = o.device, o.shape[0], scene.bvh.num_nodes
    leaf_row = torch.from_numpy(h["leaf_row"]).long().to(dev)
    line = torch.from_numpy(h["line_only"]).to(dev)
    lo, hi = scene.bvh.node_min - h["margin"], scene.bvh.node_max + h["margin"]
    skip = scene.bvh.node_skip.long()
    rinv = 1.0 / torch.where(d == 0.0, 1e-20, d)
    node = torch.zeros(B, dtype=torch.long, device=dev)
    best_t = torch.full((B,), _BIG, device=dev)
    best_row = torch.full((B,), 2**31 - 1, dtype=torch.long, device=dev)
    visits = torch.zeros(B, dtype=torch.long, device=dev)
    walking = torch.arange(B, device=dev)
    while walking.numel():
        n = node[walking]
        row = leaf_row[n]
        leaf = row >= 0
        nxt = skip[n]
        visits[walking] += 1
        la, lr = walking[leaf], row[leaf]
        t = row_ts(scene.prims_packed[lr], o[la], d[la])
        bt, br = best_t[la], best_row[la]
        take = (t < bt) | ((t == bt) & (lr < br) & (t < _BIG))
        best_t[la], best_row[la] = torch.where(take, t, bt), torch.where(take, lr, br)
        ia, ni = walking[~leaf], n[~leaf]
        tmin, tmax = _slab(lo[ni], hi[ni], o[ia], rinv[ia])
        enter = torch.where(line[ni], ~(tmax < tmin),
                            ~(tmax < torch.clamp(tmin, min=0.0)) & ~(tmin > best_t[ia]))
        nxt[~leaf] = torch.where(enter, ni + 1, nxt[~leaf])
        node[walking] = nxt
        walking = walking[nxt < N]
    hit = best_t < _BIG
    prim = torch.where(hit, scene.prims_packed[best_row.clamp(max=scene.prims_packed.shape[0] - 1),
                                               10].int(), 0)
    return best_t < T_MAX, prim, visits


def walk_visits(inputs, card):
    """Mean nodes a walk visits, the skip-link tree against the walk layout,
    both answers checked equal."""
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import walk_closest_plain
    from plutracer_tpu_torch.ops.sampling import uniform_sphere_sample
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    x = torch.load(inputs)
    ext_d = uniform_sphere_sample(rng.uniform(rng.fold_in(rng.PRNGKey(7), 99), (65536, 2), "cuda"))
    for name in ("mesh1", "mesh2"):
        scene = compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"),
                                              ["/res", "256x256"]), device="cuda")
        o, d = (v.cuda() for v in x[f"{name} one stratum"][:2])
        f, _, t = k1_call(scene, o, d)
        hit_p = o + d * torch.where(f, t, 1.0)[:, None]
        for what, (ro, rd) in (("camera", (o, d)), ("extension", (hit_p, ext_d))):
            ro, rd = ro[:WALK_RAYS].contiguous(), rd[:WALK_RAYS].contiguous()
            tf, tp, tree = tree_walk(scene, ro, rd)
            wf, wp, _, nodes, leaves, rows = walk_closest_plain(
                scene.prims_packed, scene.walk_nodes, scene.walk_rows, ro, rd, count=True)
            assert torch.equal(tf, wf) and torch.equal(tp, wp), (name, what)
            mean = lambda v: v.double().mean().item()
            print(f"walk visits {name} {what} rays (B={WALK_RAYS}, P={scene.num_prims}): tree "
                  f"{mean(tree):.4f} nodes a walk ({scene.bvh.num_nodes} nodes), walk layout "
                  f"{mean(nodes + leaves):.4f} node records and leaves ({scene.walk_nodes.shape[0]} "
                  f"records), {mean(rows.sum(1)):.4f} rows a walk; answers equal ({card})")


def worker(root, inputs, out):
    """Runs every case through the package under `root`; saves the outputs
    to `out` and prints one JSON line of times (ms) and ptxas."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import ptxas_table, step_times, time_ms

    sys.path.insert(0, str(root))
    import plutracer_tpu_torch
    from plutracer_tpu_torch.ops.cuda import build
    from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_cuda
    from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_bvh
    from plutracer_tpu_torch.ops.cuda.stream_kernel import onebounce_cuda, ray_color_stream_cuda
    from plutracer_tpu_torch.render.wavefront import ray_color_wavefront
    from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS as OPTS

    assert pathlib.Path(plutracer_tpu_torch.__file__).is_relative_to(root), plutracer_tpu_torch
    lib = build.load()
    x = {k: tuple(t.cuda() for t in v) for k, v in torch.load(inputs).items()}
    scenes = load_scenes()
    outputs, times = {}, {}

    def case(what, fn, reps):
        outputs[what] = fn()
        times[what] = time_ms(fn, reps)

    case("K2 demo-box", lambda: ray_color_cuda(scenes["demo-box"], *x["demo-box"], OPTS), 20)
    outputs["K5 demo-box"] = ray_color_cuda(scenes["demo-box"], *x["demo-box"], OPTS, debug=True)
    for what in K3_CASES:
        scene, rays = scenes[what.split()[0]], x[what]
        case(f"K3 {what}", lambda: ray_color_stream_cuda(scene, *rays, OPTS), 10)
    outputs["K5 mesh1 4 strata"] = ray_color_stream_cuda(scenes["mesh1"], *x["mesh1 4 strata"],
                                                         OPTS, debug=True)
    case("query", lambda: closest_hit_bvh(scenes["mesh1"], *x["query"]), 20)
    for what in K1_CASES:
        scene = scenes["demo-box 256" if "train" in what else what.split()[0]]
        rays = x[f"K1 {what}"]
        reps = 3 if scene.prims_packed.shape[0] * rays[0].shape[0] > 2e9 else 20
        case(f"K1 {what} (wrapper)", lambda: k1_call(scene, *rays), reps)
        times[f"K1 {what} (kernel-only)"] = kernel_ms(lambda: k1_call(scene, *rays), reps)
    mesh1, rays = scenes["mesh1"], x["mesh1 4 strata"]
    for sort in ("morton", "none"):
        wf = OPTS.replace(stream_wavefront=True, stream_sort=sort)
        case(f"K4 loop {sort}", lambda: ray_color_wavefront(mesh1, *rays, wf), 5)
    wf = OPTS.replace(stream_wavefront=True)
    ts = step_times(mesh1, *rays, wf, onebounce_cuda, passes=2)
    times["K4 a launch"] = sum(ts) / len(ts)
    torch.save({k: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()
                for k, v in outputs.items()}, out)
    print(json.dumps({"times": times, "ptxas": ptxas_table(lib.compiler_log)}))


def run_worker(root, inputs, out):
    p = subprocess.run([sys.executable, __file__, "--worker", str(root), str(inputs), str(out)],
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"worker for {root} failed ({p.returncode}):\n{p.stdout}\n{p.stderr}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def assert_same(a, b, what):
    """Every output of two workers bit-equal (the query's t on hits)."""
    a, b = torch.load(a), torch.load(b)
    for k in a:
        if k == "query":
            (fa, pa, ta), (fb, pb, tb) = a[k], b[k]
            same = torch.equal(fa, fb) and torch.equal(pa, pb) and torch.equal(ta[fa], tb[fb])
        elif isinstance(a[k], tuple):
            same = all(((u == v) | (u.isnan() & v.isnan())).all() if u.is_floating_point()
                       else torch.equal(u, v) for u, v in zip(a[k], b[k]))
        else:
            same = torch.equal(a[k], b[k])
        assert same, f"{what}: {k} differs"


def variant(tmp, source, values):
    """A copy of this checkout's package whose csrc `source` has its
    constants rewritten: K1 (closest_hit.cu) (BLOCK, RAYS), K4
    (megakernel_onebounce.cu) (BLOCK, minimum blocks). Returns its root."""
    root = tmp / f"{pathlib.Path(source).stem}_{values[0]}_{values[1]}"
    shutil.copytree(REPO / "plutracer_tpu_torch", root / "plutracer_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / "plutracer_tpu_torch" / "csrc" / source
    text, n1 = re.subn(r"constexpr int BLOCK = \d+;", f"constexpr int BLOCK = {values[0]};",
                       src.read_text())
    if source == "closest_hit.cu":
        text, n2 = re.subn(r"constexpr int RAYS = \d+;", f"constexpr int RAYS = {values[1]};", text)
    else:
        bounds = f"BLOCK, {values[1]}" if values[1] else "BLOCK"
        text, n2 = re.subn(r"__global__ void __launch_bounds__\(BLOCK, \d+\)",
                           f"__global__ void __launch_bounds__({bounds})", text)
    assert n1 == 1 and n2 == 1, (source, n1, n2)
    src.write_text(text)
    return root


def sweep(tmp, card):
    """K1's (threads a block, rays a thread) and K4's (threads a block,
    minimum blocks) variants, a build each, outputs bit-equal to this
    checkout's."""
    print("launch-bound sweep (a build each, outputs bit-equal to this checkout's):")
    for source, values in ([("closest_hit.cu", v) for v in K1_SWEEP]
                           + [("megakernel_onebounce.cu", v) for v in K4_SWEEP]):
        root = variant(tmp, source, values)
        r = run_worker(root, tmp / "inputs.pt", tmp / "variant.pt")
        assert_same(tmp / "variant.pt", tmp / "new1.pt", f"{source} {values}")
        t = r["times"]
        if source == "closest_hit.cu":
            regs = {k: tuple(v) for k, v in r["ptxas"].items() if k.startswith("closest_hit_r")}
            print(f"  K1 block {values[0]}, rays a thread {values[1]}: kernel-only "
                  + ", ".join(f"{w} {t[f'K1 {w} (kernel-only)']}" for w in K1_CASES)
                  + f" ms; ptxas (registers, stack, spill stores, spill loads) {regs} ({card})")
        else:
            regs = tuple(r["ptxas"]["megakernel_onebounce"])
            print(f"  K4 block {values[0]}, min blocks {values[1]}: {t['K4 a launch']:.4f} ms a "
                  f"launch, loop morton {t['K4 loop morton']:.4f} ms, none {t['K4 loop none']:.4f}"
                  f" ms; ptxas {regs} ({card})")
        shutil.rmtree(root)


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        worker(pathlib.Path(argv[1]).resolve(), argv[2], argv[3])
        return 0
    if not torch.cuda.is_available():
        print("torch_kernels_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line

    earlier = pathlib.Path(argv[0]).resolve()
    assert (earlier / "plutracer_tpu_torch" / "csrc").is_dir(), earlier
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        make_inputs(tmp / "inputs.pt")
        torch.cuda.empty_cache()
        readings = {"earlier": [], "new": []}
        sides = {"earlier": earlier, "new": REPO}
        for i, side in enumerate(("earlier", "new", "new", "earlier") * ROUNDS):
            readings[side].append(run_worker(sides[side], tmp / "inputs.pt", tmp / f"{side}{i}.pt"))
            assert_same(tmp / f"{side}{i}.pt", tmp / ("earlier0.pt" if i else f"{side}{i}.pt"),
                        f"turn {i} ({side}) against the earlier side's first")
        print(f"earlier and new: every output bit-equal in all {4 * ROUNDS} turns ({card})")
        for side, rs in readings.items():
            for kernel, table in rs[0]["ptxas"].items():
                print(f"ptxas {side} {kernel}: (registers, stack bytes, spill stores, spill loads) "
                      f"{tuple(table)}")
        for what in readings["new"][0]["times"]:
            ts = {side: [r["times"][what] for r in rs] for side, rs in readings.items()}
            if any(v is None for vs in ts.values() for v in vs):
                print(f"A/B {what}: not recorded by the profiler ({card})")
                continue
            mean = {side: sum(v) / len(v) for side, v in ts.items()}
            print(f"A/B {what}: earlier {mean['earlier']:.4f} ms, new {mean['new']:.4f} ms "
                  f"(new/earlier {mean['new'] / mean['earlier']:.4f}); readings earlier "
                  f"{[round(v, 4) for v in ts['earlier']]}, new {[round(v, 4) for v in ts['new']]}"
                  f" ({card})")
        walk_visits(tmp / "inputs.pt", card)
        if "--sweep" in argv[1:]:
            sweep(tmp, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
