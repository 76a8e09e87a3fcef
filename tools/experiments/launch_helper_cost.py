"""The launch helper's host cost on one NVIDIA GPU.

    python3 tools/experiments/launch_helper_cost.py

Times (host clock) one empty entry of ops/cuda/build.on_device, of a bare
lookup of the device's current stream (what the wrappers did before the
helper), of torch.cuda.device alone and of torch.cuda.current_stream
alone, for "cuda" and "cuda:0"; then K1's wrapper at demo-box 512x512's
primary rays and at a train step's query shape, and R1's at a demo-box
stratum's path uniforms, with the helper and with the bare lookup in its
place, in turns (helper, bare, bare, helper; twice), CUDA events around
200 calls. Exits non-zero without a CUDA device.
"""
import contextlib
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.ops.cuda import build
from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_cuda
from plutracer_tpu_torch.ops.cuda.rng_kernel import uniform_block_words
from plutracer_tpu_torch.render.renderer import pixel_centers
from plutracer_tpu_torch.scene import compile_scene, load_scene_file

if not torch.cuda.is_available():
    sys.exit("launch_helper_cost: no CUDA device available")
build.load()
real = build.on_device
REPO = pathlib.Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def bare(dev):  # the stream of `dev`, no device entered (the wrappers before the helper)
    yield torch.cuda.current_stream(dev).cuda_stream


def host_us(fn, reps=20000):
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


for name, dev in (("cuda", torch.device("cuda")), ("cuda:0", torch.device("cuda", 0))):
    def enter_real():
        with real(dev):
            pass

    def enter_bare():
        with bare(dev):
            pass

    def guard():
        with torch.cuda.device(dev):
            pass

    print(f"host us an entry ({name}): on_device {host_us(enter_real):.3f}, bare stream "
          f"{host_us(enter_bare):.3f}, torch.cuda.device alone {host_us(guard):.3f}, "
          f"current_stream alone {host_us(lambda: torch.cuda.current_stream(dev)):.3f}")

dev = torch.device("cuda")
scene = compile_scene(load_scene_file(str(REPO / "scenes" / "demo-box.urn")), device=dev)
B = 512 * 512
px = pixel_centers(512, 512, dev)
o, d = generate_rays(scene.camera, px, torch.zeros_like(px))
keys = rng.key_table([rng.PRNGKey(k) for k in range(8)])
words = rng.device_words(keys.numpy().astype("uint32").view("int32"), dev)
calls = {
    "K1 demo-box primary": lambda: closest_hit_cuda(scene.prims_packed, o, d,
                                                    scene.packed_type_rows),
    "K1 train query (3 x 65,536)": lambda: closest_hit_cuda(
        scene.prims_packed, o[:196608], d[:196608], scene.packed_type_rows),
    "R1 demo-box stratum": lambda: uniform_block_words(words, 12 * B),
}


def wrapper_ms(fn, reps=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host


for what, fn in calls.items():
    got = {"on_device": [], "bare": []}
    for side in ("on_device", "bare", "bare", "on_device") * 2:
        build.on_device = real if side == "on_device" else bare
        got[side].append(wrapper_ms(fn))
    build.on_device = real
    for side, readings in got.items():
        ev = [round(r[0], 4) for r in readings]
        host = [round(r[1], 4) for r in readings]
        print(f"{what} wrapper, {side}: events ms {ev}, host enqueue ms {host}")
