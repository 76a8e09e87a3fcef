"""Times R2 (csrc/camera.cu) with two store paths, on one NVIDIA GPU:
three scalar stores a ray and array (the kernel as the library builds it)
against a block's rays staged in shared memory and written as 16-byte
vectors (the kernel below, STAGED, put in its place).

    python3 tools/experiments/r2_stores.py

Each variant is a copy of camera.cu (with threefry.cuh) built by its own
nvcc with the library's flags into a temporary library. Shapes: chip_smoke's R2_CASES (a demo-box 512x512 stratum, a dof
640x480 stratum with the thin lens, mesh1 256x256 launches of 4 and 16
strata). Each variant's o and d are held bit-equal (int32 views) to
renderer.camera_rays_plain. Times, in turns (staged, scalar, scalar,
staged): the kernel's device time a launch (torch.profiler), and CUDA
events around back-to-back raw launches into preallocated outputs (at
these sizes the host's launch rate can pace those); the card's SM clock
and power after each shape. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
KERNEL = re.compile(r"// cam: the camera table; px0: \(B, 2\); o, d: \(S \* B, 3\)\n.*?"
                    r"(?=\}  // namespace)", re.S)
REPS = 200
# camera.cu's kernel with its stores staged: every thread of a block
# writes its ray to shared memory, then the block writes o's and d's
# stretch of 3 * 256 floats as the floats up to a 16-byte boundary, float4s
# and the tail
STAGED = r"""
__device__ __forceinline__ void store_block(float* __restrict__ dst, const float* src, int nf) {
  const int t = threadIdx.x;
  const int head = min((int)((16u - ((unsigned)(uintptr_t)dst & 15u)) & 15u) / 4, nf);
  if (t < head) dst[t] = src[t];
  const int nv = (nf - head) / 4;
  float4* dv = reinterpret_cast<float4*>(dst + head);
  for (int i = t; i < nv; i += BLOCK) {
    const float* s = src + head + 4 * i;
    dv[i] = make_float4(s[0], s[1], s[2], s[3]);
  }
  const int tail = head + 4 * nv;
  if (t < nf - tail) dst[tail + t] = src[tail + t];
}

__global__ void __launch_bounds__(BLOCK) camera_rays(const float* __restrict__ cam,
                                                     const float2* __restrict__ px0,
                                                     const __grid_constant__ PluStrata strata,
                                                     int B, int n, float* __restrict__ o,
                                                     float* __restrict__ d) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  const int j = blockIdx.y;
  __shared__ float so[3 * BLOCK], sd[3 * BLOCK];
  if (p < B) {
    const int c = strata.cell[j];
    const uint32_t* key = strata.key[j];
    float2 jp, jl = make_float2(0.0f, 0.0f);
    if (cam[LENS] > 0.0f) {
      jp = jitter(key[0], key[1], (uint32_t)p);
      jl = jitter(key[2], key[3], (uint32_t)p);
    } else {
      jp = jitter(key[0], key[1], (uint32_t)p);
    }
    camera_ray(cam, px0[p], (float)(c % n), (float)(c / n), (float)n, jp, jl,
               so + 3 * threadIdx.x, sd + 3 * threadIdx.x);
  }
  __syncthreads();
  const int first = blockIdx.x * BLOCK;
  const int nf = 3 * min(BLOCK, B - first);
  const long long base = 3 * ((long long)j * B + first);
  store_block(o + base, so, nf);
  store_block(d + base, sd, nf);
}

"""


def kernel_ms(call, reps: int) -> float:
    """The device time of the camera_rays kernel a launch, torch.profiler
    over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if "camera_rays" in ev.key]
    us = sum(getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
             for ev in evs)
    return us / 1e3 / sum(ev.count for ev in evs)


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def build_variant(build, tmp: pathlib.Path, staged: bool):
    """(library, ptxas lines) of camera.cu, its kernel replaced by STAGED
    where `staged`."""
    where = tmp / ("staged" if staged else "scalar")
    where.mkdir()
    (where / "threefry.cuh").write_text((build.CSRC / "threefry.cuh").read_text())
    text = (build.CSRC / "camera.cu").read_text()
    if staged:
        text, found = KERNEL.subn(lambda _: STAGED, text)
        assert found == 1, "camera.cu's kernel not found"
    (where / "camera.cu").write_text(text)
    out = where / "libr2.so"
    run = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                          str(where / "camera.cu")], capture_output=True, text=True, timeout=300)
    log = run.stdout + run.stderr
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")
    lib = ctypes.CDLL(str(out))
    lib.plu_camera_rays.argtypes = build._SIGNATURES["plu_camera_rays"]
    lib.plu_camera_rays.restype = ctypes.c_int
    return lib, [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]


def main() -> int:
    if not torch.cuda.is_available():
        print("r2_stores: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import R2_CASES, card_line, time_ms
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.ops.cuda import build
    from plutracer_tpu_torch.ops.cuda.camera_kernel import MAX_STRATA, Strata, camera_table
    from plutracer_tpu_torch.render.renderer import camera_rays_plain, launch_draws, pixel_centers
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    card = card_line()
    dev = torch.device("cuda")
    base = rng.key_words(rng.PRNGKey(7))
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for staged in (True, False):
            libs[staged], ptxas = build_variant(build, pathlib.Path(tmp), staged)
            for line in ptxas:
                print(f"ptxas {'staged' if staged else 'scalar'}: {line}")
        for name, (w, h), S, n in R2_CASES:
            sc = compile_scene(load_scene_file(str(REPO / "scenes" / f"{name}.urn"),
                                               ["/res", f"{w}x{h}"]), device=dev)
            B = w * h
            strata = [(5 * j + 3) % (n * n) for j in range(S)]
            px0 = pixel_centers(w, h, dev)
            keys, _ = launch_draws([rng.fold_in_words(base, j) for j in range(S)], B, 0, dev)
            words = [x for pair in keys for k in pair for x in k]
            arg = Strata((ctypes.c_int * MAX_STRATA)(*strata),
                         (ctypes.c_uint32 * (4 * MAX_STRATA))(*words))
            table = camera_table(sc.camera)
            po, pd = camera_rays_plain(sc.camera, px0, keys, strata, n)
            stream = torch.cuda.current_stream().cuda_stream
            calls = {}
            for staged, lib in libs.items():
                out = torch.full((2, S * B, 3), float("nan"), device=dev)

                def call(lib=lib, out=out):
                    build.check(lib.plu_camera_rays(table.data_ptr(), px0.data_ptr(), arg, S, B,
                                                    n, out[0].data_ptr(), out[1].data_ptr(),
                                                    stream), "plu_camera_rays")

                call()
                torch.cuda.synchronize()
                for got, want in ((out[0], po), (out[1], pd)):
                    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
                        name, S, staged)
                calls[staged] = call
            ms = {True: [], False: []}
            kernel = {True: [], False: []}
            for staged in (True, False, False, True):
                kernel[staged].append(kernel_ms(calls[staged], REPS))
                ms[staged].append(time_ms(calls[staged], REPS))
            what = f"{name} {w}x{h}, {S} strata x {B} pixels"
            fmt = lambda xs: ", ".join(f"{t:.5f}" for t in xs)
            for staged in (True, False):
                print(f"R2 {'staged 16-byte' if staged else 'scalar'} stores, {what}: kernel-only "
                      f"{sum(kernel[staged]) / 2:.5f} ms (readings {fmt(kernel[staged])}), "
                      f"back-to-back {sum(ms[staged]) / 2:.5f} ms a launch (readings "
                      f"{fmt(ms[staged])}), bit-equal to camera_rays_plain ({card})")
            print(f"R2 {what}: scalar / staged, kernel-only "
                  f"{sum(kernel[False]) / sum(kernel[True]):.4f}, back-to-back "
                  f"{sum(ms[False]) / sum(ms[True]):.4f}; SM clock, power, temperature {smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
