"""Build and load the CUDA kernels (plutracer_tpu_torch/csrc/*.cu).

One shared library with a plain C interface, compiled by ``nvcc`` for
Hopper (sm_90a) at first use and loaded with ctypes: every ``.cu`` source
is compiled to an object by its own ``nvcc``, all started together, and
the objects are linked into the library. Nothing is compiled when the
package is imported. The library lands in
``plutracer_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited source is rebuilt and a fresh checkout
builds its own.

FMA contraction is off and division and sqrt stay IEEE (no fast math):
the kernels then round exactly as their plain PyTorch versions do on the
card, which is what makes K1 bit-equal to its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from plutracer_tpu_torch.ops.cuda.camera_kernel import Strata
from plutracer_tpu_torch.utils import profiling

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_vp = ctypes.c_void_p
_i = ctypes.c_int
_SIGNATURES = {
    # n_rows, B, tiles out -> splits (negative: a cudaError_t)
    "plu_closest_hit_plan": [_i, _i, ctypes.POINTER(_i)],
    # packed, n_rows, sphere rows, box rows, o, d, t_out, prim_out,
    # found_out, B, splits, part_t, part_k, arrivals, stream
    "plu_closest_hit": [_vp, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _i, _i, _vp, _vp, _vp, _vp],
    # prim, P, mat, M, tex, T, light, L, packed, P_pad, atlas, A, has_images,
    # o, d, prim0, t0, u, out, dbg (K5 telemetry or null), B, max_bounces,
    # swapped_mis, origin_pdf, shading_gate, stream
    "plu_megakernel": [_vp, _i, _vp, _i, _vp, _i, _vp, _i, _vp, _i, _vp, _i, _i,
                       _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # packed, walk_nodes, walk_rows, o, d, t_out, prim_out, B, stream
    "plu_closest_hit_bvh": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _vp],
    # prim, P, mat, M, tex, T, light, L, atlas, A, has_images, the walk as
    # above (3), o, d, u, out, dbg (K5 telemetry or null), B, max_bounces,
    # swapped_mis, origin_pdf, shading_gate, stream
    "plu_megakernel_stream": [_vp, _i, _vp, _i, _vp, _i, _vp, _i, _vp, _i, _i,
                              _vp, _vp, _vp,
                              _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # the tables and the walk as above, o, d, carry_in, carry_out, perm,
    # orig_in, orig_out, u, out, key, counts, bounds (null where unused), B,
    # bounce, sort, max_bounces, swapped_mis, origin_pdf, shading_gate, stream
    "plu_megakernel_onebounce": [_vp, _i, _vp, _i, _vp, _i, _vp, _i, _vp, _i, _i,
                                 _vp, _vp, _vp,
                                 _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                 _i, _i, _i, _i, _i, _i, _i, _vp],
    # keys (K x 2 uint32 words), K, n words a key, out (K x n float32), stream
    "plu_threefry_uniform": [_vp, _i, ctypes.c_longlong, _vp, _vp],
    # camera table, px0, the strata's cells and jitter keys (by value), S, B, n, o, d, stream
    "plu_camera_rays": [_vp, _vp, Strata, _i, _i, _i, _vp, _vp, _vp],
    # idx, grad, part (or null), out, arrivals (or null), B, R, W, chunk, chunks, stream
    "plu_row_grad": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # rows, perm, grad, part (or null), out, arrivals (or null), B, R, W, tiles, stream
    "plu_row_grad_sorted": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp],
}


class Library:
    """The loaded kernel library plus how it was built."""

    def __init__(self, path: pathlib.Path, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds  # 0.0 when an existing build was loaded
        self.compiler_log = log  # nvcc's output (ptxas register/spill report)
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_LOADED: list = []  # the library once loaded: sources do not change in a process


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libplutracer_kernels_{h.hexdigest()[:16]}.so"


def load() -> Library:
    """The kernel library, compiled on first use in this checkout and
    loaded once per process."""
    if _LOADED:
        return _LOADED[0]
    path = library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        tag = f"{path.stem}.{os.getpid()}"
        t0 = time.perf_counter()
        objs, procs = [], []
        try:
            for src in sorted(CSRC.glob("*.cu")):
                obj = BUILD_DIR / f"{tag}.{src.stem}.o"
                objs.append(obj)
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            log = "".join(p.communicate(timeout=900)[0] for p in procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        log += link.stdout + link.stderr
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, path)
    _LOADED.append(Library(path, seconds, log))
    return _LOADED[0]


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


class on_device:
    """``with on_device(dev) as stream``: make the CUDA device `dev`
    current for the block and give the handle of its current stream, for
    the launch entry points' last argument. utils/profiling's
    ``device_entries`` counts the blocks entered: one for each kernel
    launch (K1's plan call is inside its launch's block)."""

    def __init__(self, dev):
        self.dev = torch.device(dev)
        if self.dev.type != "cuda":
            raise ValueError(f"on_device: needs a CUDA device, got {self.dev}")
        self.guard = torch.cuda.device(self.dev)

    def __enter__(self) -> int:
        self.guard.__enter__()
        profiling.count("device_entries")
        return torch.cuda.current_stream(self.dev).cuda_stream

    def __exit__(self, *exc):
        return self.guard.__exit__(*exc)


_ARRIVALS = {}  # (device index, stream handle) -> int32 counts, all 0 between launches


def arrivals(dev, n: int, stream: int) -> torch.Tensor:
    """Arrival counts for a launch whose last block to arrive folds the
    others' partials (K1 one a ray tile, G1 one): at least n int32 zeros
    on the CUDA device `dev` ("cuda" names the current one), one buffer a
    card and stream (the handle ``on_device`` gives). Each such kernel
    sets its counts back to 0 before it ends and launches on one stream
    run in order, so the kernels that share a buffer never count at once;
    a launch on another stream has its own."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    buf = _ARRIVALS.get((index, stream))
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[(index, stream)] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                       device=torch.device("cuda", index))
    return buf
