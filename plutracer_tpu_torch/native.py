"""ctypes bindings for the native (C++) host helpers: BVH build and OBJ
parsing (native/bvh_builder.cpp, native/obj_loader.cpp).

The sources are compiled on first use with ``g++`` into the port's own
``plutracer_tpu_torch/_build/`` (never into ``native/``), under a name that
carries a hash of the sources and flags. The pure-Python versions
(scene/bvh.py, scene/obj.py) define the semantics and take over when the
library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
_SOURCES = ("bvh_builder.cpp", "obj_loader.cpp")
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_STATE: dict = {}  # "lib": the loaded library, or None once a build failed


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for name in _SOURCES:
        h.update((_NATIVE_DIR / name).read_bytes())
    return _BUILD_DIR / f"libplutracer_native_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp),
                        *(str(_NATIVE_DIR / s) for s in _SOURCES)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


def _ensure_built() -> Optional[ctypes.CDLL]:
    if "lib" in _STATE:
        return _STATE["lib"]
    _STATE["lib"] = None
    try:
        path = _library_path()
    except OSError:  # native/ sources absent
        return None
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    fp = ctypes.POINTER(ctypes.c_float)
    lib.plu_build_bvh.restype = ctypes.c_int
    lib.plu_build_bvh.argtypes = [fp, ctypes.c_int, fp, fp, ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.plu_load_obj.restype = ctypes.c_int
    lib.plu_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(fp), ctypes.POINTER(fp),
                                 ctypes.POINTER(fp), ctypes.POINTER(ctypes.c_int)]
    lib.plu_free.restype = None
    lib.plu_free.argtypes = [ctypes.c_void_p]
    _STATE["lib"] = lib
    return lib


def available() -> bool:
    return _ensure_built() is not None


def build_bvh_native(prims10: np.ndarray):
    """prims10: (P, 10) f32 [type a b c]. Returns (node_min, node_max,
    node_skip, node_prim) numpy arrays, or None if the library is missing."""
    lib = _ensure_built()
    if lib is None:
        return None
    prims10 = np.ascontiguousarray(prims10, np.float32)
    P = prims10.shape[0]
    N = 2 * P - 1
    node_min = np.zeros((N, 3), np.float32)
    node_max = np.zeros((N, 3), np.float32)
    node_skip = np.zeros(N, np.int32)
    node_prim = np.zeros(N, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n = lib.plu_build_bvh(prims10.ctypes.data_as(fp), P, node_min.ctypes.data_as(fp),
                          node_max.ctypes.data_as(fp), node_skip.ctypes.data_as(ip),
                          node_prim.ctypes.data_as(ip))
    if n != N:
        return None
    return node_min, node_max, node_skip, node_prim


def load_obj_native(path: str):
    """Returns (positions (F,3,3), normals (F,3,3), uvs (F,3,2)) or None."""
    lib = _ensure_built()
    if lib is None:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    pos_p, norm_p, uv_p = fp(), fp(), fp()
    nf = ctypes.c_int(0)
    rc = lib.plu_load_obj(path.encode(), ctypes.byref(pos_p), ctypes.byref(norm_p),
                          ctypes.byref(uv_p), ctypes.byref(nf))
    if rc != 0:
        return None
    F = nf.value
    try:
        pos = np.ctypeslib.as_array(pos_p, (F, 3, 3)).copy()
        norm = np.ctypeslib.as_array(norm_p, (F, 3, 3)).copy()
        uv = np.ctypeslib.as_array(uv_p, (F, 3, 2)).copy()
    finally:
        lib.plu_free(pos_p)
        lib.plu_free(norm_p)
        lib.plu_free(uv_p)
    return pos, norm, uv
