"""Wavefront OBJ triangle-mesh loader.

Mirrors the reference's hand-rolled parser (inc/scene.h:138-201): handles
``v``, ``vn``, ``vt``, ``f`` records with 1-based ``p``, ``p/t``, ``p//n``,
``p/t/n`` face indices; comments and unknown records are skipped. Returns
flat numpy arrays (one row per face corner) for the scene compiler.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    # (F,3,3): vertex positions per face corner; (F,3,3) normals; (F,3,2) uvs
    positions: np.ndarray
    normals: np.ndarray
    texcoords: np.ndarray


def load_obj(path: str) -> ObjMesh:
    poss: List[List[float]] = []
    norms: List[List[float]] = []
    uvs: List[List[float]] = []
    faces = []  # list of ((ip0,it0,in0), (ip1,...), (ip2,...))

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                poss.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                corners = []
                for spec in parts[1:4]:
                    segs = spec.split("/")
                    ip = int(segs[0]) - 1
                    it = int(segs[1]) - 1 if len(segs) > 1 and segs[1] else -1
                    inn = int(segs[2]) - 1 if len(segs) > 2 and segs[2] else -1
                    corners.append((ip, it, inn))
                faces.append(tuple(corners))

    P = np.asarray(poss, np.float32) if poss else np.zeros((0, 3), np.float32)
    N = np.asarray(norms, np.float32) if norms else np.zeros((0, 3), np.float32)
    T = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)

    F = len(faces)
    fpos = np.zeros((F, 3, 3), np.float32)
    fnorm = np.zeros((F, 3, 3), np.float32)
    fuv = np.zeros((F, 3, 2), np.float32)
    for fi, corners in enumerate(faces):
        for ci, (ip, it, inn) in enumerate(corners):
            fpos[fi, ci] = P[ip]
            if 0 <= inn < len(N):
                fnorm[fi, ci] = N[inn]
            if 0 <= it < len(T):
                fuv[fi, ci] = T[it]
    return ObjMesh(fpos, fnorm, fuv)
