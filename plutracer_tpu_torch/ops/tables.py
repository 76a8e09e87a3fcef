"""Packed entity tables and row gathers.

Each entity's fields are packed into one float32 row so a bounce gathers
one (B, W) block per table and slices columns. Column layouts (integer ids
are exact in f32 below 2^24), identical to the JAX package's
ops/tables.py and to what the CUDA megakernel reads:

prim (W=32): 0 type | 1:4 a | 4:7 b | 7:10 c | 10:13 n0 | 13:16 n1 |
             16:19 n2 | 19:21 uv0 | 21:23 uv1 | 23:25 uv2 | 25 material |
             26 light | 27 area | 28:32 pad
mat  (W=12): 0 type | 1:4 color | 4 tex | 5:8 eta | 8:11 k | 11 pad
tex  (W=12): 0 type | 1:4 c0 | 4:7 c1 | 7 scale | 8 line | 9 ofs | 10 w | 11 h
light (W=8): 0 type | 1:4 pos | 4:7 intensity | 7 prim

Gathers are plain indexing with out-of-range ids clamped to [0, n-1]
(a -1 sentinel reads row 0, as in every tier of the JAX gathers).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plutracer_tpu_torch.utils import profiling


class PackedTables(NamedTuple):
    prim: torch.Tensor  # (P, 32)
    mat: torch.Tensor  # (M, 12)
    tex: torch.Tensor  # (T, 12)
    light: torch.Tensor  # (L, 8)


# the columns pack_tables gives each table (csrc/path_common.cuh's PRIM_W,
# MAT_W, TEX_W, LIGHT_W)
TABLE_W = PackedTables(prim=32, mat=12, tex=12, light=8)


def pack_tables(scene) -> PackedTables:
    with profiling.span("plu.tables.pack"):
        f = lambda x: x.to(torch.float32)
        c1 = lambda x: f(x)[:, None]
        P = scene.prim_type.shape[0]
        M = scene.mat_type.shape[0]
        dev = scene.prim_a.device
        prim = torch.cat(
            [
                c1(scene.prim_type), f(scene.prim_a), f(scene.prim_b), f(scene.prim_c),
                f(scene.prim_n0), f(scene.prim_n1), f(scene.prim_n2),
                f(scene.prim_uv0), f(scene.prim_uv1), f(scene.prim_uv2),
                c1(scene.prim_material), c1(scene.prim_light), c1(scene.prim_area),
                torch.zeros((P, 4), dtype=torch.float32, device=dev),
            ],
            dim=1,
        )
        mat = torch.cat(
            [
                c1(scene.mat_type), f(scene.mat_color), c1(scene.mat_tex),
                f(scene.mat_eta), f(scene.mat_k),
                torch.zeros((M, 1), dtype=torch.float32, device=dev),
            ],
            dim=1,
        )
        tex = torch.cat(
            [
                c1(scene.tex_type), f(scene.tex_c0), f(scene.tex_c1),
                c1(scene.tex_scale), c1(scene.tex_line), c1(scene.tex_img_ofs),
                c1(scene.tex_img_w), c1(scene.tex_img_h),
            ],
            dim=1,
        )
        light = torch.cat(
            [
                c1(scene.light_type), f(scene.light_pos),
                f(scene.light_intensity), c1(scene.light_prim),
            ],
            dim=1,
        )
        return PackedTables(prim=prim, mat=mat, tex=tex, light=light)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _i(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


class PrimRows(NamedTuple):
    """Column views over gathered primitive rows (B, 32)."""

    rows: torch.Tensor

    ptype = property(lambda s: _i(s.rows[..., 0]))
    a = property(lambda s: s.rows[..., 1:4])
    b = property(lambda s: s.rows[..., 4:7])
    c = property(lambda s: s.rows[..., 7:10])
    n0 = property(lambda s: s.rows[..., 10:13])
    n1 = property(lambda s: s.rows[..., 13:16])
    n2 = property(lambda s: s.rows[..., 16:19])
    uv0 = property(lambda s: s.rows[..., 19:21])
    uv1 = property(lambda s: s.rows[..., 21:23])
    uv2 = property(lambda s: s.rows[..., 23:25])
    material = property(lambda s: _i(s.rows[..., 25]))
    light = property(lambda s: _i(s.rows[..., 26]))
    area = property(lambda s: s.rows[..., 27])


class MatRows(NamedTuple):
    rows: torch.Tensor  # (B, 12)

    mtype = property(lambda s: _i(s.rows[..., 0]))
    color = property(lambda s: s.rows[..., 1:4])
    tex = property(lambda s: _i(s.rows[..., 4]))
    eta = property(lambda s: s.rows[..., 5:8])
    k = property(lambda s: s.rows[..., 8:11])


class TexRows(NamedTuple):
    rows: torch.Tensor  # (B, 12)

    ttype = property(lambda s: _i(s.rows[..., 0]))
    c0 = property(lambda s: s.rows[..., 1:4])
    c1 = property(lambda s: s.rows[..., 4:7])
    scale = property(lambda s: s.rows[..., 7])
    line = property(lambda s: s.rows[..., 8])
    img_ofs = property(lambda s: _i(s.rows[..., 9]))
    img_w = property(lambda s: _i(s.rows[..., 10]))
    img_h = property(lambda s: _i(s.rows[..., 11]))


class LightRows(NamedTuple):
    rows: torch.Tensor  # (B, 8)

    ltype = property(lambda s: _i(s.rows[..., 0]))
    pos = property(lambda s: s.rows[..., 1:4])
    intensity = property(lambda s: s.rows[..., 4:7])
    prim = property(lambda s: _i(s.rows[..., 7]))


def gather_prim(tables: PackedTables, idx) -> PrimRows:
    return PrimRows(_rows(tables.prim, idx))


def gather_mat(tables: PackedTables, idx) -> MatRows:
    return MatRows(_rows(tables.mat, idx))


def gather_tex(tables: PackedTables, idx) -> TexRows:
    return TexRows(_rows(tables.tex, idx))


def gather_light(tables: PackedTables, idx) -> LightRows:
    return LightRows(_rows(tables.light, idx))


def gather_prim_light(tables: PackedTables, idx) -> torch.Tensor:
    """prim[idx].light: only the light-link column."""
    return _i(_rows(tables.prim[:, 26], idx))
