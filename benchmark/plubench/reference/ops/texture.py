"""Color properties and texture evaluation.

Reference: props::color (inc/props.h:9-31) evaluated at hr.texture_coords;
procedural textures inc/textures/textures.h:7-31; image texel lookup
inc/texture.h:53-60 (wrap-mode nearest neighbor). Row-based: the caller
gathers one packed material row and one texture row per shading point;
``eval_color`` is the scene-level form for tests, tools and user code.
"""

from __future__ import annotations

import torch

from plubench.reference.ops.tables import MatRows, TexRows, gather_mat, gather_tex, pack_tables
from plubench.reference.scene.types import TEX_CHECKERBOARD, TEX_GRID


def _checkerboard(uv, c0, c1, scale):
    uvf = torch.floor(uv * scale[..., None])
    idx = torch.remainder(uvf[..., 0] + uvf[..., 1], 2.0)
    return torch.where(idx[..., None] < 1.0, c0, c1)


def _grid(uv, fg, bg, scale, line):
    # glm step(edge=fract(uv*scale), x=line): 1 where line >= fract
    f = uv * scale[..., None]
    fr = f - torch.floor(f)
    g = torch.where(line[..., None] >= fr, 1.0, 0.0)
    m = torch.maximum(g[..., 0], g[..., 1])
    return bg + (fg - bg) * m[..., None]


def _image(atlas, trows: TexRows, uv):
    c = torch.remainder(uv, 1.0)
    w = trows.img_w
    h = trows.img_h
    ic_x = torch.minimum(torch.floor(c[..., 0] * w).to(torch.int32), w - 1)
    ic_y = torch.minimum(torch.floor(c[..., 1] * h).to(torch.int32), h - 1)
    flat = trows.img_ofs + ic_y * w + ic_x
    return atlas[flat.long().clamp(0, atlas.shape[0] - 1)]


def eval_color_rows(atlas, mrows: MatRows, trows: TexRows, uv, has_images: bool):
    """Evaluate a material's color property from pre-gathered rows.

    has_images: atlas length > 1, so scenes without image textures skip
    the per-ray atlas gather entirely.
    """
    has_tex = mrows.tex >= 0
    ttype = trows.ttype
    checker = _checkerboard(uv, trows.c0, trows.c1, trows.scale)
    grid = _grid(uv, trows.c0, trows.c1, trows.scale, trows.line)
    img = _image(atlas, trows, uv) if has_images else checker
    texval = torch.where(
        (ttype == TEX_CHECKERBOARD)[..., None],
        checker,
        torch.where((ttype == TEX_GRID)[..., None], grid, img),
    )
    return torch.where(has_tex[..., None], texval, mrows.color)


def eval_color(scene, mat_idx, uv):
    """Scene-based wrapper (tests/tools API). mat_idx: (B,); uv: (B,2)."""
    tables = pack_tables(scene)
    mrows = gather_mat(tables, mat_idx)
    trows = gather_tex(tables, torch.clamp(mrows.tex, min=0))
    return eval_color_rows(scene.atlas, mrows, trows, uv, has_images=scene.atlas.shape[0] > 1)
