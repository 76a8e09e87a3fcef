"""Writes the benchmark's meshes from their published definitions.

    python3 benchmark/scenes/make_scenes.py

- ``cornell-box-{white,red,green}.obj``: the Cornell box as its measured
  data gives it (https://www.graphics.cornell.edu/online/box/data.html):
  floor, ceiling, back wall, the red and the green wall, the short and the
  tall block, each quad as two triangles in millimetres, moved by OFFSET. The light quad is
  carried by a box in cornell-box.urn (a scene's area light takes one
  surface).
- ``tetra<k>.obj``: Haines' Standard Procedural Databases "tetra" (E.
  Haines, "A Proposal for Standard Graphics Environments", IEEE CG&A
  7(11), 1987): a regular tetrahedron with corners at alternate corners of
  the cube [-1, 1]^3, replaced k times by its four half-size corner
  tetrahedra; 4^k tetrahedra of four triangles each.

Every triangle carries its flat normal as ``vn``, wound so cross(b - a,
c - a) points the same way: into the room for the box's walls, out of the
solid for the blocks and the tetrahedra. The files are committed; running
this again writes the same bytes.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

# the Cornell box's measured geometry (mm), quads as the data page lists them
CORNELL = {
    "white": [
        # floor
        [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2), (549.6, 0.0, 559.2)],
        # ceiling
        [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2), (0.0, 548.8, 0.0)],
        # back wall
        [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2), (556.0, 548.8, 559.2)],
        # short block
        [(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0),
         (290.0, 165.0, 114.0)],
        [(290.0, 0.0, 114.0), (290.0, 165.0, 114.0), (240.0, 165.0, 272.0),
         (240.0, 0.0, 272.0)],
        [(130.0, 0.0, 65.0), (130.0, 165.0, 65.0), (290.0, 165.0, 114.0), (290.0, 0.0, 114.0)],
        [(82.0, 0.0, 225.0), (82.0, 165.0, 225.0), (130.0, 165.0, 65.0), (130.0, 0.0, 65.0)],
        [(240.0, 0.0, 272.0), (240.0, 165.0, 272.0), (82.0, 165.0, 225.0), (82.0, 0.0, 225.0)],
        # tall block
        [(423.0, 330.0, 247.0), (265.0, 330.0, 296.0), (314.0, 330.0, 456.0),
         (472.0, 330.0, 406.0)],
        [(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0),
         (472.0, 0.0, 406.0)],
        [(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0),
         (314.0, 0.0, 456.0)],
        [(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0),
         (265.0, 0.0, 296.0)],
        [(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0),
         (423.0, 0.0, 247.0)],
    ],
    "red": [[(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2), (556.0, 548.8, 0.0)]],
    "green": [[(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0), (0.0, 548.8, 559.2)]],
}
# the box is moved so the light's centre (278, 548.8, 279.5) is the world
# origin: the renderer takes an area light's pdf with the squared distance
# of the light point from the origin (the upstream renderer's quirk, kept),
# so a light far from the origin lights next to nothing
OFFSET = np.array([-278.0, -548.8, -279.5])
ROOM_CENTRE = (278.0, 274.4, 279.6)
BLOCKS = {3: (185.5, 82.5, 169.0), 8: (368.5, 165.0, 351.25)}  # first face -> solid's centre


def oriented(tri, towards, inward: bool, shift=0.0):
    """The triangle moved by `shift` and wound so its normal faces
    `towards` (inward) or away from it, and that unit normal."""
    a, b, c = (np.asarray(v, np.float64) + shift for v in tri)
    n = np.cross(b - a, c - a)
    side = np.dot(n, np.asarray(towards, np.float64) + shift - a) > 0
    if side != inward:
        b, c, n = c, b, -n
    return (a, b, c), n / np.linalg.norm(n)


def write_obj(path: pathlib.Path, header: str, tris) -> None:
    """tris: [((a, b, c), normal)]; vertices and normals shared where
    equal. Each triangle's corners take the texture coordinates (0, 0),
    (1, 0), (0, 1): the shading frame follows dp/du, which a triangle
    without them lacks."""
    vindex, nindex, faces = {}, {}, []
    for corners, n in tris:
        ni = nindex.setdefault(tuple(float(x) for x in n), len(nindex) + 1)
        ids = [vindex.setdefault(tuple(float(x) for x in v), len(vindex) + 1) for v in corners]
        faces.append("f " + " ".join(f"{i}/{t}/{ni}" for t, i in enumerate(ids, 1)))
    vlines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in vindex]
    nlines = [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in nindex]
    tlines = ["vt 0 0", "vt 1 0", "vt 0 1"]
    path.write_text("\n".join([f"# {header}", *vlines, *tlines, *nlines, *faces]) + "\n")


def cornell(material: str):
    tris = []
    centre, inward = ROOM_CENTRE, True
    for q, quad in enumerate(CORNELL[material]):
        if material == "white" and q in BLOCKS:
            centre, inward = BLOCKS[q], False
        for tri in ((quad[0], quad[1], quad[2]), (quad[0], quad[2], quad[3])):
            tris.append(oriented(tri, centre, inward, OFFSET))
    return tris


CUBE_CORNERS = np.array([(1, 1, 1), (-1, -1, 1), (1, -1, -1), (-1, 1, -1)], np.float64)


def tetra(level: int):
    """The SPD tetra's triangles at `level`: 4^level tetrahedra."""
    tris = []

    def solid(centre, size, depth):
        if depth == 0:
            corners = centre + size * CUBE_CORNERS
            for skip in range(4):
                face = [corners[i] for i in range(4) if i != skip]
                tris.append(oriented(face, centre, False))
            return
        for corner in CUBE_CORNERS:
            solid(centre + 0.5 * size * corner, 0.5 * size, depth - 1)

    solid(np.zeros(3), 1.0, level)
    return tris


def main(argv) -> int:
    out = pathlib.Path(argv[0]) if argv else HERE
    for material in CORNELL:
        write_obj(out / f"cornell-box-{material}.obj",
                  f"the Cornell box's {material} surfaces (make_scenes.py)", cornell(material))
    level = 7
    write_obj(out / f"tetra{level}.obj",
              f"SPD tetra, {4 ** level} tetrahedra (make_scenes.py)", tetra(level))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
