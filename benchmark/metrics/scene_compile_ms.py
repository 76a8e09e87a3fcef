"""scene_compile_ms: the host clock around the program's load_scene_file
and compile_scene of the cell's scene in set-up, ended by a synchronize
(urn evaluation, the BVH, the packed table and the walk layout)."""


def read(ctx):
    s = ctx.spans.get("scene_compile")
    return None if s is None else 1e3 * s
