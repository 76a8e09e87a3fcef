"""Hand-written CUDA kernels and their wrappers.

DBG_CHANNELS is part of the path kernels' C ABI: the per-bounce telemetry
channels K2 and K3 write in their K5 instantiation (csrc/path_common.cuh,
DBG_C), in the JAX megakernel's order (integrator_kernel.py:1231-1238).
ray_color_plain(..., debug=True) writes the same channels.
"""

DBG_CHANNELS = (
    "t",  # the vertex's incoming hit t (BIG where it missed)
    "prim",  # the vertex's incoming hit primitive row
    "T_max",  # max component of the throughput after the clamped update
    "bs_pdf",  # pdf of the extension BSDF sample
    "bs_f2",  # dot(f, f) of the extension BSDF sample
    "ls_pdf",  # pdf of the light sample
    "l_pdf2",  # light pdf of the NEE BSDF sample's direction
    "Ld_sum",  # sum of Ld = contrib_l + contrib_b, before x T x num_lights
    "cur",  # the path is alive and hit something at this vertex (0/1)
    "xt",  # the extension query's raw t
    "xp",  # the extension query's raw primitive row
    "is_specular",  # the extension BSDF sample is specular (0/1)
)
DBG_C = len(DBG_CHANNELS)
