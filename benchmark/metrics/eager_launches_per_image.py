"""eager_launches_per_image: the kernel records of the traced window that
are not the program's own kernels, over the images the window completed:
every kernel record (as launches_per_image counts them) less the launches
the program's wrappers counted (utils/profiling's launches.* counters: one
a K1, K1-query, K2, K3, K4, K5, R1 or R2 launch, counted while the
profiler traces the window). What is left is torch's eager kernels: casts,
concatenations, fills, the accumulation, the tonemap. None where the
window has no device trace or the program recorded nothing."""


def read(ctx):
    if ctx.kind != "render" or ctx.trace is None or not ctx.items:
        return None
    try:
        from plutracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    rec = recorded() if recorded else None
    if rec is None or "plu.render" not in rec["spans"]:
        return None
    own = sum(v for k, v in rec["counters"].items() if k.startswith("launches."))
    return (ctx.trace.launches - own) / ctx.items
