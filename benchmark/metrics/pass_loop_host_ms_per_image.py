"""pass_loop_host_ms_per_image: the host time of the program's pass loop,
the inclusive time of its plu.render spans (one an image: the program's
utils/profiling record, kept while the profiler traces the window), over
the images the window completed. None where the window has no device
trace or the program recorded no such span (a program without the
registry)."""


def read(ctx):
    if ctx.kind != "render" or ctx.trace is None or not ctx.items:
        return None
    try:
        from plutracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    span = recorded()["spans"].get("plu.render") if recorded else None
    return None if span is None else 1e-6 * span["inclusive_ns"] / ctx.items
