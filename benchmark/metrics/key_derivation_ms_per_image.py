"""key_derivation_ms_per_image: the host time the program's pass loop
spends deriving its launches' keys on Python ints (fold_in by stratum,
the three-way split, the bounces' fold_in), the inclusive time of its
plu.render.keys spans (utils/profiling, recorded while the profiler
traces the window), over the images the window completed. None where the
window has no device trace or the program recorded no such span."""


def read(ctx):
    if ctx.kind != "render" or ctx.trace is None or not ctx.items:
        return None
    try:
        from plutracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    spans = recorded()["spans"] if recorded else {}
    if "plu.render" not in spans:
        return None
    keys = spans.get("plu.render.keys", {"inclusive_ns": 0})
    return 1e-6 * keys["inclusive_ns"] / ctx.items
