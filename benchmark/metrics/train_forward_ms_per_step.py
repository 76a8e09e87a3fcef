"""train_forward_ms_per_step: the host time of the train step's forward
(the plain path under autograd, every query on K1), the inclusive time of
the program's plu.train.forward spans (utils/profiling, recorded while
the profiler traces the window), over the steps the window completed.
None where the window has no device trace or the program recorded no
such span."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.items:
        return None
    try:
        from plutracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    span = recorded()["spans"].get("plu.train.forward") if recorded else None
    return None if span is None else 1e-6 * span["inclusive_ns"] / ctx.items
