"""train_graph_replays_per_step: the train step's CUDA graph replays (the
program's train.graph_replays counter, utils/profiling, one a step run
as a replay of its captured graphs, counted while the profiler traces the
window) over the steps the window completed. None where the window has
no device trace or the program counted no replay."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.items:
        return None
    try:
        from plutracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    replays = recorded()["counters"].get("train.graph_replays") if recorded else None
    return None if replays is None else replays / ctx.items
