"""launches_per_step: the kernel records of the traced window, of any
name, over the train steps the window completed."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.items:
        return None
    return ctx.trace.launches / ctx.items
