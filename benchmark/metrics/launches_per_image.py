"""launches_per_image: the kernel records of the traced window, of any
name, over the images the window completed."""


def read(ctx):
    if ctx.kind != "render" or ctx.trace is None or not ctx.items:
        return None
    return ctx.trace.launches / ctx.items
