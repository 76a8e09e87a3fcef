"""device_idle_pct.render: 100 x (1 - the union of the card's kernel,
memcpy and memset intervals / the traced window), over a render window."""


def read(ctx):
    if ctx.kind != "render" or ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share
