"""render_kernels_roofline: 100 x the least time the card could take for
the window's render work (plubench/work.py: the larger of its bytes over
HBM's rate and its operations over the float32 and int32 rates, counted
by the frozen reference) / the card's busy time in the window (every
kernel, memcpy and memset, whatever its name)."""


def read(ctx):
    if ctx.kind != "render" or ctx.trace is None or ctx.least_s is None:
        return None
    return 100.0 * ctx.least_s / ctx.trace.busy_s
