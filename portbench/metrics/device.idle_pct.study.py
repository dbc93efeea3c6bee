"""The share of the traced window in which no kernel, copy or fill ran on
the card (1 - the union of device intervals over the window), in %."""
from portbench.lib import arith


def read(ctx):
    if ctx.trace is None:
        return None
    return arith.idle_pct(ctx.trace.busy_s(), ctx.trace.window_s())
