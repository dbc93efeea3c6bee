"""``study.mfu_pct``: the whole study's share of the card's peak, on the
host's clock: the least time of each study in the untraced window (the
input columns its shape reads and the outputs it hands back, each byte
once, over the memory rate; its operations are far below the compute
bound) over that window's length.  Reported in a traced run, from the
untraced window that precedes the traced one."""
from portbench.lib import arith


def read(ctx):
    moved = ctx.out.get("moved")
    if not moved or ctx.out["window_s"] <= 0:
        return None
    least = sum(arith.least_seconds(b, ctx.card) for b in moved)
    return 100.0 * least / ctx.out["window_s"]
