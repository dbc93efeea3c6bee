"""``kernels.compact_roofline_pct``: the compaction nodes' (B2/B2b) share
of the card's memory bound.  Bytes: the kept rows of every column and the
validity words in, the compacted columns out; time: the device time inside
the compact node ranges."""
from portbench.lib import arith


def read(ctx):
    if ctx.trace is None:
        return None
    nbytes = sum(n["bytes"] for n in ctx.nodes if n["op"] == "compact")
    secs = ctx.trace.device_s_by("pb.node.compact")
    return arith.roofline_pct(nbytes, secs, ctx.card)
