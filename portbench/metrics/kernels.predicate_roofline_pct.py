"""``kernels.predicate_roofline_pct``: the predicate nodes' (B1) share of
the card's memory bound.  Bytes: the columns the predicate reads and the
validity words in, the words out; time: the device time inside their node
ranges."""
from portbench.lib import arith
from portbench.lib.spans import PREDICATE_OPS


def read(ctx):
    if ctx.trace is None:
        return None
    nbytes = sum(n["bytes"] for n in ctx.nodes if n["op"] in PREDICATE_OPS)
    secs = sum(ctx.trace.device_s_by(f"pb.node.{op}") for op in PREDICATE_OPS)
    return arith.roofline_pct(nbytes, secs, ctx.card)
