"""``flatten.roofline_pct``: the flatten joins' share of the card's memory
bound.  Bytes: each join's left key and right table read once, and the
columns it adds to the rows it hands on written once; time: the device
time of the kernels launched inside the joins' node ranges."""
from portbench.lib import arith
from portbench.lib.spans import JOIN_OPS


def read(ctx):
    if ctx.trace is None:
        return None
    nbytes = sum(n["bytes"] for n in ctx.nodes if n["op"] in JOIN_OPS)
    secs = sum(ctx.trace.device_s_by(f"pb.node.{op}") for op in JOIN_OPS)
    return arith.roofline_pct(nbytes, secs, ctx.card)
