"""``features.roofline_pct``: the featurizes' share of the card's memory
bound.  Bytes: the cohort's event columns each export reads, once, and the
design matrix, token and mask tensors written once; time: the device time
inside the featurize ranges."""
from portbench.lib import arith

OPS = ("featurize_dense", "featurize_tokens")


def read(ctx):
    if ctx.trace is None:
        return None
    nbytes = sum(n["bytes"] for n in ctx.nodes if n["op"] in OPS)
    secs = sum(ctx.trace.device_s_by(f"pb.node.{op}") for op in OPS)
    return arith.roofline_pct(nbytes, secs, ctx.card)
