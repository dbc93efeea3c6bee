"""``transforms.device_ms``: device milliseconds a study spends in its
transform nodes (exposures, fractures, follow-up)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["attempted"]:
        return None
    secs = ctx.trace.device_s_by("pb.node.transform")
    if secs <= 0:
        return None
    return 1000.0 * secs / ctx.traced["attempted"]
