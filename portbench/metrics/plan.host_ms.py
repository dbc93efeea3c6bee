"""``plan.host_ms``: host milliseconds a study spends in ``Study.run``
outside the plan's nodes and the featurizes (``pb.study`` less
``pb.plan_body`` and the ``FeatureDriver`` ranges): optimizing and
analyzing the plan, reading counts and stats back, realizing cohorts and
the flow."""


def read(ctx):
    if ctx.trace is None:
        return None
    v = ctx.trace.host_outside("pb.study", "pb.plan_body",
                               "pb.node.featurize_dense",
                               "pb.node.featurize_tokens")
    return 1000.0 * sum(v) / len(v) if v else None
