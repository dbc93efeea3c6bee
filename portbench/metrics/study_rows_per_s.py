"""``study_rows_per_s``: the rows of the tables each completed study reads,
summed over the window, over the window's length (from its start to the end
of the last study begun before the deadline)."""


def read(ctx):
    out = ctx.out
    if "rows" not in out or out["window_s"] <= 0:
        return None
    return out["rows"] / out["window_s"]
