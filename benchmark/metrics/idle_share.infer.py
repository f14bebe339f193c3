"""Share of the traced stretch of engine iterations in which the device
runs nothing, in %: 1 - the union of kernel, copy and memset intervals
(busy_s) over the stretch's length (window_s)."""


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "infer" else None
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
