"""Ms a case of the window in which the device runs no forward or blend:
the window's wall time a case less forward_ms.infer. It holds the engine's
serial host work between cases (the label's upload, the Dice, the argmax
copy, the volumetry, the loader and the staging wait) and the small device
work among it; 1 / volumes_per_s is this plus forward_ms.infer."""


def read(ctx):
    times = ctx.get("forward_ms") if ctx.get("kind") == "infer" else None
    if not times or not ctx.get("cases") or len(times) != ctx["cases"]:
        return None
    return 1e3 * ctx["wall_s"] / ctx["cases"] - sum(times) / len(times)
