"""Device ms a case of the windowed forward and blend over the window's
cases: CUDA events recorded around the engine's call of
sliding_window_inference, which the benchmark wraps."""


def read(ctx):
    times = ctx.get("forward_ms") if ctx.get("kind") == "infer" else None
    if not times:
        return None
    return sum(times) / len(times)
