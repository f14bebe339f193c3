"""Host ms a batch in the window's calls of the DeviceLoader."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["loader_ms"]
