"""Device ms a train step in PyTorch's elementwise and reduction kernels
(trace.kernel_family), over the traced training stretch."""


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "train" else None
    if not tr:
        return None
    fams = tr["families_s"]
    s = fams.get("elementwise", 0.0) + fams.get("reduction", 0.0)
    return 1e3 * s / ctx["trace_steps"]
