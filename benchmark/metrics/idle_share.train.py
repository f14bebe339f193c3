"""Share of the window's wall time a train step in which the device runs
nothing, in %: 1 - the device busy time a step in the traced stretch (the
union of kernel, copy and memset intervals, from the trace) over the
untraced window's wall time a step. The two stretches run the same step on
crops of one shape. The stretch's own length is not used: the profiler's
cost per launch makes the launch-bound step host-bound under it (a noatt
stretch read 3.1-30.8 % idle within itself while its window's steps ran
within 1.5-3.8 % of the trace's busy time a step)."""


def read(ctx):
    tr = ctx.get("trace") if ctx.get("kind") == "train" else None
    if not tr or not ctx.get("steps"):
        return None
    busy = tr["busy_s"] / ctx["trace_steps"]
    return 100.0 * (1.0 - busy / (ctx["wall_s"] / ctx["steps"]))
