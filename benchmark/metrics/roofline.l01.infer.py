"""The bound of the work of level group "l01" (the traffic's level_groups)
in one volume's forwards, the larger of its conv FLOP over the bf16 peak
and its boundary bytes over the HBM rate, over the device time of the
group's levels a volume (CUDA events at the top-level modules), in %."""

GROUP = "l01"


def read(ctx):
    peak = ctx["peaks"].get(ctx.get("device_kind"), {})
    levels = ctx.get("level_ms_per_case")
    if ctx.get("kind") != "infer" or not levels or not peak:
        return None
    work = ctx["group_work"][GROUP]
    ms = sum(levels.get(lv, 0.0) for lv in ctx["level_groups"][GROUP])
    if ms <= 0:
        return None
    bound_ms = 1e3 * max(work["flop"] / peak["bf16_flop_per_s"],
                         work["bytes"] / peak["hbm_bytes_per_s"])
    return 100.0 * bound_ms / ms
