"""The window's conv FLOP (the network's algebra over every case
completed) over its wall time, as a share of the card's bf16 peak, in %."""


def read(ctx):
    peak = ctx["peaks"].get(ctx.get("device_kind"), {})
    if ctx.get("kind") != "infer" or "bf16_flop_per_s" not in peak:
        return None
    rate = ctx["flop_per_case"] * ctx["cases"] / ctx["wall_s"]
    return 100.0 * rate / peak["bf16_flop_per_s"]
