"""The window's train-step conv FLOP (forward, weight and input gradients,
none into the image) over its wall time, as a share of the card's bf16
peak, in %."""


def read(ctx):
    peak = ctx["peaks"].get(ctx.get("device_kind"), {})
    if ctx.get("kind") != "train" or "bf16_flop_per_s" not in peak:
        return None
    rate = ctx["flop_per_step"] * ctx["steps"] / ctx["wall_s"]
    return 100.0 * rate / peak["bf16_flop_per_s"]
