"""The whole build's share of the card's f32 peak: the operations the
window's sweeps need (``counts/als_sweep.py``) over the window's seconds,
in percent."""


def read(ctx):
    c = ctx.counters
    if not c.get("sweeps"):
        return None
    ops, _ = ctx.counts("als_sweep").sweep(
        c["users"], c["items"], c["kept_u"], c["kept_i"], c["features"])
    return ops * c["sweeps"] / (c["window_s"] * ctx.peaks["float32_flops"]) * 100.0
