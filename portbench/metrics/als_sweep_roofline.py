"""The sweep kernels' share of their roofline: the least time the
window's sweeps could take (``counts/als_sweep.py``, the work the kept
interactions need, at the f32 peak of ``peaks.py``: the products run in
f32 with TF32 off) over the device time of every kernel in the traced
window, in percent."""


def read(ctx):
    c = ctx.counters
    if ctx.trace is None or not c.get("sweeps"):
        return None
    device_s = sum(ctx.trace.seconds_by_name(kernels_only=True).values())
    if device_s <= 0:
        return None
    ops, n_bytes = ctx.counts("als_sweep").sweep(
        c["users"], c["items"], c["kept_u"], c["kept_i"], c["features"])
    bound = max(ops / ctx.peaks["float32_flops"], n_bytes / ctx.peaks["hbm_bytes_per_s"])
    return bound * c["sweeps"] / device_s * 100.0
