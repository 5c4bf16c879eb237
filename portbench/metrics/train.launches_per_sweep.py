"""Kernels launched a sweep: the kernels in the traced window over the
sweeps it ran."""


def read(ctx):
    sweeps = ctx.counters.get("sweeps")
    if ctx.trace is None or not sweeps:
        return None
    return ctx.trace.count(kernels_only=True) / sweeps
