"""The top-k kernels' share of their roofline in the traced window: the
least time the window's dispatches could take (``counts/topk.py``, at the
peaks of ``peaks.py`` for the view the cell serves) over the device time
of ``topk_dot_partial`` and ``topk_merge`` in the trace, in percent."""

KERNELS = ("topk_dot_partial", "topk_merge")


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.seconds_matching(KERNELS)
    c = ctx.counters
    if device_s <= 0 or not c.get("dispatches"):
        return None
    topk = ctx.counts("topk")
    view = topk.view(c["score_mode"])
    ops, n_bytes = topk.work(c["dispatches"], c["rows"], c["items"], c["features"],
                             view["itemsize"], c["k"], view["row_scale_bytes"])
    bound = topk.bound_s(ops, n_bytes, ctx.peaks[view["peak"]], ctx.peaks["hbm_bytes_per_s"])
    return bound / device_s * 100.0
