"""95th percentile of the client latency of every request sent in the
window, send to last byte, in milliseconds. A closed loop of a fixed
number of connections runs the serial dispatcher at its capacity, where
a tail swings with every stall of the host: it is read here, beside
``recommend_qps``, and not bounded."""


def read(ctx):
    return ctx.counters.get("latency_p95_ms")
