"""Mean milliseconds a request waits in the top-k batcher's queue before
its dispatch is issued: the ``queue_wait`` phase of the program's phase
ledger on /metrics, over the window."""


def read(ctx):
    s, n = (ctx.counters.get("phases") or {}).get("queue_wait", [0, 0])
    return s / n * 1e3 if n else None
