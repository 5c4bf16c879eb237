"""Host milliseconds of the batcher's dispatcher thread a dispatch, outside
its waits on an empty queue and on a group's results: its ``stage``,
``issue`` and ``distribute`` pieces over the window, from the program's
always-on ``seconds_by_piece`` counters
(``oryx_topk_dispatcher_seconds_total``), over the window's dispatches."""

HOST = ("stage", "issue", "distribute")


def read(ctx):
    pieces, d = ctx.counters.get("dispatcher_seconds"), ctx.counters.get("dispatches")
    if not pieces or not d:
        return None
    return sum(pieces.get(p, 0.0) for p in HOST) / d * 1e3
