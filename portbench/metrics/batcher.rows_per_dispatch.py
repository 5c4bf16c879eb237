"""Query rows a device dispatch scores, over the window: the batcher's
``coalesced`` count over its ``dispatches`` count."""


def read(ctx):
    d = ctx.counters.get("dispatches")
    return ctx.counters["rows"] / d if d else None
