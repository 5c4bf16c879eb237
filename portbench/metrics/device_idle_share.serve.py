"""Share of the traced serving window in which no operation ran on the
device, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s() / t.window_s) * 100.0
