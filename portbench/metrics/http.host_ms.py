"""Host milliseconds a request spends in the HTTP front end (parse, auth,
serialize and write), the mean over the window: the program's phase
ledger, ``oryx_request_phase_seconds`` sums over counts on /metrics."""

FRONT = ("parse", "auth", "serialize", "write")


def read(ctx):
    phases = ctx.counters.get("phases") or {}
    n = phases.get("parse", [0, 0])[1]
    if not n:
        return None
    return sum(phases.get(p, [0, 0])[0] for p in FRONT) / n * 1e3
