"""The device's idle time in a traced window, split by what the program's
host was doing, from the program's own spans (its ``Tracer.capture()``
over the window, as (name, start_ns, end_ns) on ``time.monotonic``).

Device-idle intervals are the window less the trace's busy intervals.
Each idle instant is named once, in this order: under a ``runtime.gc``
span (a collection stops every Python thread), else by the piece of the
batcher's dispatcher thread that covers it (the pieces tile that thread):
``batcher.wait`` is an empty queue, ``batcher.sync`` the wake on a
finished group's event and its read-back, and ``stage``, ``issue`` and
``distribute`` the dispatcher's own host work. Idle under no
such span is named by none, so the shares sum to the idle share less it.

The split is as good as the trace's alignment with the host's clock: a
trace placed early by d names up to d of every idle gap by the piece
before it (``sync``) instead of the one it falls in. ``capture_run``
aligns on the marker kernel's launch call for that reason.
"""

from __future__ import annotations

CAUSES = {
    "gc": ("runtime.gc",),
    "empty_queue": ("batcher.wait",),
    "sync": ("batcher.sync",),
    "dispatch_host": ("batcher.stage", "batcher.issue", "batcher.distribute"),
}


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _intersect(xs, ys) -> list[tuple[int, int]]:
    """Two sorted lists of disjoint intervals -> their common parts."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys) -> list[tuple[int, int]]:
    """Sorted disjoint ``xs`` less sorted disjoint ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def idle_intervals(trace) -> list[tuple[int, int]]:
    """The window's device-idle intervals, ns on ``time.monotonic``."""
    edges = [trace.t0] + [x for ab in trace.busy_intervals() for x in ab] + [trace.t1]
    return [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
            if edges[j + 1] > edges[j]]


def split(trace, spans) -> dict[str, float]:
    """Idle seconds by cause (``CAUSES``), each idle instant named once."""
    rest = idle_intervals(trace)
    out = {}
    for cause, names in CAUSES.items():
        under = _intersect(rest, _union((a, b) for n, a, b in spans if n in names))
        out[cause] = sum(b - a for a, b in under) / 1e9
        rest = _subtract(rest, under)
    return out


def share(ctx, cause: str) -> float | None:
    """The window's share, in percent, of device idle named ``cause``; None
    without a trace or without the program's spans."""
    t, spans = ctx.trace, ctx.counters.get("program_spans")
    if t is None or not spans or t.window_s <= 0:
        return None
    return split(t, spans)[cause] / t.window_s * 100.0
