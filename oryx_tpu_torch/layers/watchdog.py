"""Shared wedge-watchdog for the lambda tiers (the port's copy of
oryx_tpu/layers/watchdog.py; the JAX package also writes each wedge
transition to its flight recorder, which comes with ROADMAP queue 1 item 4).

A device call inside a model build or fold-in can hang forever on a
broken accelerator transport, and a hung C call cannot be cancelled
in-process — the honest contract is loud, repeated detection plus a
scrape-visible gauge (the reference leaned on the Spark UI for the same
visibility). Both layers share this mechanism; each exposes
``watchdog_limit_sec`` / ``watchdog_poll_sec`` so tests can tighten them.

Beyond the log lines, a tripped watchdog now exports STATE: the layer's
``wedged`` flag, an ``oryx_wedged{layer}`` gauge, and the process-wide
``wedged_layers()`` view that serving readiness (/healthz) and chaos
tests consume — a wedged tier must be observable by a probe, not only by
someone tailing logs. The flag clears itself when the stuck work
finishes or new work starts (the stamp changing), so a transient stall
that resolves flips readiness back without a restart.
"""

from __future__ import annotations

import threading
import time
import weakref

from oryx_tpu_torch.common.metrics import GaugeSeriesGone

# layer label -> weakref to the watched layer object; feeds both the
# oryx_wedged gauge callbacks and wedged_layers(). Labels are stable per
# tier ("batch", "speed"), so a restarted layer simply supersedes the old
# entry.
_watched: dict[str, "weakref.ref"] = {}
_watched_lock = threading.Lock()


def running_seconds(layer_ref, attr: str) -> float:
    """Gauge callback: elapsed seconds of the in-flight work, 0 when idle.
    Weak ref so the process-global registry never pins a layer; single
    attribute read because the work can finish concurrently."""
    layer = layer_ref()
    if layer is None:
        raise GaugeSeriesGone("layer gone")
    started = getattr(layer, attr)
    return time.monotonic() - started if started is not None else 0.0


def _wedged_value(layer_ref) -> float:
    layer = layer_ref()
    if layer is None:
        raise GaugeSeriesGone("layer gone")
    return 1.0 if getattr(layer, "wedged", False) else 0.0


_WEDGED_HELP = (
    "1 while the layer's in-flight work has exceeded its watchdog "
    "limit (a likely-wedged accelerator transport); clears when the "
    "work completes or new work starts"
)


def ensure_metrics() -> None:
    """Register the oryx_wedged gauge (empty) so serving-only processes
    expose the family from start — readiness dashboards need the name
    present before the first co-resident layer ever wedges."""
    from oryx_tpu_torch.common.metrics import get_registry

    get_registry().gauge("oryx_wedged", _WEDGED_HELP, labeled=True)


def wedged_layers() -> list[str]:
    """Labels of currently-wedged layers in this process — the readiness
    input for /healthz and the chaos suite's observability assertion."""
    out: list[str] = []
    with _watched_lock:
        items = list(_watched.items())
    for label, ref in items:
        layer = ref()
        if layer is not None and getattr(layer, "wedged", False):
            out.append(label)
    return sorted(out)


def start_wedge_watchdog(
    layer, attr: str, what: str, log, name: str, label: str | None = None
) -> threading.Thread:
    """Daemon thread that logs an error while ``getattr(layer, attr)``
    stays set past ``layer.watchdog_limit_sec``, re-warning once per limit
    interval and resetting per piece of work (the started stamp changing
    resets the clock even if the idle gap fell between two polls).

    ``label`` names the layer in the ``oryx_wedged`` gauge and in
    ``wedged_layers()``; it defaults to `what`'s first word."""
    label = label or what.split()[0]
    layer.wedged = False
    ref = weakref.ref(layer)
    with _watched_lock:
        _watched[label] = ref
    from oryx_tpu_torch.common.metrics import get_registry

    get_registry().gauge(
        "oryx_wedged", _WEDGED_HELP, labeled=True,
    ).set_function(lambda: _wedged_value(ref), layer=label)

    def watch() -> None:
        warned_for: float | None = None
        warned_at = 0.0
        while not layer._stop.wait(layer.watchdog_poll_sec):
            limit = layer.watchdog_limit_sec
            started = getattr(layer, attr)
            if started is None:
                # idle: the stuck work (if any) finished — readiness heals
                if layer.wedged:
                    layer.wedged = False
                    log.warning("%s un-wedged (work completed)", what)
                continue
            if started != warned_for:
                # new piece of work: its clock starts fresh
                if layer.wedged:
                    layer.wedged = False
                    log.warning("%s un-wedged (new work started)", what)
                warned_for, warned_at = started, 0.0
            elapsed = time.monotonic() - started
            if elapsed > limit and elapsed - warned_at > limit:
                warned_at = elapsed
                layer.wedged = True
                log.error(
                    "%s has been running %.0fs (> %.0fs limit) — likely a "
                    "wedged accelerator transport; the call cannot be "
                    "cancelled in-process, restart the layer if the device "
                    "is known dead",
                    what, elapsed, limit,
                )

    t = threading.Thread(target=watch, name=name, daemon=True)
    t.start()
    return t
