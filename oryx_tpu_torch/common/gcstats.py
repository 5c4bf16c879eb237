"""The interpreter's collections, as the program sees them: one
``gc.callbacks`` hook, installed once when a serving layer starts.

A collection stops every Python thread of the process (the event loops,
the worker pool, the batcher's dispatcher), so while it runs the card can
only drain what was already queued. The hook keeps, always on and per
generation (0, 1, 2):

- ``oryx_gc_collections_total{generation}`` — collections run;
- ``oryx_gc_pause_seconds_total{generation}`` — seconds inside them;

and, while tracing is on (``oryx.monitoring.tracing.enabled`` or an open
``Tracer.capture()``), records one ``runtime.gc`` span a collection with
its ``generation`` and ``collected`` count, on the ``time.monotonic``
clock of every other span.
"""

from __future__ import annotations

import gc
import threading
import time

from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.tracing import get_tracer

GENERATIONS = (0, 1, 2)

# written only by the hook, which runs with the interpreter lock held and
# one collection at a time; scrapes read the floats as they stand
collections = [0, 0, 0]
pause_seconds = [0.0, 0.0, 0.0]
_started = [0.0]

_TRACER = get_tracer()
_install_lock = threading.Lock()
_installed = False


def _hook(phase: str, info: dict) -> None:
    if phase == "start":
        _started[0] = time.monotonic()
        return
    t1 = time.monotonic()
    t0 = _started[0]
    gen = info.get("generation", 2)
    collections[gen] += 1
    pause_seconds[gen] += t1 - t0
    if _TRACER.enabled:
        _TRACER.record_interval("runtime.gc", t0, t1, generation=gen,
                                collected=info.get("collected", 0))


def install() -> None:
    """Add the hook to ``gc.callbacks`` once per process, and bind its two
    counter families on the registry (again on every call, as
    ``TopKBatcher.register_gauges`` does, so a cleared registry gets them
    back)."""
    global _installed
    reg = get_registry()
    count = reg.counter(
        "oryx_gc_collections_total",
        "collections of the Python interpreter's cyclic collector in this "
        "process, by generation", labeled=True)
    pause = reg.counter(
        "oryx_gc_pause_seconds_total",
        "seconds every Python thread of this process stood still in the "
        "interpreter's collections, by generation", labeled=True)
    for g in GENERATIONS:
        count.set_function(lambda g=g: float(collections[g]), generation=str(g))
        pause.set_function(lambda g=g: pause_seconds[g], generation=str(g))
    with _install_lock:
        if not _installed:
            gc.callbacks.append(_hook)
            _installed = True
