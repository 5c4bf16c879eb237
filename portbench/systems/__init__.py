"""Drivers of the program, one module a kind of system, found by the
``system`` key of a configuration file. Each has ``run(spec) -> Outcome``:
set-up, the measured window, and the check of what the window produced.
"""

from __future__ import annotations

import resource
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


def span_ns(t: float) -> int:
    """A ``time.monotonic()`` reading in nanoseconds."""
    return int(t * 1e9)


class Setup:
    """Set-up's seconds, piece by piece, from process start to ``close()``
    (the first timed request or sweep)."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.pieces: dict[str, float] = {}
        self.seconds: float | None = None

    @contextmanager
    def piece(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.pieces[name] = self.pieces.get(name, 0.0) + time.monotonic() - t0

    def close(self) -> float:
        self.seconds = time.monotonic() - self.t_start
        return self.seconds


def cpu_s() -> float:
    """This process's CPU seconds so far, user and system: over a window,
    beside its answers, whether a slow window spent more CPU an answer or
    waited for it."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


@dataclass
class RunSpec:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    setup: Setup


@dataclass
class Outcome:
    end_to_end: dict            # metric name -> value (setup_s is the harness's)
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict                # number compared -> value; limits are the config's
    counters: dict = field(default_factory=dict)
    trace: object = None        # portbench.trace.DeviceTrace of a --trace 1 run
    spans: list = field(default_factory=list)  # (name, start_ns, end_ns) host spans
