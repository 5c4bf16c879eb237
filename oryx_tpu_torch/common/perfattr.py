"""Hot-path latency attribution: request phase budgets (the port's copy of
the request half of oryx_tpu/common/perfattr.py).

Every request carries a ``PhaseLedger`` — a cheap append-only list of
``(phase, start, seconds)`` stamps the frontends and the batcher fill in
as the request traverses parse → auth → queue_wait → device → serialize
→ write. The frontend flushes the ledger once after the response bytes
are written: each stamp lands in the ``oryx_request_phase_seconds{phase}``
histogram (with metric→trace exemplars) and — when tracing is on — as a
``phase.<name>`` child span under the request's root span. A rolling
window of stamps backs ``budget()``: per-phase p50/p99 and share of the
total, the "latency budget" /healthz advertises.

The ledger/stamp path is always on; ``oryx.monitoring.perfattr.enabled =
false`` only disables the budget window, never the raw histogram.

Not ported yet (ROADMAP queue 1, the batcher's watchdog and telemetry):
the device idle-gap classification, the compile telemetry and storm
event, and the burn-triggered profile capture, which need the batcher's
gap accounting, the flight recorder, perfstats and the SLO trackers.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from oryx_tpu_torch.common.metrics import exponential_buckets, get_registry
from oryx_tpu_torch.common.tracing import get_tracer

# Canonical request phases, in hot-path order. The metric label value is
# the tuple entry verbatim. The JAX package's batch_wait, pad and
# host_fallback phases have no counterpart here: the port's batcher neither
# pads nor falls back to the host.
PHASES = (
    "parse",          # socket read -> parsed request, + routing/query build
    "auth",           # credential check
    "queue_wait",     # batcher enqueue -> its group's dispatch issued
    "device",         # device dispatch issue -> results on the host
    "serialize",      # response object -> wire payload bytes
    "write",          # payload bytes -> socket
)

# Phase durations: 10us (a warm auth check) up to ~10s.
PHASE_SECONDS_BUCKETS = exponential_buckets(1e-5, 4.0, 10)

DEFAULT_WINDOW_S = 60.0


class PhaseLedger:
    """Per-request phase stamp accumulator.

    One ledger rides each Request end to end (``Request.ledger`` plus a
    thread-local mirror so the batcher can pick it up without threading
    it through every signature). ``add`` is a GIL-atomic list append —
    stamps may come from the frontend thread, the executor thread, and
    the batcher dispatcher; no lock needed. Flushed exactly once by the
    frontend after the response bytes hit the socket."""

    __slots__ = ("t0", "trace", "trace_id", "_items", "_flushed")

    def __init__(self, trace=None, trace_id: str | None = None):
        self.t0 = time.monotonic()
        self.trace = trace            # root Span (None when tracing off)
        self.trace_id = trace_id or (
            getattr(trace, "trace_id", None) if trace is not None else None
        )
        self._items: list[tuple[str, float, float]] = []
        self._flushed = False

    def add(self, phase: str, seconds: float, start: float | None = None) -> None:
        """Stamp ``seconds`` spent in ``phase`` (monotonic ``start`` when
        the caller has one — enables the trace waterfall span)."""
        if seconds < 0.0 or seconds != seconds:  # negative or NaN clock skew
            return
        self._items.append((phase, -1.0 if start is None else start, seconds))

    def items(self) -> list[tuple[str, float, float]]:
        return list(self._items)

    def total(self) -> float:
        return sum(s for _, _, s in self._items)

    def last_end(self) -> float | None:
        """Monotonic end of the latest stamped phase (None when no stamp
        carries a start). The serialize stamp anchors here so the slice
        between the last attributed phase and response rendering — result
        distribution, post-processing pool handoff, top-n trim — is
        charged to serialize instead of silently vanishing from the
        budget (the >=95% wall-clock coverage contract)."""
        ends = [st + s for _, st, s in self._items if st >= 0.0]
        return max(ends) if ends else None


_tls = threading.local()


def current_ledger() -> PhaseLedger | None:
    return getattr(_tls, "ledger", None)


def swap_ledger(ledger: PhaseLedger | None) -> PhaseLedger | None:
    """Install ``ledger`` as this thread's current ledger, returning the
    previous one (the tracing swap_current idiom — callers restore in a
    finally)."""
    prev = getattr(_tls, "ledger", None)
    _tls.ledger = ledger
    return prev


class PerfAttr:
    """Process-wide latency-attribution accounting: phase histograms +
    rolling budget window."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S):
        self.enabled = True
        self.window_s = float(window_s)
        # rolling stamp windows backing budget(): (t_end, key, seconds)
        self._phase_win: deque[tuple[float, str, float]] = deque()
        self._win_lock = threading.Lock()
        self._register_lock = threading.Lock()
        self.ensure_metrics()

    # -- configuration -----------------------------------------------------

    def configure(self, config) -> None:
        """Adopt the oryx.monitoring.perfattr.* keys (each layer runtime
        calls this at construction; last writer wins, the one-config-
        per-process convention) and start a fresh budget window, so a new
        serving app's budget holds only its own requests."""
        self.enabled = config.get_bool("oryx.monitoring.perfattr.enabled", True)
        self.window_s = float(config.get_float(
            "oryx.monitoring.perfattr.window-sec", DEFAULT_WINDOW_S
        ))
        with self._win_lock:
            self._phase_win.clear()
        self.ensure_metrics()

    # -- request flush -----------------------------------------------------

    def observe_request(self, ledger: PhaseLedger | None) -> None:
        """Flush one request's ledger: phase histograms (+exemplars), the
        rolling budget window and the trace waterfall's phase.* child
        spans. Idempotent per ledger —
        the Deferred/sync response paths can both reach the frontend's
        flush site."""
        if ledger is None or ledger._flushed:
            return
        ledger._flushed = True
        items = ledger.items()
        if not items:
            return
        now = time.monotonic()
        for phase, start, seconds in items:
            self._h_phase.observe(
                seconds, trace_id=ledger.trace_id, phase=phase
            )
        if self.enabled:
            with self._win_lock:
                self._prune(self._phase_win, now)
                for phase, start, seconds in items:
                    self._phase_win.append((now, phase, seconds))
        tr = get_tracer()
        if tr.enabled and ledger.trace is not None:
            for phase, start, seconds in items:
                if start >= 0.0:
                    tr.record_interval(
                        f"phase.{phase}", start, start + seconds,
                        parent=ledger.trace,
                    )

    # -- reading -----------------------------------------------------------

    def _prune(self, dq, now: float) -> None:  # holds _win_lock
        cutoff = now - self.window_s
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    def budget(self) -> dict:
        """Per-window latency budget: per-phase p50/p99/share. The
        /healthz section."""
        now = time.monotonic()
        with self._win_lock:
            self._prune(self._phase_win, now)
            phase_items = list(self._phase_win)
        by_phase: dict[str, list[float]] = {}
        for _, phase, s in phase_items:
            by_phase.setdefault(phase, []).append(s)
        total = sum(s for _, _, s in phase_items)
        phases = {}
        for phase in PHASES:
            vals = by_phase.pop(phase, None)
            if not vals:
                continue
            vals.sort()
            phases[phase] = {
                "count": len(vals),
                "p50_ms": round(_quantile(vals, 0.50) * 1e3, 3),
                "p99_ms": round(_quantile(vals, 0.99) * 1e3, 3),
                "share": round(sum(vals) / total, 4) if total > 0 else 0.0,
            }
        for phase, vals in by_phase.items():  # stamps outside the catalog
            vals.sort()
            phases[phase] = {
                "count": len(vals),
                "p50_ms": round(_quantile(vals, 0.50) * 1e3, 3),
                "p99_ms": round(_quantile(vals, 0.99) * 1e3, 3),
                "share": round(sum(vals) / total, 4) if total > 0 else 0.0,
            }
        return {
            "window_seconds": self.window_s,
            "total_phase_seconds": round(total, 4),
            "phases": phases,
        }

    def healthz_section(self) -> dict:
        return self.budget()

    # -- metrics -----------------------------------------------------------

    def ensure_metrics(self) -> None:
        """Register the attribution families on the global registry (safe
        to call repeatedly; rebinding over the singleton keeps series
        alive across registry.clear() in tests)."""
        reg = get_registry()
        with self._register_lock:
            self._h_phase = reg.histogram(
                "oryx_request_phase_seconds",
                "Per-request time in each hot-path phase (parse, auth, "
                "queue_wait, device, serialize, write), by phase; carries "
                "metric->trace "
                "exemplars when tracing is enabled",
                buckets=PHASE_SECONDS_BUCKETS,
            )


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile of an already-sorted non-empty list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


_default = PerfAttr()


def get_perfattr() -> PerfAttr:
    return _default


def configure_perfattr(config) -> PerfAttr:
    _default.configure(config)
    return _default
