"""Lightweight end-to-end tracing: spans, ring buffer, W3C propagation (the
port's copy of oryx_tpu/common/tracing.py).

The reference delegates all observability to the Spark UI and rate-limited
log lines (SURVEY.md §5); the Prometheus registry (common/metrics.py)
adds aggregate counters, but counters cannot answer the question a lambda
architecture lives or dies by: *where did this request's latency go* —
header parse vs.
route vs. batcher queue-wait vs. device dispatch. tf.data (arXiv
2101.12127) and TensorFlow (arXiv 1605.08695) both attribute pipeline time
to stages for exactly this reason. This module is the substrate:

- ``Span``: name + attrs + parent + monotonic start/end, grouped by a
  128-bit trace id. Spans form trees: an HTTP request span parents the
  auth/dispatch/respond stages and the micro-batcher's queue-wait and
  device spans, even across the worker-pool thread hop.
- A bounded per-process ring buffer of finished spans. Writers claim slots
  through an ``itertools.count`` (atomic under the GIL) — no lock on the
  record path, the oldest span is simply overwritten.
- W3C ``traceparent`` parse/format, so external callers can stitch serving
  spans into their own traces and bus publish stamps can carry the batch
  generation's context to the serving tier (common/freshness.py).
- Export as a span forest (``/debug/traces``) or Chrome trace-event JSON
  (``?format=chrome``) that opens directly in Perfetto.

Tracing is OFF by default (``oryx.monitoring.tracing.enabled``); every
instrumentation site guards on ``tracer.enabled``, so the disabled cost is
one attribute read per request.

Span-name families emitted by the serving hot path (the /fleet/traces
waterfall groups on these): ``http.request`` roots with ``http.parse`` /
``http.auth`` / ``http.dispatch`` / ``http.respond`` stages, and
``phase.<name>`` children replayed from each
request's phase ledger (``phase.parse`` … ``phase.write``) so the
latency-budget phases line up under the request root even when a phase
ran on another thread.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import threading
import time
from typing import NamedTuple

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# Anchor for converting monotonic span times to wall-clock microseconds in
# exports (Chrome trace events want an absolute-ish timebase so separate
# dumps line up).
_WALL_ANCHOR = time.time()
_MONO_ANCHOR = time.monotonic()


def wall_time_us(monotonic_t: float) -> float:
    """Monotonic timestamp -> wall-clock microseconds since the epoch."""
    return (_WALL_ANCHOR + (monotonic_t - _MONO_ANCHOR)) * 1e6


class SpanContext(NamedTuple):
    """Just the ids — what propagation headers carry."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str   # 16 lowercase hex chars


def parse_traceparent(value: str | None) -> SpanContext | None:
    """W3C trace-context ``traceparent`` -> SpanContext, or None when the
    header is absent/malformed (per spec, invalid headers are ignored and
    a new trace starts)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":  # forbidden by the spec
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:  # all-zero ids invalid
        return None
    return SpanContext(trace_id, span_id)


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One timed operation. Finished child spans append themselves to
    ``children`` (bounded) so a slow-request log can print the breakdown
    without scanning the ring."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "parent",
        "start", "end", "attrs", "tid", "seq", "children",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        parent_id: str | None,
        start: float,
        attrs: dict,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.parent: "Span | None" = None
        self.start = start
        self.end: float | None = None
        self.attrs = attrs
        self.tid = threading.get_ident()
        self.seq = -1
        self.children: list["Span"] = []

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, {self.duration * 1000:.2f}ms, "
            f"trace={self.trace_id[:8]}..)"
        )


_MAX_CHILDREN = 128  # per-span bound: a runaway handler can't grow a tree


class Tracer:
    """Span factory + bounded ring buffer of finished spans.

    The record path is lock-free-ish: slot indices come from an
    ``itertools.count`` (its ``next`` is a single C call, atomic under the
    GIL) and list item assignment is likewise atomic, so concurrent
    writers — event loops, worker threads, the batcher dispatcher — never
    block each other; at worst two spans race for the same wrapped slot
    and one overwrites the other, which a *bounded* buffer accepts by
    design.
    """

    def __init__(self, capacity: int = 2048):
        self.enabled = False
        self.slow_threshold: float | None = None
        # the ring and its slot counter are REBOUND together (configure's
        # capacity change, clear) under _cfg_lock so a concurrent
        # reconfigure can't pair a fresh counter with the old buffer.
        # Writes-only guarding: slot writes in _record and snapshot reads
        # bind the list locally and are seq-claimed lock-free by design.
        self._cfg_lock = threading.Lock()
        self._buf: list[Span | None] = [None] * max(16, capacity)  # guarded-by: _cfg_lock (writes)
        self._seq = itertools.count()  # guarded-by: _cfg_lock (writes)

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def configure(
        self,
        enabled: bool | None = None,
        capacity: int | None = None,
        slow_threshold: float | None | type(...) = ...,
    ) -> None:
        if capacity is not None and capacity != len(self._buf):
            with self._cfg_lock:
                self._buf = [None] * max(16, capacity)
                self._seq = itertools.count()
        if enabled is not None:
            self.enabled = bool(enabled)
        if slow_threshold is not ...:
            self.slow_threshold = (
                float(slow_threshold) if slow_threshold is not None else None
            )

    # -- span lifecycle ----------------------------------------------------

    def start(
        self,
        name: str,
        parent: "Span | SpanContext | None" = None,
        start: float | None = None,
        **attrs,
    ) -> Span | None:
        """New span, or None when tracing is disabled (call sites pass the
        None straight back into finish()/record_interval(), which absorb
        it — no branching needed beyond the hot-path ``enabled`` guard).
        ``start`` backdates the span to an already-captured monotonic
        time."""
        if not self.enabled:
            return None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = _new_id(16), None
        s = Span(
            name, trace_id, parent_id,
            start if start is not None else time.monotonic(), attrs,
        )
        if isinstance(parent, Span):
            s.parent = parent
        return s

    def finish(self, span: Span | None, **attrs) -> None:
        if span is None:
            return
        if attrs:
            span.attrs.update(attrs)
        if span.end is None:
            span.end = time.monotonic()
        self._record(span)

    def record_interval(
        self,
        name: str,
        start: float,
        end: float | None = None,
        parent: "Span | SpanContext | None" = None,
        **attrs,
    ) -> Span | None:
        """Create-and-finish in one call, for stages whose edges were
        captured as plain monotonic floats (queue-wait, header parse)."""
        if not self.enabled:
            return None
        s = self.start(name, parent=parent, start=start, **attrs)
        if s is not None:
            s.end = end if end is not None else time.monotonic()
            self._record(s)
        return s

    def _record(self, span: Span) -> None:
        span.seq = next(self._seq)
        buf = self._buf
        buf[span.seq % len(buf)] = span
        p = span.parent
        if p is not None and len(p.children) < _MAX_CHILDREN:
            p.children.append(span)

    # -- reading -----------------------------------------------------------

    def snapshot(self) -> list[Span]:
        """Finished spans currently in the ring, oldest first."""
        spans = [s for s in list(self._buf) if s is not None and s.end is not None]
        spans.sort(key=lambda s: s.seq)
        return spans

    def clear(self) -> None:
        with self._cfg_lock:
            self._buf = [None] * len(self._buf)

    # -- slow-request log --------------------------------------------------

    def log_if_slow(self, span: Span | None, logger: logging.Logger) -> None:
        """WARN with the full per-stage breakdown when a finished request
        span exceeds ``oryx.monitoring.slow-request-threshold``."""
        th = self.slow_threshold
        if th is None or span is None or span.end is None:
            return
        total = span.duration
        if total < th:
            return
        stages = ", ".join(
            f"{c.name}={c.duration * 1000.0:.1f}ms"
            for c in span.children
            if c.end is not None
        )
        logger.warning(
            "slow request %s %s: %.1f ms total (threshold %.0f ms)%s",
            span.attrs.get("method", "?"),
            span.attrs.get("target", span.name),
            total * 1000.0,
            th * 1000.0,
            f" — {stages}" if stages else "",
        )


# -- current-span propagation (thread-scoped) -------------------------------
#
# The serving dispatch path is synchronous within one thread (event loop for
# nonblocking routes, a worker-pool thread otherwise): ServingApp sets the
# request span as "current" around _dispatch, and everything the handler
# calls synchronously — notably TopKBatcher.submit_nowait — picks it up as
# the parent without every signature in between carrying a span argument.

_tls = threading.local()


def current_span() -> Span | None:
    return getattr(_tls, "span", None)


def swap_current(span: Span | None) -> Span | None:
    """Install ``span`` as the thread's current span; returns the previous
    one for restoration (always restore in a finally)."""
    prev = getattr(_tls, "span", None)
    _tls.span = span
    return prev


# -- export -----------------------------------------------------------------


def chrome_trace(spans: list[Span]) -> dict:
    """Chrome trace-event JSON (`ph: "X"` complete events) — open the dump
    directly in Perfetto/chrome://tracing (a wall-clock timebase, so
    separate dumps line up)."""
    pid = os.getpid()
    events = []
    for s in spans:
        events.append({
            "name": s.name,
            "cat": "oryx",
            "ph": "X",
            "ts": wall_time_us(s.start),
            "dur": max(0.0, s.duration) * 1e6,
            "pid": pid,
            "tid": s.tid,
            "args": {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id or "",
                **s.attrs,
            },
        })
    return {"displayTimeUnit": "ms", "traceEvents": events}


def span_forest(spans: list[Span]) -> list[dict]:
    """Spans -> list of nested trees (roots = spans whose parent is not in
    the snapshot, e.g. evicted from the ring or remote)."""
    nodes: dict[str, dict] = {}
    for s in spans:
        nodes[s.span_id] = {
            "name": s.name,
            "trace_id": s.trace_id,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "start_ms": round(wall_time_us(s.start) / 1000.0, 3),
            "duration_ms": round(s.duration * 1000.0, 3),
            "attrs": dict(s.attrs),
            "children": [],
        }
    roots: list[dict] = []
    for s in spans:
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id) if s.parent_id else None
        if parent is None or parent is node:
            roots.append(node)
        else:
            parent["children"].append(node)
    return roots


# -- process-global tracer --------------------------------------------------

_default = Tracer()


def get_tracer() -> Tracer:
    return _default


def configure_tracing(config) -> Tracer:
    """Apply the oryx.monitoring.* tracing keys to the global tracer (each
    layer runtime calls this at construction; last writer wins, which is
    what one config per process means)."""
    tr = _default
    tr.configure(
        enabled=config.get_bool("oryx.monitoring.tracing.enabled", False),
        capacity=config.get_int("oryx.monitoring.tracing.buffer-size", 2048),
        slow_threshold=config.get("oryx.monitoring.slow-request-threshold", None),
    )
    return tr
