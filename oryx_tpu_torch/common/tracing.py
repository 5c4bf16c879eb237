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
- ``Tracer.capture()``: a window in which tracing is on and every finished
  span is also kept whole, beside the ring, so a measured window keeps
  its host timeline however many spans it makes (``/debug/profile``, a
  benchmark's traced run). Span times are ``time.monotonic``.

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
from contextlib import contextmanager
from typing import Iterator, NamedTuple

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
    without scanning the ring. The list is made when the first child
    finishes: a span is one object the interpreter's collector tracks,
    not two, which a captured window of many spans pays for."""

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
        self.children: list["Span"] | None = None

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, {self.duration * 1000:.2f}ms, "
            f"trace={self.trace_id[:8]}..)"
        )


_MAX_CHILDREN = 128  # per-span bound: a runaway handler can't grow a tree
# makes a parent's children list, once, when children finish on two threads
_CHILDREN_LOCK = threading.Lock()


class Capture:
    """The spans finished while a ``Tracer.capture()`` was open, in the
    order they finished, and the window's monotonic edges (``t1`` is None
    while it is open)."""

    __slots__ = ("spans", "t0", "t1")

    def __init__(self):
        self.spans: list[Span] = []
        self.t0 = time.monotonic()
        self.t1: float | None = None


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
        # the span lists of the open captures, rebound (never mutated) so
        # _record reads one tuple lock-free; the enabled state before the
        # first of them opened, restored when the last closes
        self._captures: tuple[list, ...] = ()  # guarded-by: _cfg_lock (writes)
        self._enabled_before = False  # guarded-by: _cfg_lock
        self.last_capture: Capture | None = None

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
            with self._cfg_lock:
                if self._captures:  # takes effect when the last one closes
                    self._enabled_before = bool(enabled)
                else:
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

    @contextmanager
    def capture(self) -> Iterator[Capture]:
        """Tracing on for the block, and every span finished inside it kept
        in the yielded ``Capture`` with no bound (the ring still keeps its
        last ``capacity``). On exit the enabled state goes back to what it
        was before the first open capture, and the capture stays readable,
        also as ``last_capture``. Captures may overlap, from any threads."""
        cap = Capture()
        with self._cfg_lock:
            if not self._captures:
                self._enabled_before = self.enabled
            self._captures = self._captures + (cap.spans,)
            self.enabled = True
        try:
            yield cap
        finally:
            with self._cfg_lock:
                self._captures = tuple(
                    c for c in self._captures if c is not cap.spans)
                if not self._captures:
                    self.enabled = self._enabled_before
            cap.t1 = time.monotonic()
            self.last_capture = cap

    def _record(self, span: Span) -> None:
        span.seq = next(self._seq)
        buf = self._buf
        buf[span.seq % len(buf)] = span
        for spans in self._captures:
            spans.append(span)
        p = span.parent
        if p is not None:
            kids = p.children
            if kids is None:
                with _CHILDREN_LOCK:
                    if p.children is None:
                        p.children = []
                    kids = p.children
            if len(kids) < _MAX_CHILDREN:
                kids.append(span)

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
            for c in span.children or ()
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


# -- cross-process stitching ------------------------------------------------
#
# One process's ring answers "where did this request's latency go HERE";
# a fleet answers it only when the front's span tree and every replica's
# can be laid side by side under one trace id. The helpers below take
# span FORESTS (the /debug/traces JSON shape, which crosses process
# boundaries as plain dicts) from N processes and stitch them: grouped
# by trace id, or exported as one Chrome trace with a LANE PER PROCESS
# (Perfetto renders each pid as its own track, so front queueing vs
# replica dispatch vs device time line up on the shared wall clock).


def flatten_forest(roots: list[dict]) -> list[dict]:
    """Forest (nested ``children``) -> flat span list, children stripped.
    Tolerant of foreign dicts: nodes without a trace_id are dropped."""
    out: list[dict] = []
    stack = [r for r in roots if isinstance(r, dict)]
    while stack:
        node = stack.pop()
        kids = node.get("children") or []
        stack.extend(k for k in kids if isinstance(k, dict))
        if node.get("trace_id"):
            flat = {k: v for k, v in node.items() if k != "children"}
            out.append(flat)
    return out


def stitch_traces(
    processes: list[tuple[str, list[dict]]]
) -> list[dict]:
    """[(process label, span forest)] -> one entry per trace id, spans
    labeled with their owning process, ordered by earliest span start.
    Duplicate span ids across sources (co-resident processes sharing a
    ring in tests) keep the first occurrence only."""
    by_trace: dict[str, list[dict]] = {}
    seen: set[tuple[str, str]] = set()
    for label, forest in processes:
        for span in flatten_forest(forest):
            key = (span["trace_id"], span.get("span_id", ""))
            if key in seen:
                continue
            seen.add(key)
            by_trace.setdefault(span["trace_id"], []).append(
                {"process": label, **span}
            )
    out = []
    for trace_id, spans in by_trace.items():
        spans.sort(key=lambda s: s.get("start_ms", 0.0))
        out.append({
            "trace_id": trace_id,
            "processes": sorted({s["process"] for s in spans}),
            "spans": spans,
        })
    out.sort(key=lambda t: t["spans"][0].get("start_ms", 0.0))
    return out


def stitched_chrome(processes: list[tuple[str, list[dict]]]) -> dict:
    """[(process label, span forest)] -> Chrome trace-event JSON with one
    pid lane per process (``process_name`` metadata names the lanes), so
    the stitched artifact opens in Perfetto with the front and each
    replica as separate tracks on the shared wall-clock timebase."""
    events: list[dict] = []
    seen: set[tuple[str, str]] = set()
    for pid, (label, forest) in enumerate(processes, start=1):
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": label},
        })
        for span in flatten_forest(forest):
            key = (span["trace_id"], span.get("span_id", ""))
            if key in seen:
                continue
            seen.add(key)
            events.append({
                "name": span.get("name", "?"),
                "cat": "oryx-fleet",
                "ph": "X",
                "ts": float(span.get("start_ms", 0.0)) * 1000.0,
                "dur": max(0.0, float(span.get("duration_ms", 0.0))) * 1000.0,
                "pid": pid,
                "tid": 1,
                "args": {
                    "process": label,
                    "trace_id": span["trace_id"],
                    "span_id": span.get("span_id", ""),
                    "parent_id": span.get("parent_id") or "",
                    **(span.get("attrs") or {}),
                },
            })
    return {"displayTimeUnit": "ms", "traceEvents": events}


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
