"""Runtime device-performance accounting: per-dispatch cost records,
live MFU, occupancy, and on-demand profile windows (the port's copy of
oryx_tpu/common/perfstats.py).

Every device dispatch — a coalesced top-k group in the serving batcher, a
training build in ``ops/als.py train_als`` — reports its analytic FLOPs
(ops/flops.py), bytes moved, wall-clock, and occupancy into a
process-wide ring of ``DispatchRecord``s, from which live
gauges/histograms are derived (the JAX package's family names, so
dashboards read one vocabulary):

- ``oryx_device_mfu{kind}`` — achieved FLOP/s over the card's dense
  peak at the dispatched type (ops/flops.py), over a rolling window
  (``oryx.monitoring.perf.window-sec``). NaN when no peak is known (no
  card, or a card the table does not know) and no
  ``assumed-peak-flops`` override is configured — an unknown peak must
  not render as a confident 0.
- ``oryx_device_flops_per_sec{kind}`` — the achieved numerator alone.
- ``oryx_device_dispatch_seconds{kind}`` — per-dispatch wall-clock,
  launch to results on the host (exponential buckets; carries
  metric→trace exemplars when tracing is enabled).
- ``oryx_dispatch_batch_occupancy{kind}`` — valid rows / rows of the
  scored view. This package's device views hold live rows only and its
  batcher pads no query rows, so serving dispatches read 1.0 by
  construction. Always <= 1.0.
- ``oryx_device_bytes_per_dispatch{kind}`` — approximate bytes the
  dispatch moved (operand streams + host transfers).

The JAX package's ``oryx_device_fallback_dispatches_total`` has no
counterpart: this package scores nothing on the host (a wedge fails its
requests with 503, counted by ``oryx_topk_device_failovers``).

The record path is cheap (a handful of float ops + bounded-ring append +
histogram observes) and always on. ``/debug/profile``
(serving/resources/common.py) captures an on-demand window of these
records and of the program's spans (a ``Tracer.capture()``) as a
Perfetto-loadable artifact; with ``oryx.monitoring.profile.dir`` set it
also writes one Perfetto file of the window in which the card's
operations (``torch.profiler``, aligned by a marker kernel) and the
program's spans share the ``time.monotonic`` timebase.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from oryx_tpu_torch.common.metrics import (
    PROFILER_LOCK,
    exponential_buckets,
    get_registry,
    linear_buckets,
    profiled_window,
)
from oryx_tpu_torch.common.tracing import chrome_trace, get_tracer, wall_time_us

# Rolling window (seconds) the live MFU / FLOP-rate gauges average over.
DEFAULT_WINDOW_S = 60.0

# Per-dispatch wall-clock: 100us (a small warm dispatch) up to ~26s (a
# dispatch behind a cold kernel-library build).
DISPATCH_SECONDS_BUCKETS = exponential_buckets(1e-4, 4.0, 10)

# Occupancy is a ratio in (0, 1]: linear buckets, 0.05 steps (rounded so
# the top bucket renders le="1", not a float-summation tail).
OCCUPANCY_BUCKETS = tuple(round(b, 2) for b in linear_buckets(0.05, 0.05, 20))

# Bytes moved per dispatch: 4 KiB .. 16 GiB.
BYTES_BUCKETS = exponential_buckets(4096.0, 4.0, 12)


class DispatchRecord:
    """One device dispatch's cost accounting."""

    __slots__ = (
        "kind", "t_start", "wall_s", "flops", "bytes_moved",
        "rows", "padded_rows", "valid_rows", "capacity_rows",
        "occupancy", "trace_id", "score_mode", "seq",
    )

    def __init__(
        self,
        kind: str,
        t_start: float,
        wall_s: float,
        flops: float,
        bytes_moved: float,
        rows: int,
        padded_rows: int,
        valid_rows: int,
        capacity_rows: int,
        trace_id: str | None,
        score_mode: str | None = None,
    ):
        self.kind = kind
        self.t_start = t_start
        self.wall_s = wall_s
        self.flops = flops
        self.bytes_moved = bytes_moved
        self.rows = rows
        self.padded_rows = padded_rows
        self.valid_rows = valid_rows
        self.capacity_rows = capacity_rows
        # real rows over the rows of the shape actually scored — always
        # in [0, 1], never
        # NaN: a zero-capacity or empty dispatch (drained shutdown batch,
        # a caller passing garbage rows) must not poison the histogram
        # with a >1.0 or non-finite sample
        if capacity_rows > 0 and valid_rows > 0:
            occ = valid_rows / capacity_rows
            self.occupancy = min(1.0, occ) if occ == occ else 0.0
        else:
            self.occupancy = 0.0
        self.trace_id = trace_id
        # serving score mode (exact | quantized | approx) when the
        # dispatcher labels it; None for unlabeled kinds (train)
        self.score_mode = score_mode
        self.seq = -1

    def chrome_event(self, pid: int) -> dict:
        """This record as a Chrome trace-event `X` slice (Perfetto)."""
        return {
            "name": f"device.dispatch.{self.kind}",
            "cat": "oryx-perf",
            "ph": "X",
            "ts": wall_time_us(self.t_start),
            "dur": max(0.0, self.wall_s) * 1e6,
            "pid": pid,
            "tid": 1 if self.kind == "serving" else 2,
            "args": {
                "flops": self.flops,
                "bytes_moved": self.bytes_moved,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "valid_rows": self.valid_rows,
                "capacity_rows": self.capacity_rows,
                "occupancy": round(self.occupancy, 4),
                "trace_id": self.trace_id or "",
                "score_mode": self.score_mode or "",
            },
        }


class PerfStats:
    """Process-wide dispatch-cost accounting: bounded record ring, rolling
    MFU, and profile-window capture.

    The profile guard (``_capture_lock``) is metrics.PROFILER_LOCK, the one
    that ``maybe_profile`` takes: one process holds one torch profiler.

    Writers claim ring slots through an ``itertools.count`` (atomic under
    the GIL) like the tracing ring — dispatchers and the train loop never
    block each other on the record path."""

    def __init__(self, capacity: int = 4096, window_s: float = DEFAULT_WINDOW_S):
        self._buf: list[DispatchRecord | None] = [None] * max(64, capacity)
        self._seq = itertools.count()
        self.window_s = float(window_s)
        # Exact windowed FLOP accounting, separate from the debug ring:
        # the ring is bounded by SLOTS and silently drops oldest records,
        # so a busy window (> capacity dispatches) would truncate an
        # MFU computed from it exactly when the system is busiest. The
        # per-kind deque + running sum is bounded by TIME instead —
        # pruned on every append/read — so the rolling numerator is exact
        # at any dispatch rate. The ring stays as the /debug/profile and
        # records_since substrate.
        self._win: dict[str, "deque[tuple[float, float]]"] = {}  # guarded-by: _win_lock
        self._win_sum: dict[str, float] = {}  # guarded-by: _win_lock
        self._win_lock = threading.Lock()
        # card peak FLOP/s per kind; Ellipsis = not yet resolved. An
        # operator-configured assumed peak (oryx.monitoring.perf.
        # assumed-peak-flops) stands in where no honest card peak exists.
        self._peak: dict[str, float | None | type(...)] = {}
        self.assumed_peak_flops: float | None = None
        # /debug/profile knobs (oryx.monitoring.profile.*)
        self.profile_enabled = False
        self.profile_max_seconds = 30.0
        self.profile_dir: str | None = None
        self._capture_lock = PROFILER_LOCK
        self._register_lock = threading.Lock()

    # -- configuration -----------------------------------------------------

    def configure(self, config) -> None:
        """Adopt the oryx.monitoring.perf / oryx.monitoring.profile keys
        (each layer runtime calls this at construction; last writer wins,
        the one-config-per-process convention)."""
        self.window_s = float(
            config.get_float("oryx.monitoring.perf.window-sec", DEFAULT_WINDOW_S)
        )
        assumed = config.get("oryx.monitoring.perf.assumed-peak-flops", None)
        self.assumed_peak_flops = float(assumed) if assumed is not None else None
        self.profile_enabled = config.get_bool(
            "oryx.monitoring.profile.enabled", False
        )
        self.profile_max_seconds = float(
            config.get_float("oryx.monitoring.profile.max-seconds", 30.0)
        )
        self.profile_dir = config.get_string("oryx.monitoring.profile.dir", None)

    def ensure_peak(self, kind: str, resolver) -> None:
        """Resolve the card's peak for ``kind`` exactly once (the resolver
        may touch torch.cuda, so never call it on a scrape path)."""
        if self._peak.get(kind, ...) is not ...:
            return
        try:
            self._peak[kind] = resolver()
        except Exception:
            self._peak[kind] = None

    def note_peak(self, kind: str, peak: float | None) -> None:
        """Adopt an already-resolved peak unless one is set."""
        if self._peak.get(kind, ...) is ...:
            self._peak[kind] = peak

    def set_peak(self, kind: str, peak: float | None) -> None:
        """Overwrite the kind's peak unconditionally: the batcher resolves
        a PER-DTYPE peak per dispatch (ops/flops.py tables), so the MFU
        gauge's denominator follows the dtype actually dispatched — a
        quantized int8 window reads against the int8 peak, never
        flattering itself against bf16."""
        self._peak[kind] = peak

    def peak_for(self, kind: str) -> float | None:
        peak = self._peak.get(kind, ...)
        if peak is ... or peak is None:
            return self.assumed_peak_flops
        return peak

    # -- recording ---------------------------------------------------------

    def record_dispatch(
        self,
        kind: str,
        *,
        flops: float,
        bytes_moved: float,
        wall_s: float,
        rows: int,
        padded_rows: int,
        valid_rows: int,
        capacity_rows: int,
        trace_id: str | None = None,
        t_start: float | None = None,
        score_mode: str | None = None,
    ) -> DispatchRecord:
        rec = DispatchRecord(
            kind,
            t_start if t_start is not None else time.monotonic() - wall_s,
            wall_s, flops, bytes_moved, rows, padded_rows, valid_rows,
            capacity_rows, trace_id, score_mode,
        )
        rec.seq = next(self._seq)
        buf = self._buf
        buf[rec.seq % len(buf)] = rec
        with self._win_lock:
            self._prune_window(kind, rec.t_start + wall_s)
            self._win.setdefault(kind, deque()).append(
                (rec.t_start + wall_s, flops)
            )
            self._win_sum[kind] = self._win_sum.get(kind, 0.0) + flops
        self._h_dispatch.observe(wall_s, trace_id=trace_id, kind=kind)
        self._h_occupancy.observe(rec.occupancy, trace_id=trace_id, kind=kind)
        self._h_bytes.observe(bytes_moved, kind=kind)
        if score_mode:
            # per-mode dispatch accounting: dashboards separate exact /
            # quantized / approx traffic without new histogram families
            self._c_score_mode.inc(score_mode=score_mode)
        return rec

    def _prune_window(self, kind: str, now: float) -> None:  # holds _win_lock
        """Drop window entries older than window_s (caller holds
        _win_lock)."""
        dq = self._win.get(kind)
        if not dq:
            return
        cutoff = now - self.window_s
        total = self._win_sum.get(kind, 0.0)
        while dq and dq[0][0] < cutoff:
            total -= dq.popleft()[1]
        self._win_sum[kind] = total if dq else 0.0

    # -- reading -----------------------------------------------------------

    def records_since(self, t: float) -> list[DispatchRecord]:
        """Records whose dispatch started at/after monotonic time t,
        oldest first."""
        recs = [
            r for r in list(self._buf)
            if r is not None and r.t_start >= t
        ]
        recs.sort(key=lambda r: r.seq)
        return recs

    def achieved_flops_per_sec(self, kind: str) -> float:
        """FLOP/s over the rolling window (0.0 when idle). Exact at any
        dispatch rate — the windowed accumulator is time-bounded, unlike
        the slot-bounded debug ring."""
        with self._win_lock:
            self._prune_window(kind, time.monotonic())
            total = self._win_sum.get(kind, 0.0)
        return total / self.window_s if total else 0.0

    def window_occupancy(self, kind: str) -> tuple[float | None, int]:
        """(mean dispatch batch occupancy over the rolling window, number
        of dispatches it averages) — (None, 0) when the window is idle.
        The fleet autoscaler's scale-DOWN signal: sustained low occupancy
        means the padding headroom is mostly waste and the fleet has more
        replicas than the offered load fills."""
        recs = [
            r for r in self.records_since(time.monotonic() - self.window_s)
            if r.kind == kind
        ]
        if not recs:
            return None, 0
        return sum(r.occupancy for r in recs) / len(recs), len(recs)

    def mfu(self, kind: str) -> float:
        """Rolling-window MFU in [0,1]; NaN when no peak (card or assumed)
        is known."""
        peak = self.peak_for(kind)
        if not peak or peak <= 0:
            return float("nan")
        return self.achieved_flops_per_sec(kind) / peak

    # -- profile windows ---------------------------------------------------

    def capture_profile(self, seconds: float) -> dict:
        """Block for ``seconds`` capturing every dispatch record in the
        window and, in a ``Tracer.capture()`` (tracing on for the window),
        every span finished in it. With ``oryx.monitoring.profile.dir`` set,
        a ``torch.profiler`` of the host and the card runs too, and one
        Perfetto file of the window is written under that directory
        (``write_profile``: the card's operations and the program's spans
        on one ``time.monotonic`` timebase). Returns a Perfetto-loadable
        Chrome trace-event dict of the records and spans (wall-clock
        timebase) with an ``oryx`` meta block summarizing the window and
        naming the file. Raises RuntimeError if a capture, or
        ``maybe_profile``, already holds the profiler."""
        import os

        if not self._capture_lock.acquire(blocking=False):
            raise RuntimeError("a profile capture is already running")
        try:
            trace_path = dev = None
            if self.profile_dir:
                with profiled_window() as dev:
                    time.sleep(max(0.0, seconds))
                cap = dev.capture
            else:
                with get_tracer().capture() as cap:
                    time.sleep(max(0.0, seconds))
            recs = [r for r in self.records_since(cap.t0)
                    if r.t_start <= cap.t1]
            if dev is not None:
                trace_path = os.path.join(
                    self.profile_dir, f"ondemand-{int(time.time() * 1000)}.json")
                try:
                    write_profile(trace_path, recs, cap.spans, dev)
                except OSError:
                    trace_path = None
            pid = os.getpid()
            events = [r.chrome_event(pid) for r in recs]
            events.extend(chrome_trace(cap.spans)["traceEvents"])
            spans = len(cap.spans)
            per_kind: dict[str, dict] = {}
            for r in recs:
                agg = per_kind.setdefault(
                    r.kind,
                    {"dispatches": 0, "flops": 0.0, "bytes": 0.0,
                     "wall_s": 0.0, "occupancy_sum": 0.0},
                )
                agg["dispatches"] += 1
                agg["flops"] += r.flops
                agg["bytes"] += r.bytes_moved
                agg["wall_s"] += r.wall_s
                agg["occupancy_sum"] += r.occupancy
            window = max(1e-9, cap.t1 - cap.t0)
            summary = {}
            for kind, agg in per_kind.items():
                peak = self.peak_for(kind)
                summary[kind] = {
                    "dispatches": agg["dispatches"],
                    "flops": agg["flops"],
                    "bytes_moved": agg["bytes"],
                    "busy_fraction": round(agg["wall_s"] / window, 4),
                    "mean_occupancy": round(
                        agg["occupancy_sum"] / agg["dispatches"], 4
                    ),
                    "flops_per_sec": agg["flops"] / window,
                    # no fixed-decimal rounding: honest MFUs here run
                    # 1e-8..1e-2 and a 6-decimal round would zero them
                    "mfu": (
                        agg["flops"] / window / peak if peak else None
                    ),
                }
            return {
                "displayTimeUnit": "ms",
                "traceEvents": events,
                "oryx": {
                    "window_seconds": round(window, 3),
                    "dispatch_records": len(recs),
                    "trace_spans": spans,
                    "torch_trace_path": trace_path,
                    "device_offset_ns": dev.offset_ns if dev else None,
                    "by_kind": summary,
                },
            }
        finally:
            self._capture_lock.release()

    # -- metrics -----------------------------------------------------------

    def ensure_metrics(self) -> None:
        """Register the perf metric families on the global registry (safe
        to call repeatedly; serving/batch/speed runtimes all call it so
        dashboards get the zero baseline from process start)."""
        reg = get_registry()
        with self._register_lock:
            self._h_dispatch = reg.histogram(
                "oryx_device_dispatch_seconds",
                "Wall-clock per device dispatch (coalesced serving top-k "
                "group, launch to results on the host; or a training "
                "build), by kind",
                buckets=DISPATCH_SECONDS_BUCKETS,
            )
            self._h_occupancy = reg.histogram(
                "oryx_dispatch_batch_occupancy",
                "Valid rows over the capacity-padded shape actually "
                "dispatched (1.0 = zero padding waste), by kind",
                buckets=OCCUPANCY_BUCKETS,
            )
            self._h_bytes = reg.histogram(
                "oryx_device_bytes_per_dispatch",
                "Approximate bytes moved per device dispatch (operand "
                "streams + host transfers), by kind",
                buckets=BYTES_BUCKETS,
            )
            self._c_score_mode = reg.counter(
                "oryx_score_mode_dispatches_total",
                "Device top-k dispatches by serving score mode "
                "(score_mode = exact | quantized | approx); every "
                "batcher perfstats record carries the label",
                labeled=True,
            )
            # re-binding the same closures over the singleton is harmless,
            # and keeps the series alive across registry.clear() in tests
            g_mfu = reg.gauge(
                "oryx_device_mfu",
                "Rolling-window achieved MFU (FLOP/s over the card's dense "
                "peak at the dispatched type, "
                "or oryx.monitoring.perf.assumed-peak-flops); NaN when no "
                "peak is known",
                labeled=True,
            )
            g_rate = reg.gauge(
                "oryx_device_flops_per_sec",
                "Rolling-window achieved analytic FLOP/s of device "
                "dispatches, by kind",
                labeled=True,
            )
            for kind in ("serving", "train"):
                g_mfu.set_function(
                    (lambda k: lambda: self.mfu(k))(kind), kind=kind
                )
                g_rate.set_function(
                    (lambda k: lambda: self.achieved_flops_per_sec(k))(kind),
                    kind=kind,
                )


def write_profile(path: str, recs, spans, dev) -> None:
    """One Perfetto (Chrome trace-event) file of a profile window, every
    event on the ``time.monotonic`` timebase in microseconds: the
    program's spans (process "host spans", a lane a thread), the dispatch
    records (its lane 0, "dispatch records"), the card's operations (process
    "device", a lane a stream) and the host's CUDA runtime calls (process
    "cuda runtime"), the last two from ``dev`` (a ``ProfiledWindow``). A
    device idle gap then lies under the host span that explains it."""
    import json
    import os

    names = {1: "host spans", 2: "device", 3: "cuda runtime"}
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": name}} for pid, name in names.items()]
    events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
                   "args": {"name": "dispatch records"}})
    for s in spans:
        events.append({
            "name": s.name, "cat": "oryx", "ph": "X", "ts": s.start * 1e6,
            "dur": max(0.0, s.duration) * 1e6, "pid": 1, "tid": s.tid,
            "args": dict(s.attrs),
        })
    for r in recs:
        ev = r.chrome_event(1)
        ev.update(ts=r.t_start * 1e6, tid=0)
        events.append(ev)
    for name, cat, on_device, lane, start, end, corr in dev.events:
        events.append({
            "name": name, "cat": cat, "ph": "X", "ts": start / 1e3,
            "dur": max(0, end - start) / 1e3, "pid": 2 if on_device else 3,
            "tid": lane, "args": {"correlation": corr},
        })
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"displayTimeUnit": "ms", "traceEvents": events,
                   "oryx": {"timebase": "time.monotonic",
                            "device_offset_ns": dev.offset_ns,
                            "marker_ns": dev.mark_ns}}, f)


_default = PerfStats()
_default.ensure_metrics()


def get_perfstats() -> PerfStats:
    return _default


def configure_perfstats(config) -> PerfStats:
    _default.configure(config)
    _default.ensure_metrics()
    return _default
