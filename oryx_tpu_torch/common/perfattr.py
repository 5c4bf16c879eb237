"""Hot-path latency attribution: request phase budgets, device idle-gap
classification, compile telemetry, and burn-triggered profile capture
(the port's copy of oryx_tpu/common/perfattr.py).

- **Request phase budgets.** Every request carries a ``PhaseLedger`` — a
  cheap append-only list of ``(phase, start, seconds)`` stamps the
  frontends and the batcher fill in as the request traverses parse →
  auth → queue_wait → device → serialize → write. The frontend flushes
  the ledger once after the response bytes are written: each stamp lands
  in the ``oryx_request_phase_seconds{phase}`` histogram (with
  metric→trace exemplars) and — when tracing is on — as a
  ``phase.<name>`` child span under the request's root span. A rolling
  window of stamps backs ``budget()``: per-phase p50/p99 and share of
  the total, the "latency budget" /healthz advertises.

- **Device idle-gap attribution.** The batcher's dispatcher classifies
  every gap between consecutive device dispatches by cause —
  empty_queue (cond waits), host_serialize (result read-back and
  distribution, and batch-formation host work), compile_stall,
  failover_backoff (card marked down) — into
  ``oryx_device_idle_gap_seconds{cause}``. Residue the dispatcher cannot
  pin (more than ~10% of a gap and more than 2ms) is reported as
  ``unattributed`` rather than silently folded.

- **Compile telemetry.** Eager PyTorch compiles nothing per shape; this
  package's one cold cost is the first load of the CUDA kernel library
  (``ops/topk.py``), which runs nvcc on a cold build directory. That load
  is recorded once into ``oryx_xla_compile_seconds{kind}`` /
  ``oryx_xla_compiles_total{kind}`` (the JAX package's names, so
  dashboards read one series) and as a ``compile_stall`` idle gap, and a
  ``compile-storm`` flight event fires when the compile rate within the
  rolling window crosses ``oryx.monitoring.perfattr.compile-storm.
  threshold``.

- **Burn-triggered profile capture.** When the serving-latency SLO's
  fast burn rate (common/slo.py) crosses ``burn-capture.burn-threshold``,
  a one-shot daemon thread captures a bounded profile window (perfstats
  ring summary + the live phase budget + a torch.profiler trace when a
  profile dir is set) and records it as a ``profile-capture`` event in
  the on-disk flight ring. The check itself is a timestamp-gated float
  compare on the request flush path.

The ledger/stamp path is always on; ``oryx.monitoring.perfattr.enabled =
false`` only disables the *derived* machinery (storm events, burn
capture, budget windows), never the raw histograms.
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

# Device idle-gap causes. `unattributed` is the honesty valve: time the
# dispatcher cannot pin on a concrete cause is reported, not hidden.
IDLE_CAUSES = (
    "empty_queue",
    "host_serialize",
    "compile_stall",
    "failover_backoff",
    "unattributed",
)

# Phase durations: 10us (a warm auth check) up to ~10s.
PHASE_SECONDS_BUCKETS = exponential_buckets(1e-5, 4.0, 10)

# Idle gaps: 100us up to ~26s (a compile stall or probe backoff window).
IDLE_GAP_BUCKETS = exponential_buckets(1e-4, 4.0, 10)

# Compile times: 1ms up to ~4 minutes (a cold nvcc build of the kernels).
COMPILE_SECONDS_BUCKETS = exponential_buckets(1e-3, 4.0, 10)

DEFAULT_WINDOW_S = 60.0
DEFAULT_STORM_THRESHOLD = 6
DEFAULT_STORM_WINDOW_S = 60.0
DEFAULT_BURN_THRESHOLD = 14.0
DEFAULT_CAPTURE_S = 1.0
DEFAULT_MIN_INTERVAL_S = 300.0
DEFAULT_CHECK_INTERVAL_S = 5.0

# Gap residue at most this absolute size OR this fraction of the gap is
# dispatcher loop overhead (pick/group bookkeeping between timestamps) —
# folded into host_serialize; anything larger is unattributed.
_FOLD_ABS_S = 0.002
_FOLD_FRAC = 0.10


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
    rolling budget window, idle-gap and compile telemetry, compile-storm
    detection, and the burn-triggered profile capture watcher."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S):
        self.enabled = True
        self.window_s = float(window_s)
        # rolling stamp windows backing budget(): (t_end, key, seconds)
        self._phase_win: deque[tuple[float, str, float]] = deque()
        self._gap_win: deque[tuple[float, str, float]] = deque()
        self._win_lock = threading.Lock()
        # compile-storm detection
        self.storm_threshold = DEFAULT_STORM_THRESHOLD
        self.storm_window_s = DEFAULT_STORM_WINDOW_S
        self._compiles: deque[float] = deque()   # guarded-by: _win_lock
        # burn-triggered capture
        self.burn_capture_enabled = True
        self.burn_threshold = DEFAULT_BURN_THRESHOLD
        self.capture_s = DEFAULT_CAPTURE_S
        self.min_interval_s = DEFAULT_MIN_INTERVAL_S
        self.check_interval_s = DEFAULT_CHECK_INTERVAL_S
        self._next_burn_check = 0.0
        self._burn_cooldown_until = 0.0
        self._burn_lock = threading.Lock()
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
        self.storm_threshold = config.get_int(
            "oryx.monitoring.perfattr.compile-storm.threshold",
            DEFAULT_STORM_THRESHOLD,
        )
        self.storm_window_s = float(config.get_float(
            "oryx.monitoring.perfattr.compile-storm.window-sec",
            DEFAULT_STORM_WINDOW_S,
        ))
        self.burn_capture_enabled = config.get_bool(
            "oryx.monitoring.perfattr.burn-capture.enabled", True
        )
        self.burn_threshold = float(config.get_float(
            "oryx.monitoring.perfattr.burn-capture.burn-threshold",
            DEFAULT_BURN_THRESHOLD,
        ))
        self.capture_s = float(config.get_float(
            "oryx.monitoring.perfattr.burn-capture.capture-sec",
            DEFAULT_CAPTURE_S,
        ))
        self.min_interval_s = float(config.get_float(
            "oryx.monitoring.perfattr.burn-capture.min-interval-sec",
            DEFAULT_MIN_INTERVAL_S,
        ))
        self.check_interval_s = float(config.get_float(
            "oryx.monitoring.perfattr.burn-capture.check-interval-sec",
            DEFAULT_CHECK_INTERVAL_S,
        ))
        with self._win_lock:
            self._phase_win.clear()
            self._gap_win.clear()
        self.ensure_metrics()

    # -- request flush -----------------------------------------------------

    def observe_request(self, ledger: PhaseLedger | None) -> None:
        """Flush one request's ledger: phase histograms (+exemplars), the
        rolling budget window, the trace waterfall's phase.* child
        spans, and a timestamp-gated burn check. Idempotent per ledger —
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
        self._maybe_burn_check(now)

    # -- idle gaps ---------------------------------------------------------

    def record_idle_gap(self, cause: str, seconds: float) -> None:
        """One classified slice of device idle time (dispatcher thread)."""
        if seconds <= 0.0 or seconds != seconds:
            return
        self._h_gap.observe(seconds, cause=cause)
        if self.enabled:
            now = time.monotonic()
            with self._win_lock:
                self._prune(self._gap_win, now)
                self._gap_win.append((now, cause, seconds))

    # -- compile telemetry -------------------------------------------------

    def record_compile(self, kind: str, seconds: float) -> None:
        """One cold compile (here: the first load of the kernel library).
        Feeds the per-kind histogram/counter and the storm detector."""
        self._c_compile.inc(kind=kind)
        self._h_compile.observe(max(0.0, seconds), kind=kind)
        if not self.enabled:
            return
        now = time.monotonic()
        storm = 0
        with self._win_lock:
            dq = self._compiles
            dq.append(now)
            cutoff = now - self.storm_window_s
            while dq and dq[0] < cutoff:
                dq.popleft()
            if self.storm_threshold > 0 and len(dq) >= self.storm_threshold:
                storm = len(dq)
        if storm:
            from oryx_tpu_torch.common.flightrec import get_flightrec

            # episode-limited: a sustained storm records one event per
            # window, not one per recompile
            get_flightrec().record(
                kind="compile-storm",
                episode_s=self.storm_window_s,
                compiles=storm,
                window_s=self.storm_window_s,
                dispatch_kind=kind,
                last_compile_s=round(seconds, 4),
            )

    # -- reading -----------------------------------------------------------

    def _prune(self, dq, now: float) -> None:  # holds _win_lock
        cutoff = now - self.window_s
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    def budget(self) -> dict:
        """Per-window latency budget: per-phase p50/p99/share plus the
        ranked idle-gap causes. The /healthz section."""
        now = time.monotonic()
        with self._win_lock:
            self._prune(self._phase_win, now)
            self._prune(self._gap_win, now)
            phase_items = list(self._phase_win)
            gap_items = list(self._gap_win)
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
        gap_total = sum(s for _, _, s in gap_items)
        gaps: dict[str, float] = {}
        for _, cause, s in gap_items:
            gaps[cause] = gaps.get(cause, 0.0) + s
        idle = {
            cause: {
                "seconds": round(s, 4),
                "share": round(s / gap_total, 4) if gap_total > 0 else 0.0,
            }
            for cause, s in sorted(
                gaps.items(), key=lambda kv: kv[1], reverse=True
            )
        }
        return {
            "window_seconds": self.window_s,
            "total_phase_seconds": round(total, 4),
            "phases": phases,
            "idle_gaps": idle,
        }

    def idle_gaps_since(self, t: float) -> dict[str, float]:
        """cause -> idle seconds classified at or after monotonic time t
        (within the rolling window; empty while perfattr is disabled)."""
        with self._win_lock:
            items = [(c, s) for ts, c, s in self._gap_win if ts >= t]
        out: dict[str, float] = {}
        for cause, s in items:
            out[cause] = out.get(cause, 0.0) + s
        return out

    def healthz_section(self) -> dict:
        return self.budget()

    # -- burn-triggered capture --------------------------------------------

    def _maybe_burn_check(self, now: float) -> None:
        """Timestamp-gated fast-burn probe on the request flush path: one
        float compare per request, a real SLO read at most every
        check-interval-sec, a capture at most every min-interval-sec."""
        if not (self.enabled and self.burn_capture_enabled):
            return
        if now < self._next_burn_check:
            return
        with self._burn_lock:
            if now < self._next_burn_check:
                return
            self._next_burn_check = now + self.check_interval_s
            if now < self._burn_cooldown_until:
                return
            burn = _latency_fast_burn()
            if burn is None or burn < self.burn_threshold:
                return
            self._burn_cooldown_until = now + self.min_interval_s
        t = threading.Thread(
            target=self._burn_capture, args=(burn,),
            name="oryx-burn-capture", daemon=True,
        )
        t.start()

    def _burn_capture(self, burn: float) -> None:
        """Capture a bounded profile window and leave it in the flight
        ring (the on-disk ring survives a SIGKILL — the corpse the
        supervisor harvests names where the time went)."""
        from oryx_tpu_torch.common.flightrec import get_flightrec
        from oryx_tpu_torch.common.perfstats import get_perfstats

        meta = None
        try:
            prof = get_perfstats().capture_profile(max(0.0, self.capture_s))
            meta = prof.get("oryx")
        except RuntimeError:
            meta = {"skipped": "a profile capture was already running"}
        except Exception as e:  # noqa: BLE001 - capture must never kill serving
            meta = {"error": str(e)}
        get_flightrec().record(
            kind="profile-capture",
            trigger="latency-fast-burn",
            burn_rate=round(burn, 2),
            budget=self.budget(),
            profile=meta,
        )

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
            self._h_gap = reg.histogram(
                "oryx_device_idle_gap_seconds",
                "Gaps between consecutive device dispatches classified "
                "by cause (empty_queue, host_serialize, compile_stall, "
                "failover_backoff, unattributed), by cause",
                buckets=IDLE_GAP_BUCKETS,
            )
            self._h_compile = reg.histogram(
                "oryx_xla_compile_seconds",
                "Cold compile time, by kind (the JAX package's XLA "
                "compiles; here the first load of the CUDA kernel library, "
                "an nvcc build when its build directory is cold)",
                buckets=COMPILE_SECONDS_BUCKETS,
            )
            self._c_compile = reg.counter(
                "oryx_xla_compiles_total",
                "Cold compiles observed, by kind (here: first loads of the "
                "CUDA kernel library); the compile-storm flight event "
                "fires when the windowed rate crosses the configured "
                "threshold",
                labeled=True,
            )


def classify_idle_gap(
    gap: float,
    wait_s: float = 0.0,
    serialize_s: float = 0.0,
    down_s: float = 0.0,
) -> dict[str, float]:
    """Split one inter-dispatch idle gap into cause → seconds.

    The dispatcher measures what it can directly — condition-variable
    wait time (``wait_s`` → empty_queue), its own host work between its
    stamped waits, launches and syncs (``serialize_s`` → host_serialize),
    and device-down backoff (``down_s`` → failover_backoff) — each
    capped at what the gap can still hold, in that order. Residue up to max(2ms, 10% of the gap) is
    dispatcher loop overhead between the measured timestamps
    (pick/group bookkeeping — host work by definition) and folds
    into host_serialize; anything larger is reported honestly as
    unattributed. Compile stalls are recorded separately where the
    compile is observed (the kernel library's first load, ops/topk.py)."""
    out: dict[str, float] = {}
    if gap <= 1e-6:
        return out
    wait_s = min(max(0.0, wait_s), gap)
    down_s = min(max(0.0, down_s), gap - wait_s)
    serialize_s = min(max(0.0, serialize_s), gap - wait_s - down_s)
    rem = gap - wait_s - down_s - serialize_s
    if rem <= max(_FOLD_ABS_S, _FOLD_FRAC * gap):
        serialize_s += rem
        rem = 0.0
    if wait_s > 0.0:
        out["empty_queue"] = wait_s
    if serialize_s > 0.0:
        out["host_serialize"] = serialize_s
    if down_s > 0.0:
        out["failover_backoff"] = down_s
    if rem > 0.0:
        out["unattributed"] = rem
    return out


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile of an already-sorted non-empty list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


def _latency_fast_burn() -> float | None:
    """The serving-latency SLO's fast-window burn rate, or None when the
    tracker is not registered (non-serving processes)."""
    from oryx_tpu_torch.common.slo import current_burn

    return current_burn("serving-latency")


_default = PerfAttr()


def get_perfattr() -> PerfAttr:
    return _default


def configure_perfattr(config) -> PerfAttr:
    _default.configure(config)
    return _default
