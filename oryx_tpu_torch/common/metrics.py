"""Metrics registry + Prometheus text exposition (the port's copy of
oryx_tpu/common/metrics.py; its profiler hook, ``maybe_profile``, writes a
``torch.profiler`` trace where the JAX package writes a JAX one).

The reference has no metrics subsystem at all — observability is delegated
to the Spark UI and rate-limited log lines (SURVEY.md §5 "no metrics
registry, no Prometheus — a deliberate gap to improve on"). This module
fills that gap natively: counters/gauges/histograms with labels, rendered
in Prometheus text exposition format at /metrics by the serving layer.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

# Latency-style default buckets (seconds), log-spaced 1ms..60s.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Batch-generation-scale buckets: full model rebuilds run seconds to hours
# (the reference's default generation interval is 6h).
GENERATION_BUCKETS = (
    1.0, 5.0, 15.0, 60.0, 300.0, 900.0, 1800.0, 3600.0, 10800.0, 21600.0,
)

# Speed-micro-batch-scale buckets: 10ms up to well past the default 10s
# micro-batch interval.
MICROBATCH_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0, 600.0,
)


def linear_buckets(start: float, width: float, count: int) -> tuple[float, ...]:
    """`count` bucket upper bounds starting at `start`, `width` apart —
    the right shape for bounded ratios (occupancy) and queue depths,
    where log spacing would waste resolution at the interesting end."""
    if count < 1:
        raise ValueError("count must be >= 1")
    return tuple(start + width * i for i in range(count))


def exponential_buckets(
    start: float, factor: float, count: int
) -> tuple[float, ...]:
    """`count` bucket upper bounds: start, start*factor, ... — the right
    shape for latencies and byte counts spanning orders of magnitude."""
    if count < 1:
        raise ValueError("count must be >= 1")
    if start <= 0 or factor <= 1:
        raise ValueError("start must be > 0 and factor > 1")
    return tuple(start * factor**i for i in range(count))


class GaugeSeriesGone(Exception):
    """Raised by a bound gauge/counter callable to permanently remove its
    series (e.g. the object it reports on was garbage-collected). Any
    other exception from a callable skips the series for this scrape
    only."""


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    """Label-VALUE escaping: backslash, double quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """# HELP text escaping: the text format allows ONLY \\\\ and \\n here —
    escaping quotes (as label values must) would itself be an invalid
    escape sequence and corrupt the whole exposition."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v):
        return str(int(v))
    return repr(v)


class Counter:
    """Monotonically increasing metric, per label set. A series may also
    be bound to a callable (set_function) evaluated at scrape time — for
    counters whose source of truth is owned by one thread (e.g. an event
    loop's request tally), so the hot path increments a plain int and
    only the scrape crosses threads. The callable must be monotonic to
    keep counter semantics."""

    kind = "counter"

    def __init__(self, name: str, help: str, labeled: bool = False):
        self.name = name
        self.help = help
        # labeled=True declares every series carries labels: with zero
        # series the metric then renders no sample at all instead of a
        # bogus unlabeled `name 0`
        self.labeled = labeled
        self._values: dict[tuple, float] = {}  # guarded-by: _lock
        self._fns: dict[tuple, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_function(self, fn, **labels: str) -> None:
        with self._lock:
            self._fns[_label_key(labels)] = fn

    def unbind_function(self, fn=None, **labels: str) -> None:
        """Drop a callback-bound series. When `fn` is given, only that
        exact binding is removed — a closed owner unbinding on shutdown
        cannot clobber a newer owner's binding under the same labels."""
        key = _label_key(labels)
        with self._lock:
            if fn is None or self._fns.get(key) is fn:
                self._fns.pop(key, None)

    def value(self, **labels: str) -> float:
        key = _label_key(labels)
        # snapshot under the lock (like render): an unlocked dict read can
        # race a concurrent first-insert resize and miss/see-torn state
        with self._lock:
            fn = self._fns.get(key)
            v = self._values.get(key, 0.0)
        if fn is not None:
            return float(fn())  # outside the lock: callables may be slow
        return v

    def series(self) -> dict[tuple, float]:
        """Snapshot of every series' value keyed by its sorted label
        tuple (callback-bound series evaluated outside the lock; a
        failing callback is skipped like a scrape would). The SLO
        trackers (common/slo.py) sum these to derive good/bad totals
        without new instrumentation on the request path."""
        with self._lock:
            snapshot = dict(self._values)
            fns = dict(self._fns)
        out = dict(snapshot)
        for key, fn in fns.items():
            try:
                out[key] = float(fn())
            except Exception:  # noqa: BLE001 - skip like render() does
                continue
        return out

    def render(self, openmetrics: bool = False) -> list[str]:
        # OpenMetrics counter contract: the METRIC FAMILY name carries no
        # _total suffix — samples are `<family>_total` — so the HELP/TYPE
        # lines must strip it or a strict parser (prometheus_client's
        # openmetrics decoder) rejects the whole page as a name clash.
        # Legacy counters that predate the suffix contract expose as
        # `unknown` under negotiation (their samples can't legally be
        # counter samples). Classic text keeps the full name everywhere.
        family, kind = self.name, "counter"
        if openmetrics:
            if self.name.endswith("_total"):
                family = self.name[: -len("_total")]
            else:
                kind = "unknown"
        lines = [
            f"# HELP {family} {_escape_help(self.help)}",
            f"# TYPE {family} {kind}",
        ]
        with self._lock:
            keys = sorted(set(self._values) | set(self._fns))
            snapshot = dict(self._values)
            fns = dict(self._fns)
        if not keys and not self.labeled:
            lines.append(f"{self.name} 0")
        for key in keys:
            fn = fns.get(key)
            if fn is not None:
                try:
                    v = float(fn())
                except GaugeSeriesGone:
                    with self._lock:
                        # identity-conditioned like unbind_function: a NEW
                        # owner may have re-bound these labels since the
                        # snapshot, and its fresh series must survive the
                        # dead reader's eviction
                        if self._fns.get(key) is fn:
                            self._fns.pop(key, None)
                    continue
                except Exception:
                    # transient callback failure: skip this scrape only
                    continue
            else:
                v = snapshot.get(key, 0.0)
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return lines


class Gauge:
    """Point-in-time value; set/inc/dec, or bind a callable for pull-time
    evaluation (e.g. model load fraction)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labeled: bool = False):
        self.name = name
        self.help = help
        self.labeled = labeled  # see Counter: suppress the zero-series sample
        self._values: dict[tuple, float] = {}  # guarded-by: _lock
        self._fns: dict[tuple, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn, **labels: str) -> None:
        with self._lock:
            self._fns[_label_key(labels)] = fn

    def clear_values(self) -> None:
        """Drop every set() series (callback-bound series stay) — for a
        gauge whose label sets enumerate state that was wholly replaced,
        e.g. the served generation's quality-scorecard metrics: a new
        generation without some metric must not keep exporting its
        predecessor's value under that label."""
        with self._lock:
            self._values.clear()

    def value(self, **labels: str) -> float:
        key = _label_key(labels)
        with self._lock:  # snapshot like render(); see Counter.value
            fn = self._fns.get(key)
            v = self._values.get(key, 0.0)
        if fn is not None:
            return float(fn())
        return v

    def render(self, openmetrics: bool = False) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} gauge",
        ]
        with self._lock:
            keys = sorted(set(self._values) | set(self._fns))
            snapshot = dict(self._values)
            fns = dict(self._fns)
        if not keys and not self.labeled:
            lines.append(f"{self.name} 0")
        for key in keys:
            fn = fns.get(key)
            if fn is not None:
                try:
                    v = float(fn())
                except GaugeSeriesGone:
                    with self._lock:
                        # identity-conditioned like unbind_function: a NEW
                        # owner may have re-bound these labels since the
                        # snapshot, and its fresh series must survive the
                        # dead reader's eviction
                        if self._fns.get(key) is fn:
                            self._fns.pop(key, None)
                    continue
                except Exception:
                    # transient callback failure: skip this scrape only
                    continue
            else:
                v = snapshot.get(key, 0.0)
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return lines


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket counts
    observations <= its upper bound, +Inf bucket == count).

    Bucket boundaries are per-metric (see ``linear_buckets`` /
    ``exponential_buckets``): queue depths and occupancy ratios need
    linear spacing, latencies need exponential — one global scheme fits
    neither. Observations may carry a trace-id exemplar: the bucket the
    value lands in remembers the most recent (trace_id, value, wall-time)
    sample, rendered in OpenMetrics exemplar syntax so a "p99 got worse"
    bucket resolves to an actual traced request in /debug/traces.
    Exemplars only exist while tracing supplies ids, so the exposition
    stays plain Prometheus text when tracing is off."""

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}  # guarded-by: _lock
        self._sums: dict[tuple, float] = {}  # guarded-by: _lock
        self._totals: dict[tuple, int] = {}  # guarded-by: _lock
        # label-key -> {bucket index (len(buckets) = +Inf): (trace_id,
        # value, unix ts)} — newest observation wins per bucket
        self._exemplars: dict[tuple, dict[int, tuple[str, float, float]]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(
        self, value: float, trace_id: str | None = None, **labels: str
    ) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            idx = len(self.buckets)  # +Inf
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    idx = min(idx, i)
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if trace_id:
                self._exemplars.setdefault(key, {})[idx] = (
                    str(trace_id), value, time.time()
                )

    @contextmanager
    def time(self, **labels: str) -> Iterator[None]:
        start = time.monotonic()
        try:
            yield
        finally:
            self.observe(time.monotonic() - start, **labels)

    def count(self, **labels: str) -> int:
        with self._lock:  # snapshot like render(); see Counter.value
            return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels: str) -> float:
        with self._lock:
            return self._sums.get(_label_key(labels), 0.0)

    def bucket_counts(self, **labels: str) -> list[tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs including +Inf,
        snapshotted under the lock — an unlocked read can race an
        in-flight observe and see a bucket list mid-update (the same
        torn-read class fixed for Counter.value)."""
        key = _label_key(labels)
        with self._lock:
            counts = list(self._counts.get(key, [0] * len(self.buckets)))
            total = self._totals.get(key, 0)
        out = [(ub, counts[i]) for i, ub in enumerate(self.buckets)]
        out.append((float("inf"), total))
        return out

    def totals_below(self, threshold: float) -> tuple[int, int]:
        """(observations at/under ``threshold``, total observations)
        summed across every label set — the latency-SLO numerator/
        denominator. Uses the largest bucket bound <= threshold (the
        conservative read when the threshold falls between bounds);
        a threshold under the first bound counts nothing as fast."""
        idx = -1
        for i, ub in enumerate(self.buckets):
            if ub <= threshold:
                idx = i
            else:
                break
        with self._lock:
            total = sum(self._totals.values())
            if idx < 0:
                below = 0
            else:
                below = sum(c[idx] for c in self._counts.values())
        return below, total

    def exemplar(self, bucket_index: int, **labels: str):
        """(trace_id, value, unix_ts) recorded for the bucket at
        ``bucket_index`` (len(buckets) = the +Inf bucket), or None."""
        with self._lock:
            return self._exemplars.get(_label_key(labels), {}).get(bucket_index)

    def render(self, openmetrics: bool = False) -> list[str]:
        """Exemplars render ONLY under openmetrics=True: the classic
        text exposition (text/plain; version=0.0.4) has no exemplar
        syntax, and a legacy parser hits the trailing `# {...}` and fails
        the whole scrape — exemplars are legal solely under
        application/openmetrics-text content negotiation."""
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            items = sorted(self._totals)
            counts = {k: list(v) for k, v in self._counts.items()}
            sums = dict(self._sums)
            totals = dict(self._totals)
            exemplars = (
                {k: dict(v) for k, v in self._exemplars.items()}
                if openmetrics else {}
            )

        def _ex(key: tuple, idx: int) -> str:
            ex = exemplars.get(key, {}).get(idx)
            if ex is None:
                return ""
            tid, val, ts = ex
            return (
                f' # {{trace_id="{_escape(tid)}"}} {_fmt_value(val)} {ts:.3f}'
            )

        for key in items:
            for i, ub in enumerate(self.buckets):
                bkey = key + (("le", _fmt_value(ub)),)
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(bkey)} "
                    f"{counts[key][i]}{_ex(key, i)}"
                )
            inf_key = key + (("le", "+Inf"),)
            lines.append(
                f"{self.name}_bucket{_fmt_labels(inf_key)} "
                f"{totals[key]}{_ex(key, len(self.buckets))}"
            )
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(sums[key])}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {totals[key]}")
        return lines


class MetricsRegistry:
    """Thread-safe named-metric registry. Re-registering a name returns the
    existing metric (so layer + resource modules can share by name)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name} already registered as {existing.kind}"
                    )
                return existing
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labeled: bool = False) -> Counter:
        return self._get_or_create(Counter, name, help, labeled=labeled)

    def gauge(self, name: str, help: str = "", labeled: bool = False) -> Gauge:
        return self._get_or_create(Gauge, name, help, labeled=labeled)

    def histogram(
        self, name: str, help: str = "", buckets: tuple[float, ...] | None = None
    ) -> Histogram:
        """buckets=None adopts DEFAULT_BUCKETS on first registration and
        accepts whatever an existing metric was registered with.
        Explicitly-passed buckets that disagree with an existing metric's
        raise — two call sites silently observing into different bucket
        schemes under one name would corrupt every quantile read."""
        h = self._get_or_create(
            Histogram, name, help,
            buckets=DEFAULT_BUCKETS if buckets is None else buckets,
        )
        if buckets is not None and h.buckets != tuple(sorted(buckets)):
            raise ValueError(
                f"metric {name} already registered with buckets "
                f"{h.buckets}, conflicting with {tuple(sorted(buckets))}"
            )
        return h

    def render_prometheus(self, openmetrics: bool = False) -> str:
        """Text exposition. openmetrics=True renders the OpenMetrics
        dialect — exemplars on histogram buckets, non-`_total` counters
        as `unknown`, terminating `# EOF` — for scrapers that negotiated
        `application/openmetrics-text`; the default stays classic
        Prometheus text, which has no exemplar syntax."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


# One process can hold one torch profiler. maybe_profile and perfstats'
# capture_profile (GET /debug/profile) both take this lock without
# blocking, so a second profiler is refused instead of failing inside torch.
PROFILER_LOCK = threading.Lock()


@contextmanager
def torch_trace(trace_dir: str, name: str) -> Iterator[str | None]:
    """``torch.profiler`` trace (host, and the card when there is one)
    around a block, written as a Chrome trace to <dir>/<name>-<ts>.json for
    Perfetto. Yields that path, or None when the profiler did not start. A
    profiler that fails to start or to write is logged and never breaks
    the traced computation. The caller holds PROFILER_LOCK."""
    import logging
    import os

    import torch

    log = logging.getLogger(__name__)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    path = os.path.join(trace_dir, f"{name}-{int(time.time() * 1000)}.json")
    try:
        prof.__enter__()
    except Exception:  # noqa: BLE001 - e.g. a profiler already active
        log.warning("profiler did not start; %s runs untraced", name, exc_info=True)
        yield None
        return
    try:
        yield path
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception:  # noqa: BLE001 - the traced work already ran
            log.warning("profile trace for %s not written", name, exc_info=True)


@contextmanager
def maybe_profile(profile_dir: str | None, name: str) -> Iterator[None]:
    """``torch_trace`` around a block when a profile dir is configured
    (oryx.monitoring.profile-dir); no-op otherwise, and untraced (with a
    warning) while another profiler holds PROFILER_LOCK."""
    if not profile_dir:
        yield
        return
    if not PROFILER_LOCK.acquire(blocking=False):
        import logging

        logging.getLogger(__name__).warning(
            "a profiler is already running; %s runs untraced", name
        )
        yield
        return
    try:
        with torch_trace(profile_dir, name):
            yield
    finally:
        PROFILER_LOCK.release()
