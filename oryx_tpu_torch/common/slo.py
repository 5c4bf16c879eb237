"""Config-declared SLOs computed from the metrics the system already has
(the port's copy of oryx_tpu/common/slo.py).

A canary gate, an autoscaler or a pager needs one signal: "is the fleet
burning its error budget faster than the objective allows, right now?"
That is a burn rate — the ratio of the observed bad fraction over a
window to the budgeted bad fraction (1 - objective) — evaluated over a
FAST window (pages/gates react in minutes) and a SLOW window (sustained
burn distinguishes a blip from an incident), the standard
multi-window-burn-rate alerting shape. This module derives both from
counters/histograms that already exist (no new instrumentation on any
hot path):

- ``serving-availability``: non-5xx fraction of
  ``oryx_serving_requests_total`` (a deliberate shed IS a client-visible
  503 — the SLO counts it, which is exactly why an induced shed storm
  moves the burn rate and recovery returns it to ~0).
- ``serving-latency``: fraction of ``oryx_serving_request_seconds``
  observations at/under ``oryx.monitoring.slo.latency.threshold-sec``.
- ``front-availability``: fraction of
  ``oryx_fleet_front_requests_total`` answered by a replica
  (``replica="none"`` means the client saw the front's own 503). The
  fleet front (fleet/front.py) feeds it; in a process without a front the
  family stays empty and the burn reads 0.
- ``quality``: fraction of shadow-rescored responses
  (``common/qualitystats.py``) whose measured recall held the
  ``oryx.monitoring.slo.quality.recall-floor`` — the live model-quality
  objective a degraded generation burns.

Exported as ``oryx_slo_burn_rate{slo,window}`` and
``oryx_slo_error_budget_remaining{slo}``. A burn rate of 1.0 means
spending the budget exactly as fast as the objective allows; the classic
page thresholds are ~14 (fast window) and ~6 (slow window). Sampling is
scrape-driven: each gauge read snapshots the cumulative totals into a
bounded time-indexed ring and differences against the sample nearest the
window start — no background thread, and the cost is two counter-series
sums per scrape.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

from oryx_tpu_torch.common.metrics import get_registry

# Minimum spacing between stored samples: the three gauge reads of one
# scrape (fast burn, slow burn, budget) share a single sample.
_MIN_SAMPLE_GAP_S = 0.05


class SloTracker:
    """One objective's burn-rate state: a bounded ring of (t, total, bad)
    cumulative samples and the window math over it."""

    def __init__(
        self,
        slo: str,
        objective: float,
        source: Callable[[], tuple[float, float]],
        fast_s: float,
        slow_s: float,
    ):
        self.slo = slo
        self.objective = objective
        self.source = source  # () -> (total, bad), cumulative
        self.fast_s = fast_s
        self.slow_s = slow_s
        self._lock = threading.Lock()
        self._samples: deque[tuple[float, float, float]] = deque()  # guarded-by: _lock
        # last source-read failure, surfaced on /fleet/status so broken
        # SLO math (a renamed counter, a raising callback) can't hide
        # behind a silently-flat burn rate
        self.last_error: str | None = None

    def reconfigure(
        self, objective: float, fast_s: float, slow_s: float
    ) -> None:
        self.objective = objective
        self.fast_s = fast_s
        self.slow_s = slow_s

    def _sample(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._samples and now - self._samples[-1][0] < _MIN_SAMPLE_GAP_S:
                return
            try:
                total, bad = self.source()
            except Exception as e:  # noqa: BLE001 - a scrape never fails on SLO math
                # ...but it must never fail SILENTLY either: count it and
                # keep the last error readable (/fleet/status slo_errors)
                self.last_error = f"{type(e).__name__}: {e}"
                _sample_errors().inc(slo=self.slo)
                return
            self._samples.append((now, float(total), float(bad)))
            horizon = now - self.slow_s * 1.25 - 60.0
            while len(self._samples) > 2 and self._samples[1][0] < horizon:
                self._samples.popleft()

    def _bad_fraction(self, window_s: float) -> float:
        """Bad fraction of the requests that LANDED in the window (0.0
        when none did — an idle window is not an outage)."""
        now = time.monotonic()
        cutoff = now - window_s
        with self._lock:
            if not self._samples:
                return 0.0
            newest = self._samples[-1]
            base = self._samples[0]
            for s in self._samples:
                if s[0] <= cutoff:
                    base = s
                else:
                    break
        d_total = newest[1] - base[1]
        d_bad = newest[2] - base[2]
        if d_total <= 0:
            return 0.0
        return max(0.0, min(1.0, d_bad / d_total))

    def burn_rate(self, window_s: float) -> float:
        self._sample()
        budget = 1.0 - self.objective
        if budget <= 0:
            return 0.0
        return self._bad_fraction(window_s) / budget

    def budget_remaining(self) -> float:
        """Fraction of the slow window's error budget still unspent
        (negative = overspent — the alerting-friendly rendering)."""
        self._sample()
        budget = 1.0 - self.objective
        if budget <= 0:
            return 1.0
        return 1.0 - self._bad_fraction(self.slow_s) / budget


def _sample_errors():
    """The (lazily registered) sample-error counter: one series per SLO
    whose source read raised during a scrape."""
    return get_registry().counter(
        "oryx_slo_sample_errors_total",
        "SLO source reads that raised during burn-rate sampling, by SLO "
        "— a nonzero rate means that SLO's burn math is running on stale "
        "samples (see /fleet/status slo_errors for the last error)",
        labeled=True,
    )


def sample_errors() -> dict[str, str]:
    """slo -> last source-read error string, for every tracker that has
    one (the /fleet/status surface of the error counter)."""
    with _trackers_lock:
        return {
            name: t.last_error
            for name, t in _trackers.items()
            if t.last_error
        }


# -- sources over the existing metric families ------------------------------


def _serving_availability() -> tuple[float, float]:
    c = get_registry().counter("oryx_serving_requests_total")
    total = bad = 0.0
    for key, v in c.series().items():
        total += v
        if dict(key).get("status", "").startswith("5"):
            bad += v
    return total, bad


def _serving_latency(threshold_s: float) -> Callable[[], tuple[float, float]]:
    def read() -> tuple[float, float]:
        h = get_registry().histogram("oryx_serving_request_seconds")
        below, total = h.totals_below(threshold_s)
        return float(total), float(total - below)

    return read


def _front_availability() -> tuple[float, float]:
    c = get_registry().counter("oryx_fleet_front_requests_total")
    total = bad = 0.0
    for key, v in c.series().items():
        total += v
        if dict(key).get("replica") == "none":
            bad += v
    return total, bad


# -- registration -----------------------------------------------------------

_trackers: dict[str, SloTracker] = {}  # guarded-by: _trackers_lock
_trackers_lock = threading.Lock()


def tracker(slo: str) -> SloTracker | None:
    with _trackers_lock:
        return _trackers.get(slo)


def current_burn(slo: str, fast: bool = True) -> float | None:
    """The named SLO's current fast- (or slow-) window burn rate, or None
    when the tracker is not registered in this process. Trackers are
    scrape-driven and sample-gated, so this is cheap enough for gated
    hot-path probes (perfattr's burn-triggered profile capture)."""
    t = tracker(slo)
    if t is None:
        return None
    return t.burn_rate(t.fast_s if fast else t.slow_s)


def burn_snapshot() -> dict[str, dict[str, float]]:
    """slo -> {"fast": burn, "slow": burn} for every tracker registered
    in this process — the /healthz ``slo_burn`` section the fleet front's
    prober copies into /fleet/status, and the evidence block the canary
    gate's promote/rollback flight events carry. Same sample-gated math
    as the oryx_slo_burn_rate gauges, so a scrape and a probe in the
    same instant read one sample."""
    with _trackers_lock:
        items = list(_trackers.items())
    return {
        name: {
            "fast": round(t.burn_rate(t.fast_s), 4),
            "slow": round(t.burn_rate(t.slow_s), 4),
        }
        for name, t in items
    }


def _ensure(
    slo: str,
    objective: float,
    source: Callable[[], tuple[float, float]],
    fast_s: float,
    slow_s: float,
) -> SloTracker:
    reg = get_registry()
    g_burn = reg.gauge(
        "oryx_slo_burn_rate",
        "Error-budget burn rate of a config-declared SLO over its fast/"
        "slow window: observed bad fraction over (1 - objective); 1.0 = "
        "spending the budget exactly at the objective's rate",
        labeled=True,
    )
    g_budget = reg.gauge(
        "oryx_slo_error_budget_remaining",
        "Fraction of the slow window's error budget still unspent for a "
        "config-declared SLO (negative = overspent)",
        labeled=True,
    )
    with _trackers_lock:
        t = _trackers.get(slo)
        if t is None:
            t = SloTracker(slo, objective, source, fast_s, slow_s)
            _trackers[slo] = t
        else:
            t.source = source
            t.reconfigure(objective, fast_s, slow_s)
    # re-binding the same closures over the singleton tracker is harmless
    # and keeps the series alive across registry.clear() in tests
    g_burn.set_function(lambda: t.burn_rate(t.fast_s), slo=slo, window="fast")
    g_burn.set_function(lambda: t.burn_rate(t.slow_s), slo=slo, window="slow")
    g_budget.set_function(lambda: t.budget_remaining(), slo=slo)
    return t


def _windows(config) -> tuple[float, float]:
    fast = config.get_float("oryx.monitoring.slo.fast-window-sec", 300.0)
    slow = config.get_float("oryx.monitoring.slo.slow-window-sec", 3600.0)
    return max(0.001, fast), max(0.001, slow)


def ensure_serving_slos(config) -> None:
    """Register the serving layer's availability + latency SLOs from the
    oryx.monitoring.slo.* keys (called by ServingApp at construction)."""
    if not config.get_bool("oryx.monitoring.slo.enabled", True):
        return
    fast_s, slow_s = _windows(config)
    _ensure(
        "serving-availability",
        config.get_float("oryx.monitoring.slo.availability.objective", 0.999),
        _serving_availability,
        fast_s, slow_s,
    )
    threshold = config.get_float(
        "oryx.monitoring.slo.latency.threshold-sec", 0.25
    )
    _ensure(
        "serving-latency",
        config.get_float("oryx.monitoring.slo.latency.objective", 0.99),
        _serving_latency(threshold),
        fast_s, slow_s,
    )


def _quality_source() -> tuple[float, float]:
    """(shadow samples, samples below the recall floor) — cumulative
    totals the live quality sampler (common/qualitystats.py) counts."""
    reg = get_registry()
    total = sum(reg.counter("oryx_quality_samples_total").series().values())
    bad = sum(
        reg.counter("oryx_quality_bad_samples_total").series().values()
    )
    return total, bad


def ensure_quality_slo(config) -> None:
    """Register the live model-quality SLO (called by the quality
    sampler's configure when shadow sampling is on): a shadow sample is
    bad when its measured recall fell below the configured floor, so the
    burn rate answers "is the served model's live quality degrading
    faster than the objective allows" — the canary gate's quality leg."""
    if not config.get_bool("oryx.monitoring.slo.enabled", True):
        return
    fast_s, slow_s = _windows(config)
    _ensure(
        "quality",
        config.get_float("oryx.monitoring.slo.quality.objective", 0.95),
        _quality_source,
        fast_s, slow_s,
    )


def ensure_front_slos(config) -> None:
    """Register the fleet front's availability SLO (called by FleetFront
    at construction): a request is bad when no replica answered it."""
    if not config.get_bool("oryx.monitoring.slo.enabled", True):
        return
    fast_s, slow_s = _windows(config)
    _ensure(
        "front-availability",
        config.get_float("oryx.monitoring.slo.availability.objective", 0.999),
        _front_availability,
        fast_s, slow_s,
    )
