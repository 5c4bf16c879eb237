"""Shared bounded-retry policy: exponential backoff + jitter + deadline.

The reference outsourced transient-failure absorption to its substrates —
Kafka client retries, Spark task re-execution. This reproduction replaced
both, so the equivalent contract lives here: one policy object, one
``retry_call`` wrapper, threaded around the bus produce/consume and
datastore write/rename paths. Every wrapped site reports
``oryx_retry_total{site,outcome}``:

    outcome="retry"      an attempt failed and will be retried
    outcome="recovered"  the call eventually succeeded after >= 1 retry
    outcome="exhausted"  attempts/deadline ran out; the error propagates

so a scrape distinguishes "the disk hiccuped and we absorbed it" from
"we are paying retries constantly" — the second is a pager signal long
before the first exhausted error surfaces.

Only *transient* error classes retry (default: OSError family — which
includes the fault harness's InjectedFault — plus ConnectionError and
TimeoutError). Deterministic failures (parse errors, bad config) propagate
on the first attempt: retrying them only delays the loud failure.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass

from oryx_tpu_torch.common.config import Config

log = logging.getLogger(__name__)

# Error classes worth retrying by default: transient I/O. InjectedFault
# (common/faults.py) subclasses OSError so chaos-injected failures take
# exactly this path.
TRANSIENT = (OSError, ConnectionError, TimeoutError)


@dataclass(frozen=True)
class RetryPolicy:
    """attempts = total tries (1 = no retry); backoff doubles from base_s
    to max_s with multiplicative jitter; deadline_s bounds the whole call
    including sleeps, so a retry storm cannot stall a generation loop
    past its interval."""

    attempts: int = 4
    base_s: float = 0.025
    max_s: float = 2.0
    deadline_s: float = 15.0
    jitter: float = 0.25

    @staticmethod
    def from_config(config: Config) -> "RetryPolicy":
        return RetryPolicy(
            attempts=config.get_int("oryx.monitoring.retry.attempts", 4),
            base_s=config.get_int("oryx.monitoring.retry.base-ms", 25) / 1000.0,
            max_s=config.get_int("oryx.monitoring.retry.max-ms", 2000) / 1000.0,
            deadline_s=config.get_int("oryx.monitoring.retry.deadline-ms", 15000)
            / 1000.0,
            jitter=config.get_float("oryx.monitoring.retry.jitter", 0.25),
        )

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry `attempt` (1-based), jittered UP only so the
        base remains a floor (coordinated thundering retries decorrelate,
        but a tightened test policy keeps its configured pacing)."""
        d = min(self.max_s, self.base_s * (2.0 ** (attempt - 1)))
        return d * (1.0 + self.jitter * random.random())


_default_policy = RetryPolicy()


def configure_retry(config: Config) -> None:
    """Adopt the config's policy as the process default (layers call this
    at construction, like configure_tracing)."""
    global _default_policy
    _default_policy = RetryPolicy.from_config(config)


def default_policy() -> RetryPolicy:
    return _default_policy


_m_retries = None


def _metric():
    global _m_retries
    if _m_retries is None:
        from oryx_tpu_torch.common.metrics import get_registry

        _m_retries = get_registry().counter(
            "oryx_retry_total",
            "Bounded-retry events by site and outcome (retry = attempt "
            "failed and will be retried, recovered = succeeded after "
            "retries, exhausted = gave up and propagated)",
            labeled=True,
        )
    return _m_retries


def ensure_metrics() -> None:
    """Register oryx_retry_total now (empty, HELP/TYPE only) so scrapes
    see the series family from process start instead of after the first
    retry event — alerts need the zero baseline."""
    _metric()


def retry_call(
    site: str,
    fn,
    *args,
    policy: RetryPolicy | None = None,
    retry_on: tuple = TRANSIENT,
    **kwargs,
):
    """Call fn(*args, **kwargs) under the bounded-retry contract. Errors
    outside `retry_on` propagate immediately; errors inside it retry with
    backoff until attempts or the deadline run out, then the LAST error
    propagates (outcome="exhausted")."""
    p = policy or _default_policy
    deadline = time.monotonic() + p.deadline_s
    attempt = 0
    while True:
        try:
            result = fn(*args, **kwargs)
        except retry_on as e:
            attempt += 1
            sleep_s = p.backoff_s(attempt)
            if attempt >= p.attempts or time.monotonic() + sleep_s > deadline:
                _metric().inc(site=site, outcome="exhausted")
                log.error(
                    "%s failed permanently after %d attempt(s): %s",
                    site, attempt, e,
                )
                raise
            _metric().inc(site=site, outcome="retry")
            log.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.0fms",
                site, attempt, p.attempts, e, sleep_s * 1000,
            )
            time.sleep(sleep_s)
        else:
            if attempt:
                _metric().inc(site=site, outcome="recovered")
            return result
