"""Deterministic fault-injection harness (the port's copy of
oryx_tpu/common/faults.py).

Failure handling that has never been exercised is a guess: the reference
leans on Kafka redelivery and Spark task retry, both of which it could
only observe in production outages. Here every recovery path is a
first-class, *testable* contract — named injection points are threaded
through the bus, datastore, layer, and serving code, and a seeded
injector arms exact failure sequences so chaos tests (tests/test_chaos.py,
tools/chaos.py) can script "the second bus produce of this generation
fails" and assert convergence, byte for byte.

Injection sites currently wired (grep `faults.fire(` for the live list):

    bus.produce              TopicProducer.send / send_batch
    bus.consume              ConsumeDataIterator broker reads
    bus.commit               ConsumeDataIterator.commit
    datastore.save_window    save_generation window persist
    datastore.snapshot_write staged aggregate-snapshot write
    datastore.snapshot_rename staged snapshot promote (finalize)
    speed.build              SpeedLayer micro-batch build
    batch.build              BatchLayer generation build
    serving.device           TopKBatcher device dispatch

A disarmed site costs one module-attribute read plus one dict probe — the
harness is safe to leave compiled into production paths. Arming happens
either programmatically (tests: ``get_injector().arm(...)``) or from
config (``oryx.monitoring.faults.enabled`` + ``plan``), so tools/chaos.py
can drive real multi-process runs through the same specs:

    oryx.monitoring.faults = {
      enabled = true
      seed = 7
      plan = [
        { site = "bus.produce", kind = "error", count = 2 }
        { site = "serving.device", kind = "latency", latency-sec = 2.0 }
      ]
    }

Kinds: ``error`` raises InjectedFault (an OSError, so retry wrappers treat
it as the transient I/O failure it simulates), ``latency`` sleeps,
``crash`` hard-exits the process (os._exit) — the only honest way to test
kill-between-write-and-rename recovery across a process boundary.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field

from oryx_tpu_torch.common.config import Config

log = logging.getLogger(__name__)

_KINDS = ("error", "latency", "crash")


class InjectedFault(OSError):
    """Raised by an armed ``error`` fault. Subclasses OSError on purpose:
    injected faults at bus/datastore sites simulate transient I/O
    failures, and the retry wrappers (common/retry.py) must classify them
    exactly as they would the real thing."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site}")
        self.site = site


@dataclass
class FaultSpec:
    """One armed injection: fires at `site` while `count` remains."""

    site: str
    kind: str = "error"
    count: int = 1           # firings remaining; -1 = unlimited
    after: int = 0           # clean passes through the site before arming
    probability: float = 1.0  # seeded coin per eligible pass when < 1
    latency_s: float = 0.0   # sleep for kind="latency"
    message: str = ""
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"bad fault kind {self.kind!r}; want one of {_KINDS}")


class FaultInjector:
    """Process-global registry of armed FaultSpecs, consulted by
    ``fire(site)`` calls at the injection points."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, FaultSpec] = {}
        self.enabled = False
        self._rng = None  # seeded lazily on first probabilistic spec
        self._seed = 0
        self._m_injections = None

    # -- arming ------------------------------------------------------------

    def configure(self, config: Config) -> None:
        """Read oryx.monitoring.faults.*; a disabled config disarms
        everything (so test overlays can't leak into the next layer
        constructed in the same process)."""
        enabled = config.get_bool("oryx.monitoring.faults.enabled", False)
        self._seed = config.get_int("oryx.monitoring.faults.seed", 0)
        if not enabled:
            if self._specs or self.enabled:
                self.disarm()
            return
        plan = config.get_list("oryx.monitoring.faults.plan", [])
        with self._lock:
            self._specs = {}
            self._rng = None
        for entry in plan:
            if not isinstance(entry, dict) or "site" not in entry:
                raise ValueError(f"bad faults.plan entry: {entry!r}")
            self.arm(
                str(entry["site"]),
                kind=str(entry.get("kind", "error")),
                count=int(entry.get("count", 1)),
                after=int(entry.get("after", 0)),
                probability=float(entry.get("probability", 1.0)),
                latency_s=float(entry.get("latency-sec", 0.0)),
                message=str(entry.get("message", "")),
            )

    def arm(self, site: str, **kw) -> FaultSpec:
        spec = FaultSpec(site=site, **kw)
        with self._lock:
            self._specs[site] = spec
            self.enabled = True
        log.warning("fault armed: %s %s (count=%d)", site, spec.kind, spec.count)
        return spec

    def disarm(self, site: str | None = None) -> None:
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)
            self.enabled = bool(self._specs)

    def spec(self, site: str) -> FaultSpec | None:
        with self._lock:
            return self._specs.get(site)

    # -- firing ------------------------------------------------------------

    def fire(self, site: str) -> None:
        """Consult the armed plan at an injection point. No-op (one dict
        probe) unless a spec for `site` is armed and eligible."""
        with self._lock:
            spec = self._specs.get(site)
            if spec is None:
                return
            if spec.after > 0:
                spec.after -= 1
                return
            if spec.count == 0:
                return
            if spec.probability < 1.0:
                if self._rng is None:
                    import random

                    self._rng = random.Random(self._seed)
                if self._rng.random() >= spec.probability:
                    return
            if spec.count > 0:
                spec.count -= 1
            spec.fired += 1
            kind, latency, message = spec.kind, spec.latency_s, spec.message
        self._count(site, kind)
        if kind == "latency":
            log.warning("injecting %.3fs latency at %s", latency, site)
            time.sleep(latency)
            return
        if kind == "crash":
            log.error("injected CRASH at %s — exiting hard", site)
            os._exit(137)
        log.warning("injecting fault at %s", site)
        raise InjectedFault(site, message)

    def ensure_metrics(self):
        if self._m_injections is None:
            from oryx_tpu_torch.common.metrics import get_registry

            self._m_injections = get_registry().counter(
                "oryx_fault_injections_total",
                "Faults fired by the injection harness, by site and kind "
                "(nonzero outside chaos runs means someone left a plan armed)",
                labeled=True,
            )
        return self._m_injections

    def _count(self, site: str, kind: str) -> None:
        self.ensure_metrics().inc(site=site, kind=kind)
        from oryx_tpu_torch.common.flightrec import get_flightrec

        # every fired fault is a flight event: a crash artifact that was
        # CAUSED by an armed plan must say so, and a "crash" kind fires
        # os._exit right after this — the disk line is the only witness
        get_flightrec().record(kind="fault-injection", site=site, fault=kind)


_injector = FaultInjector()


def get_injector() -> FaultInjector:
    return _injector


def fire(site: str) -> None:
    """Module-level injection point: the disarmed fast path is one
    attribute read, so hot paths call this unconditionally."""
    if _injector.enabled:
        _injector.fire(site)


def configure_faults(config: Config) -> None:
    _injector.configure(config)
