"""Flight recorder: a bounded on-disk ring of lifecycle events plus a
snapshot bundler — the serving process's black box (the port's copy of
oryx_tpu/common/flightrec.py; the ring's on-disk format is the same, so
either package's ``read_events`` reads the other's ring).

The in-memory observability (tracing ring, perfstats dispatch ring,
/metrics) dies with its process: when a replica is SIGKILLed mid
update-storm, the evidence evaporates at exactly the moment it is needed.
This module keeps the last seconds of STRUCTURED lifecycle evidence on
disk, where a supervisor or an operator can harvest it from the corpse:

- ``FlightRecorder.record(kind=..., **fields)`` appends one JSONL event
  to a bounded segment ring under the flight dir (``oryx.monitoring.
  flight.dir``): shed episodes, wedge transitions, generation adoptions,
  fault injections, health up→degraded flips. Every ``kind`` is
  registered in ``EVENT_KINDS`` and every event is stamped with pid, wall
  time, and the fleet replica id.
- ``snapshot()`` bundles the recent event ring, finished tracing spans,
  the perfstats dispatch ring, a /metrics text snapshot, and the config
  fingerprint into ONE artifact file — triggered by ``GET
  /debug/flight`` and automatically on a healthz up→degraded transition.
- ``harvest()`` packs a DEAD process's on-disk ring (crash-loop last
  words).

Recording is cheap (one locked JSONL append on rare lifecycle events;
``episode_s`` rate-limits bursty kinds like sheds) and ON by default:
like perfstats, the cost a switch would save is near zero, and a black
box that must be enabled before the crash records nothing.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

# Event-kind catalog: every `record(kind="...")` call site names one of
# these. The kinds are the JAX package's, so one ring reads the same
# whichever package wrote it; the fleet's are written by fleet/.
EVENT_KINDS: dict[str, str] = {
    "process-start": "a serving/fleet process configured its recorder",
    "ejection": "the fleet front ejected a replica from routing",
    "readmission": "the fleet front readmitted a replica",
    "shed-episode": "serving shed load (rate-limited episode marker)",
    "fallback": "device->host fallback scoring dispatches",
    "wedge": "a layer's wedge watchdog tripped or cleared",
    "generation": "a published model generation was adopted for serving",
    "fault-injection": "the deterministic fault harness fired",
    "health-degraded": "GET /healthz flipped up->degraded",
    "replica-death": "the fleet supervisor observed a replica corpse",
    "snapshot": "a flight snapshot bundle was written",
    "bench-stage": "a bench stage/phase lifecycle marker",
    "quality-alarm": (
        "live model quality degraded: the quality SLO's fast burn rate "
        "crossed the alarm threshold while windowed live recall sat "
        "below the floor"
    ),
    "drift-alarm": (
        "live input/prediction drift against the served generation's "
        "training profile crossed the alarm threshold"
    ),
    "compile-storm": (
        "the compile rate (here: kernel-library builds and loads) crossed "
        "the configured threshold within the rolling window — cold "
        "compiles are stealing device time"
    ),
    "profile-capture": (
        "a latency fast-burn triggered an automatic bounded profile "
        "window (perfstats summary + phase budget) into the ring"
    ),
    "canary-start": (
        "the fleet controller split a traffic cohort to the canary "
        "replica for a newly published generation"
    ),
    "canary-hold": (
        "a canary rollout is waiting for enough shadow-rescored samples "
        "to judge the new generation (episode-limited heartbeat)"
    ),
    "canary-promote": (
        "the canary generation passed its quality/latency/recall gate "
        "and was approved fleet-wide (hold replicas adopted it)"
    ),
    "canary-rollback": (
        "the canary generation was rolled back to its predecessor — a "
        "pointer swap from the pinned artifact cache — with the burn/"
        "recall evidence that forced it"
    ),
    "autoscale": (
        "the fleet controller changed capacity: up spawned and joined a "
        "replica, down drained one, stopped it, and removed its ring "
        "keys"
    ),
    "crash-loop": (
        "the fleet supervisor gave up restarting crash-looping replicas "
        "(max fast fails reached); the affected replicas surface as "
        "state=gave_up on /fleet/status"
    ),
}

_SEGMENT_PREFIX = "events-"
_DEFAULT_SEGMENT_BYTES = 262144
_DEFAULT_SEGMENTS = 4
_SNAPSHOTS_KEPT = 8


def _strip_scheme(path: str) -> str:
    return path[5:] if path.startswith("file:") else path


class FlightRecorder:
    """Bounded on-disk JSONL event ring + snapshot bundler.

    Segment files ``events-<n>.jsonl`` roll at ``segment_bytes``; only
    the newest ``segments`` are kept, so the ring is bounded in bytes no
    matter how long the process lives. Appends happen under one lock
    (events are rare lifecycle moments, never the request hot path)."""

    def __init__(self):
        self.dir: str | None = None
        self.enabled = True
        self.replica_id: str | None = None
        self.segment_bytes = _DEFAULT_SEGMENT_BYTES
        self.segments = _DEFAULT_SEGMENTS
        self.config_fingerprint: str | None = None
        self._lock = threading.Lock()
        self._seg_index = 0        # guarded-by: _lock
        self._seg_written = 0      # guarded-by: _lock (bytes in current segment)
        self._scanned = False      # guarded-by: _lock (resume index found)
        self._last_episode: dict[str, float] = {}  # guarded-by: _lock

    # -- configuration -----------------------------------------------------

    def configure(self, config) -> None:
        """Adopt the oryx.monitoring.flight.* keys (each layer runtime
        calls this at construction; last writer wins, the one-config-
        per-process convention). Also captures the config fingerprint the
        snapshot bundle carries — a crash artifact must say which config
        the corpse was running."""
        self.enabled = config.get_bool("oryx.monitoring.flight.enabled", True)
        raw_dir = config.get_string(
            "oryx.monitoring.flight.dir", "file:/tmp/oryx_tpu/flight"
        )
        new_dir = _strip_scheme(raw_dir) if raw_dir else None
        if new_dir != self.dir:
            # a different dir is a different ring: episode rate-limit
            # state from the old ring must not suppress the new ring's
            # first events (an episode marker the new ring never saw)
            with self._lock:
                self._last_episode.clear()
        self.dir = new_dir
        self.segment_bytes = max(
            4096,
            config.get_int(
                "oryx.monitoring.flight.segment-bytes", _DEFAULT_SEGMENT_BYTES
            ),
        )
        self.segments = max(
            2, config.get_int("oryx.monitoring.flight.segments", _DEFAULT_SEGMENTS)
        )
        self.replica_id = config.get_string("oryx.fleet.replica.id", None)
        try:
            self.config_fingerprint = hashlib.sha256(
                config.serialize().encode("utf-8")
            ).hexdigest()[:16]
        except Exception:  # noqa: BLE001 - a fingerprint never blocks startup
            self.config_fingerprint = None
        with self._lock:
            self._scanned = False  # re-resolve the resume segment for the new dir

    # -- recording ---------------------------------------------------------

    def record(self, *, kind: str, episode_s: float | None = None, **fields) -> bool:
        """Append one event; returns True when written. ``kind`` must be a
        literal from EVENT_KINDS.
        ``episode_s`` rate-limits bursty kinds: within that many seconds
        of the previous same-kind event the call is a no-op dict probe —
        the idiom for shed storms, where the EPISODE is the story and a
        per-request event would just churn the ring (and do disk I/O
        under the shed decision's lock)."""
        if not self.enabled or not self.dir:
            return False
        now = time.time()
        with self._lock:
            if episode_s is not None:
                last = self._last_episode.get(kind, 0.0)
                if now - last < episode_s:
                    return False
                self._last_episode[kind] = now
            event = {"ts_ms": int(now * 1000), "kind": kind, "pid": os.getpid()}
            if self.replica_id:
                event["replica"] = self.replica_id
            event.update(fields)
            try:
                self._append_locked(json.dumps(event, default=str) + "\n")
            except OSError:
                return False  # a full/missing disk must never break the caller
        return True

    def _append_locked(self, line: str) -> None:  # holds _lock
        os.makedirs(self.dir, exist_ok=True)
        if not self._scanned:
            self._resume_locked()
        if self._seg_written >= self.segment_bytes:
            self._seg_index += 1
            self._seg_written = 0
            stale = f"{_SEGMENT_PREFIX}{self._seg_index - self.segments}.jsonl"
            try:
                os.unlink(os.path.join(self.dir, stale))
            except OSError:
                pass
        path = os.path.join(
            self.dir, f"{_SEGMENT_PREFIX}{self._seg_index}.jsonl"
        )
        data = line.encode("utf-8")
        with open(path, "ab") as f:
            f.write(data)
        self._seg_written += len(data)

    def _resume_locked(self) -> None:  # holds _lock
        """Continue the newest existing segment (restarted process, or a
        sibling writer in the same dir) instead of clobbering index 0. A
        torn tail (the previous writer died mid-append) is repaired with
        one newline so the next event starts on its own line — the torn
        fragment becomes a skipped bad line, not a corrupter of the next
        good one."""
        newest, size = 0, 0
        for name in os.listdir(self.dir):
            if name.startswith(_SEGMENT_PREFIX) and name.endswith(".jsonl"):
                try:
                    idx = int(name[len(_SEGMENT_PREFIX):-6])
                except ValueError:
                    continue
                if idx >= newest:
                    newest = idx
                    try:
                        size = os.path.getsize(os.path.join(self.dir, name))
                    except OSError:
                        size = 0
        if size > 0:
            path = os.path.join(self.dir, f"{_SEGMENT_PREFIX}{newest}.jsonl")
            try:
                with open(path, "rb+") as f:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                        size += 1
            except OSError:
                pass
        self._seg_index, self._seg_written = newest, size
        self._scanned = True

    # -- reading -----------------------------------------------------------

    def events(self, limit: int = 0) -> list[dict]:
        d = self.dir
        return read_events(d, limit=limit) if d else []

    # -- snapshot bundling -------------------------------------------------

    def snapshot(self, trigger: str, extra: dict | None = None) -> tuple[dict, str | None]:
        """Bundle the black box into one artifact: recent flight events,
        finished tracing spans (span forest), the perfstats dispatch
        ring, a /metrics text snapshot, and the config fingerprint.
        Returns (bundle, path-on-disk); the path is None when no flight
        dir is configured (the bundle is still returned for HTTP
        callers)."""
        from oryx_tpu_torch.common.metrics import get_registry
        from oryx_tpu_torch.common.perfstats import get_perfstats
        from oryx_tpu_torch.common.tracing import get_tracer, span_forest

        tr = get_tracer()
        bundle: dict = {
            "trigger": trigger,
            "ts_ms": int(time.time() * 1000),
            "pid": os.getpid(),
            "replica": self.replica_id,
            "config_fingerprint": self.config_fingerprint,
            "events": self.events(limit=512),
            "traces": span_forest(tr.snapshot()) if tr.enabled else [],
            "dispatch_ring": [
                {
                    "kind": r.kind,
                    "wall_s": round(r.wall_s, 6),
                    "flops": r.flops,
                    "bytes_moved": r.bytes_moved,
                    "rows": r.rows,
                    "occupancy": round(r.occupancy, 4),
                    "trace_id": r.trace_id or "",
                    "score_mode": r.score_mode or "",
                }
                for r in get_perfstats().records_since(0.0)[-256:]
            ],
            "metrics": get_registry().render_prometheus(),
        }
        if extra:
            bundle.update(extra)
        path = None
        if self.dir and self.enabled:
            try:
                snap_dir = os.path.join(self.dir, "snapshots")
                os.makedirs(snap_dir, exist_ok=True)
                path = os.path.join(
                    snap_dir, f"flight-{trigger}-{bundle['ts_ms']}.json"
                )
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(bundle, f)
                os.replace(tmp, path)
                _prune_snapshots(snap_dir)
            except OSError:
                path = None
        self.record(kind="snapshot", trigger=trigger, path=path or "")
        return bundle, path

    def snapshot_async(self, trigger: str, event: dict | None = None) -> None:
        """Fire-and-forget snapshot on a daemon thread — the healthz
        up→degraded trigger runs on an event loop, which must not pay
        the bundle's file writes and metrics render inline. ``event``
        ({"kind": ..., fields}) is recorded FIRST on the same thread, so
        the triggering lifecycle event also stays off the caller's loop
        (a degrading disk is a common cause of degradation — the record
        that documents it must not block the loop on that same disk)."""

        def _snap() -> None:  # runs on a one-shot snapshot thread
            try:
                if event is not None:
                    self.record(**event)
                self.snapshot(trigger)
            except Exception:  # noqa: BLE001 - the black box never raises out
                log.exception("flight snapshot (%s) failed", trigger)

        threading.Thread(
            target=_snap, name="oryx-flight-snapshot", daemon=True
        ).start()


def read_events(flight_dir: str, limit: int = 0) -> list[dict]:
    """Parse the segment ring under ``flight_dir`` oldest-first (bad lines
    skipped — a torn tail write must not hide the rest of the ring)."""
    flight_dir = _strip_scheme(flight_dir)
    segs: list[tuple[int, str]] = []
    try:
        for name in os.listdir(flight_dir):
            if name.startswith(_SEGMENT_PREFIX) and name.endswith(".jsonl"):
                try:
                    segs.append((int(name[len(_SEGMENT_PREFIX):-6]), name))
                except ValueError:
                    continue
    except OSError:
        return []
    out: list[dict] = []
    for _, name in sorted(segs):
        try:
            with open(os.path.join(flight_dir, name), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(ev, dict):
                        out.append(ev)
        except OSError:
            continue
    return out[-limit:] if limit > 0 else out


def harvest(flight_dir: str, **meta) -> str | None:
    """Pack a (possibly dead) process's on-disk event ring into one
    harvest artifact under ``<flight_dir>/harvest/`` — the supervisor's
    crash-loop-last-words path. Works
    on a corpse: reads only the segment files the dead process left.
    Returns the artifact path, or None when the dir never existed (the
    process died before recording anything)."""
    flight_dir = _strip_scheme(flight_dir)
    if not os.path.isdir(flight_dir):
        return None
    events = read_events(flight_dir)
    artifact = {
        "harvested_ms": int(time.time() * 1000),
        "harvested_by_pid": os.getpid(),
        "flight_dir": flight_dir,
        "events": events,
        **meta,
    }
    try:
        hdir = os.path.join(flight_dir, "harvest")
        os.makedirs(hdir, exist_ok=True)
        path = os.path.join(hdir, f"harvest-{artifact['harvested_ms']}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(artifact, f)
        os.replace(tmp, path)
        _prune_snapshots(hdir)
        return path
    except OSError:
        log.exception("flight harvest of %s failed", flight_dir)
        return None


def _prune_snapshots(snap_dir: str, kept: int = _SNAPSHOTS_KEPT) -> None:
    """Keep the newest `kept` artifacts — the snapshot/harvest dirs must
    stay bounded like the ring they bundle."""
    try:
        files = sorted(
            n for n in os.listdir(snap_dir) if n.endswith(".json")
        )
    except OSError:
        return
    for name in files[:-kept] if len(files) > kept else []:
        try:
            os.unlink(os.path.join(snap_dir, name))
        except OSError:
            pass


# -- process-global recorder ------------------------------------------------

_default = FlightRecorder()


def get_flightrec() -> FlightRecorder:
    return _default


def configure_flightrec(config) -> FlightRecorder:
    _default.configure(config)
    return _default
