"""Replica supervisor: N serving processes on one host, distinct ports (the
port's copy of oryx_tpu/fleet/supervisor.py).

The in-process scaling story multiplies event loops over ONE model
(``oryx.serving.api.loops``); the fleet multiplies PROCESSES, each
an independent stateless consumer of the update topic (the lambda
contract, PAPER.md) with its own model replica, GIL, and failure domain.
The supervisor launches them as real OS processes — the same
``python -m oryx_tpu_torch.cli serving`` an operator would run per host,
each opening the CUDA card unless ``oryx.compute.platform = cpu`` says
otherwise — with a per-replica config overlay: its own port
(``base-port + i``), a
replica identity (``oryx.fleet.replica.id``) that the /healthz degraded
surface and the front's ejection log name, a namespaced ``oryx.id`` so
consumer groups/offset stores never collide, and per-replica scratch
dirs under ``oryx.fleet.data-dir``. Everything else — the broker, the
model dir, the update topic — is shared: model distribution is the bus's
job (amortized per host by the shared artifact relay,
``common/artifact.py``).

Dead replicas are restarted with exponential backoff; a fleet whose
replicas keep dying within seconds of spawn is crash-looping (bad
config, port conflict) and the supervisor gives up loudly instead of
hammering the port forever.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time

from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.ioutil import strip_scheme

log = logging.getLogger(__name__)

# a replica dying within this many seconds of spawn counts as a fast
# fail (crash loop), not an operational death
_FAST_FAIL_S = 10.0


def replica_overlays(
    config: Config,
    n: int | None = None,
    base_port: int | None = None,
    shards: int | None = None,
) -> list[dict[str, object]]:
    """Per-replica ``--set`` overlays for an N-replica fleet on this host.

    Shared config stays shared (broker, topics, model dir); only identity
    and per-process resources differ per replica. Exposed as a function so
    tests and the bench can build the exact child configs without spawning.

    ``shards`` (default ``oryx.fleet.shards``) is the fleet's SECOND
    scaling dimension: every replica serves its device view row-sharded
    across that many shards (oryx.serving.api.sync.shard-count — one
    device per shard on multi-card hosts), so the fleet scales replicas
    (processes / failure domains) x shards (devices / device memory).
    The front probes the same number back off /healthz and treats a
    mis-sharded replica as degraded.
    """
    if n is None:
        n = config.get_int("oryx.fleet.replicas", 2)
    if base_port is None:
        base_port = config.get_int("oryx.fleet.base-port", 8100)
    if shards is None:
        shards = config.get_int("oryx.fleet.shards", 1)
    if n < 1:
        raise ValueError(f"fleet needs >= 1 replica, got {n}")
    if shards < 1:
        raise ValueError(f"fleet needs >= 1 shard per replica, got {shards}")
    data_root = strip_scheme(
        config.get_string("oryx.fleet.data-dir", "file:/tmp/oryx_tpu/fleet")
    )
    base_id = config.get_string("oryx.id", None) or "fleet"
    # staged rollout (fleet/control.py): with the canary plane enabled,
    # ONE replica runs its model gate in canary mode (adopts every
    # generation immediately, keeps rollback history) and the rest run
    # in hold mode (park new generations until the controller promotes)
    # — the per-replica half of "a new generation lands on the canary
    # first" despite the update topic broadcasting to everyone
    canary_rid = (
        config.get_string("oryx.fleet.canary.replica", "r0")
        if config.get_bool("oryx.fleet.canary.enabled", False)
        else None
    )
    overlays: list[dict[str, object]] = []
    for i in range(n):
        rid = f"r{i}"
        overlays.append(
            {
                # identity: names this process in /healthz degraded
                # reasons, the front's ejection log, and fleet metrics
                "oryx.fleet.replica.id": rid,
                "oryx.serving.api.port": base_port + i,
                # each replica is a full process already; nested replica
                # supervision would fork N^2 servers
                "oryx.serving.api.processes": 1,
                # namespaced deployment id -> distinct consumer groups and
                # offset stores per replica (each replays the update topic
                # independently, the stateless-consumer contract)
                "oryx.id": f"{base_id}-{rid}",
                # per-replica scratch: quarantined records name their
                # replica instead of interleaving in one dead-letter dir
                "oryx.monitoring.quarantine.dir": os.path.join(
                    data_root, rid, "quarantine"
                ),
                # per-replica flight-recorder ring: the black box the
                # supervisor harvests from a corpse before restarting it
                # (common/flightrec.py) — sharing one dir would interleave
                # every replica's last words
                "oryx.monitoring.flight.dir": os.path.join(
                    data_root, rid, "flight"
                ),
            }
        )
        if canary_rid is not None:
            overlays[-1]["oryx.serving.model-gate.mode"] = (
                "canary" if rid == canary_rid else "hold"
            )
        if shards > 1:
            # the sharded-view knob rides the overlay so every replica of
            # this fleet serves the same (replicas x shards) topology
            # (oryxlint shard-topology: oryx.fleet.shards must overlay
            # the sync shard-count or the fleet knob is a silent no-op)
            overlays[-1]["oryx.serving.api.sync.shard-count"] = shards
    return overlays


class FleetSupervisor:
    """Launches and monitors the replica processes of a one-host fleet.

    ``argv`` is the passthrough command line (``--conf``/``--set`` flags)
    every replica child receives BEFORE its per-replica overlay — later
    ``--set`` wins, so the overlay's port/id always take effect.
    """

    def __init__(
        self,
        config: Config,
        argv: list[str] | None = None,
        n: int | None = None,
        base_port: int | None = None,
        env: dict | None = None,
        stdout=None,
        stderr=None,
        exec_prefixes: list[list[str]] | None = None,
        shards: int | None = None,
    ):
        self.config = config
        self.overlays = replica_overlays(config, n, base_port, shards)
        # the raw topology args, kept so scale_up() can extend the
        # overlay table with the same resolution rules as construction
        self._base_port_arg = base_port
        self._shards_arg = shards
        # per-replica command prefixes (e.g. ["taskset", "-c", "0"]):
        # affinity set at exec time is inherited by every thread the
        # replica spawns, unlike a post-hoc sched_setaffinity(pid) which
        # on Linux pins only the main thread
        if exec_prefixes is not None and len(exec_prefixes) != len(self.overlays):
            raise ValueError(
                f"exec_prefixes has {len(exec_prefixes)} entries for "
                f"{len(self.overlays)} replicas"
            )
        self.exec_prefixes = exec_prefixes
        self.restart = config.get_bool("oryx.fleet.supervisor.restart", True)
        self.max_fast_fails = config.get_int(
            "oryx.fleet.supervisor.max-fast-fails", 6
        )
        self.argv = list(argv or [])
        self.env = dict(env if env is not None else os.environ)
        self._stdout = stdout
        self._stderr = stderr
        # () -> {config key: value} added to every spawned replica's
        # overlay; the fleet controller wires its gate_overlay here
        self.restart_overlay = None
        # one lock serializes process-table mutation: poll()'s restart
        # pass, kill()'s chaos signal, and stop()'s teardown all touch
        # procs[i] from different threads, and an unserialized poll could
        # even respawn a replica stop() had just terminated
        self._op_lock = threading.Lock()
        self.procs: list[subprocess.Popen | None] = [None] * len(self.overlays)  # guarded-by: _op_lock
        self._spawned_at: list[float] = [0.0] * len(self.overlays)  # guarded-by: _op_lock
        # a death is CLASSIFIED (fast-fail accounting, backoff growth)
        # exactly once, when first observed — a corpse waiting out its
        # restart backoff must not be re-counted by every poll() tick, or
        # crash-loop detection counts supervision ticks instead of deaths
        self._death_counted: list[bool] = [False] * len(self.overlays)  # guarded-by: _op_lock
        self._fast_fails = 0  # guarded-by: _op_lock
        self._backoff = 1.0  # guarded-by: _op_lock
        self._next_restart = 0.0  # guarded-by: _op_lock
        self.crash_looping = False
        # replica ids the supervisor stopped restarting (crash-loop
        # give-up) — the controller mirrors these into the front's
        # routing table as state=gave_up, so /fleet/status tells an
        # operator WHY a replica is out instead of showing a silent hole
        self.gave_up: list[str] = []  # guarded-by: _op_lock
        # slots stop_replica() emptied on purpose (scale-down): poll()
        # never restarts them, scale_up() refills the lowest one first
        # so ports stay dense
        self._scaled_down: set[int] = set()  # guarded-by: _op_lock
        self._stopping = threading.Event()
        # flight artifacts harvested from dead replicas (newest last) —
        # the crash-loop-last-words paths an operator or chaos assertion
        # reads back
        self.harvested: list[str] = []  # guarded-by: _op_lock

    # -- topology ----------------------------------------------------------

    def backends(self) -> list[tuple[str, str, int]]:
        """(replica id, host, port) rows in the shape FleetFront takes."""
        return [
            (str(o["oryx.fleet.replica.id"]), "127.0.0.1", int(o["oryx.serving.api.port"]))
            for o in self.overlays
        ]

    def ports(self) -> list[int]:
        return [int(o["oryx.serving.api.port"]) for o in self.overlays]

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, i: int) -> subprocess.Popen:  # oryxlint: holds=_op_lock
        prefix = self.exec_prefixes[i] if self.exec_prefixes else []
        cmd = [*prefix, sys.executable, "-m", "oryx_tpu_torch.cli", "serving", *self.argv]
        for k, v in self.overlays[i].items():
            cmd += ["--set", f"{k}={v}"]
        # what the fleet decided so far (the controller's gate_overlay):
        # a replica spawned after a rollback never adopts the vetoed
        # generation when it replays the update topic
        extra = self.restart_overlay() if self.restart_overlay else {}
        for k, v in extra.items():
            cmd += ["--set", f"{k}={json.dumps(v)}"]
        p = subprocess.Popen(
            cmd, env=self.env, stdout=self._stdout, stderr=self._stderr
        )
        self._spawned_at[i] = time.monotonic()
        log.info(
            "fleet supervisor: replica %s (pid %d) on port %d",
            self.overlays[i]["oryx.fleet.replica.id"],
            p.pid,
            self.overlays[i]["oryx.serving.api.port"],
        )
        return p

    def start(self) -> None:
        with self._op_lock:
            for i in range(len(self.overlays)):
                self.procs[i] = self._spawn(i)

    def wait_listening(self, timeout: float = 90.0) -> None:
        """Block until every replica answers ``HEAD /healthz`` (pure
        liveness — 200 as soon as the frontend dispatches, independent of
        model readiness). Raises if a replica dies or the deadline
        passes."""
        import http.client

        deadline = time.monotonic() + timeout
        pending = set(range(len(self.overlays)))
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replicas never started listening: "
                    f"{sorted(self.ports()[i] for i in pending)}"
                )
            for i in sorted(pending):
                with self._op_lock:
                    p = self.procs[i]
                if p is not None and p.poll() is not None:
                    raise RuntimeError(
                        f"replica {i} exited rc={p.returncode} before "
                        "listening"
                    )
                try:
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", self.ports()[i], timeout=2
                    )
                    try:
                        conn.request("HEAD", "/healthz")
                        if conn.getresponse().status == 200:
                            pending.discard(i)
                    finally:
                        conn.close()
                except (OSError, http.client.HTTPException):
                    # a probe of a port no one listens on yet may connect
                    # to itself (a TCP self-connect when the port lies in
                    # the ephemeral range) and read its own request back
                    pass
            if pending:
                time.sleep(0.2)

    def poll(self) -> None:
        """One supervision pass: restart dead replicas (with backoff),
        flag a crash loop. Call periodically, or let run() do it. The
        whole pass holds _op_lock so a concurrent stop() cannot terminate
        the fleet between the death check and a respawn (the respawned
        replica would be orphaned past stop's terminate loop)."""
        with self._op_lock:
            self._poll_locked()

    def _poll_locked(self) -> None:  # oryxlint: holds=_op_lock
        if self._stopping.is_set():
            return
        now = time.monotonic()
        for i, p in enumerate(self.procs):
            if p is None or p.poll() is None:
                continue
            if not self._death_counted[i]:
                self._death_counted[i] = True
                # harvest the corpse's flight ring FIRST — before any
                # restart decision, and regardless of whether restarts
                # are even enabled: the black box is the point of
                # observing a death at all (crash-loop last words)
                self._harvest_flight(i, p.returncode)
                # fast-fail accounting stays gated exactly as before:
                # with restarts off (or already crash-looping) a death is
                # an operator decision, not a loop to detect
                rid = str(self.overlays[i]["oryx.fleet.replica.id"])
                if self.restart and not self.crash_looping:
                    fast = now - self._spawned_at[i] < _FAST_FAIL_S
                    if fast:
                        self._fast_fails += 1
                        if self._fast_fails >= self.max_fast_fails:
                            log.error(
                                "fleet supervisor: replicas crash-looping "
                                "(rc=%s); giving up on restarts",
                                p.returncode,
                            )
                            self.crash_looping = True
                            self.gave_up.append(rid)
                            # the give-up is a lifecycle decision with
                            # evidence, not just a log line: cli flight
                            # replays it next to the deaths that caused it
                            try:
                                from oryx_tpu_torch.common.flightrec import (
                                    get_flightrec,
                                )

                                get_flightrec().record(
                                    kind="crash-loop", replica=rid,
                                    returncode=p.returncode,
                                    fast_fails=self._fast_fails,
                                    max_fast_fails=self.max_fast_fails,
                                    harvests=len(self.harvested),
                                )
                            except Exception:  # noqa: BLE001
                                log.exception("crash-loop flight event failed")
                            return
                        self._backoff = min(self._backoff * 2, 30.0)
                    else:
                        self._fast_fails = 0
                        self._backoff = 1.0
                elif self.crash_looping and rid not in self.gave_up:
                    # deaths after the give-up are equally permanent
                    self.gave_up.append(rid)
            if not self.restart or self.crash_looping:
                continue
            if now < self._next_restart:
                continue
            log.warning(
                "fleet supervisor: replica %d died rc=%s; restarting "
                "(next backoff %.0fs)", i, p.returncode, self._backoff,
            )
            self._next_restart = now + self._backoff
            self.procs[i] = self._spawn(i)
            self._death_counted[i] = False

    def _harvest_flight(self, i: int, returncode) -> None:  # oryxlint: holds=_op_lock
        """Pack a dead replica's on-disk flight ring into one harvest
        artifact (common/flightrec.py) and record the death in the
        supervisor's OWN flight ring — the corpse's last lifecycle events
        survive the restart that is about to recycle its identity."""
        rid = str(self.overlays[i]["oryx.fleet.replica.id"])
        flight_dir = self.overlays[i].get("oryx.monitoring.flight.dir")
        path = None
        try:
            from oryx_tpu_torch.common import flightrec

            if flight_dir:
                path = flightrec.harvest(
                    str(flight_dir), replica=rid, returncode=returncode,
                )
            flightrec.get_flightrec().record(
                kind="replica-death", replica=rid,
                returncode=returncode, harvest=path or "",
            )
        except Exception:  # noqa: BLE001 - the black box never kills poll()
            log.exception("flight harvest for replica %s failed", rid)
        if path:
            self.harvested.append(path)
            log.warning(
                "fleet supervisor: harvested flight artifact %s from dead "
                "replica %s (rc=%s)", path, rid, returncode,
            )

    def request_stop(self) -> None:
        """Signal-handler-safe stop request: run() exits on the next
        tick; the caller then does the blocking stop()."""
        self._stopping.set()

    def run(self) -> int:
        """Supervise until stop(); returns 1 if the fleet crash-looped."""
        while not self._stopping.is_set():
            self.poll()
            if self.crash_looping:
                return 1
            self._stopping.wait(1.0)
        return 0

    # -- elastic capacity (fleet/control.py autoscaler) ----------------------

    def scale_up(self) -> tuple[str, int]:
        """Add one replica: refill the lowest scaled-down slot if one
        exists (ports stay dense), else grow the overlay table by one.
        Returns (replica id, port) for the front's add_replica."""
        with self._op_lock:
            if self._stopping.is_set():
                raise RuntimeError("fleet supervisor is stopping")
            if self._scaled_down:
                idx = min(self._scaled_down)
                self._scaled_down.discard(idx)
            else:
                idx = len(self.overlays)
                self.overlays.append(
                    replica_overlays(
                        self.config, n=idx + 1,
                        base_port=self._base_port_arg,
                        shards=self._shards_arg,
                    )[-1]
                )
                self.procs.append(None)
                self._spawned_at.append(0.0)
                self._death_counted.append(False)
                if self.exec_prefixes is not None:
                    # no affinity plan exists for an elastic replica;
                    # run it unpinned rather than doubling up on a core
                    self.exec_prefixes.append([])
            self._death_counted[idx] = False
            self.procs[idx] = self._spawn(idx)
            o = self.overlays[idx]
            return (
                str(o["oryx.fleet.replica.id"]),
                int(o["oryx.serving.api.port"]),
            )

    def stop_replica(self, replica_id: str, timeout: float = 15.0) -> bool:
        """Gracefully stop ONE replica on purpose (scale-down, after the
        front drained it): poll() never restarts the emptied slot, and
        scale_up() refills it first."""
        with self._op_lock:
            idx = next(
                (
                    j for j, o in enumerate(self.overlays)
                    if str(o["oryx.fleet.replica.id"]) == replica_id
                ),
                None,
            )
            if idx is None:
                return False
            p = self.procs[idx]
            self.procs[idx] = None
            self._death_counted[idx] = False
            self._scaled_down.add(idx)
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
        return True

    # -- chaos / teardown --------------------------------------------------

    def kill(self, i: int, sig: int = signal.SIGKILL) -> None:
        """Kill one replica (the chaos hook: ``fleet-kill`` sends SIGKILL
        mid update-storm). The next poll() restarts it unless restarts
        are off or stop() was called."""
        with self._op_lock:
            p = self.procs[i]
        if p is not None and p.poll() is None:
            p.send_signal(sig)

    def stop(self, timeout: float = 15.0) -> None:
        self._stopping.set()
        # _stopping is set, so no further poll() can spawn; snapshot the
        # final process table under the lock, then wait outside it
        with self._op_lock:
            procs = list(self.procs)
        for p in procs:
            if p is not None and p.poll() is None:
                p.terminate()
        for p in procs:
            if p is None:
                continue
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass

    def __enter__(self) -> "FleetSupervisor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
