"""Fleet controller: the closed loop over supervisor + front (the port's
copy of oryx_tpu/fleet/control.py).

The pieces below it are deliberately dumb: the model gate
(``common/modelgate.py``) holds or adopts generations per replica, the
front (``fleet/front.py``) splits a stable traffic cohort and
drains/joins replicas, the supervisor (``fleet/supervisor.py``) spawns
and stops processes. This module is the policy that composes them into
a staged rollout and self-healing capacity:

Canary rollout (``oryx.fleet.canary.*``)
  1. **Arm**: every hold-mode replica's gate starts unarmed (watermark
     ``None`` — bootstrap safety). The controller pins each watermark to
     the replica's CURRENT generation via ``POST /control/model/approve``,
     so the next published generation parks fleet-wide except on the
     canary replica, whose gate adopts immediately.
  2. **Start**: when the canary's adopted generation pulls ahead of the
     incumbent, the front splits ``traffic-fraction`` of the placement
     keys to it (stable hash cohort — sessions stick to one generation)
     and a ``canary-start`` flight event opens the story.
  3. **Judge**: promotion is gated on the canary's quality-SLO fast
     burn, its serving-latency fast burn, and its live recall vs the
     incumbent fleet's — all only after ``min-samples`` shadow-rescored
     samples landed on the new generation (the quality plane's
     generation-scoped windows mean those samples are the new
     generation's alone).
  4. **Promote**: approvals raise every hold replica's watermark; the
     held generation adopts fleet-wide, the split clears once the fleet
     reports the new generation, ``canary-promote`` closes the story.
  5. **Rollback**: a burn/recall breach, an ejected canary, or the
     fail-closed ``hold-timeout-sec`` instead re-pins the previous
     generation via ``POST /control/model/rollback`` — a pure pointer
     swap out of the artifact relay's pinned cache, zero re-download
     bytes — clears the split, and records ``canary-rollback`` with the
     evidence that forced it. The generation is vetoed: topic replay
     cannot re-adopt it.

Autoscaling (``oryx.fleet.autoscale.*``)
  Scale UP on availability fast-burn at the front or a shed storm
  (retries/sec over ``scale-up-shed-rate``); scale DOWN when mean
  dispatch-batch occupancy across the fleet stays under
  ``scale-down-occupancy`` for ``scale-down-after-sec``. Scale-down is
  graceful: the victim drains (no new requests, in-flight ones finish)
  before its process stops and its ring keys remap — and only its keys
  (``fleet/ring.py`` removes one node's points). Every decision records
  an ``autoscale`` flight event with the evidence that drove it.

The controller runs in the fleet front's process (``cli fleet`` wires
it between front start and the supervisor loop), so the front's SLO
trackers and metric registry are direct reads; replica state arrives
through the prober's /healthz parses on ``front.replicas``.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from oryx_tpu_torch.common import slo
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.flightrec import get_flightrec
from oryx_tpu_torch.common.metrics import get_registry

log = logging.getLogger(__name__)


def _mean(values: list[float]) -> float | None:
    return sum(values) / len(values) if values else None


class _Rollout:
    """One in-flight canary evaluation (created at canary-start,
    destroyed at promote/rollback)."""

    __slots__ = (
        "generation", "incumbent", "started", "baseline_samples",
        "promoting", "promote_evidence",
    )

    def __init__(self, generation, incumbent, baseline_samples):
        self.generation = generation
        self.incumbent = incumbent
        self.started = time.monotonic()
        self.baseline_samples = baseline_samples
        # promote decided; approvals re-sent each tick until every hold
        # replica's watermark caught up, then the split clears
        self.promoting = False
        self.promote_evidence: dict = {}


class FleetController:
    def __init__(self, config: Config, supervisor, front):
        self.config = config
        self.supervisor = supervisor
        self.front = front
        self.canary_enabled = config.get_bool("oryx.fleet.canary.enabled", False)
        self.canary_rid = config.get_string("oryx.fleet.canary.replica", "r0")
        self.traffic_fraction = config.get_float(
            "oryx.fleet.canary.traffic-fraction", 0.1
        )
        self.min_samples = config.get_int("oryx.fleet.canary.min-samples", 25)
        self.max_quality_burn = config.get_float(
            "oryx.fleet.canary.max-quality-burn", 2.0
        )
        self.max_latency_burn = config.get_float(
            "oryx.fleet.canary.max-latency-burn", 6.0
        )
        self.recall_slack = config.get_float(
            "oryx.fleet.canary.recall-slack", 0.05
        )
        self.hold_timeout = config.get_float(
            "oryx.fleet.canary.hold-timeout-sec", 300.0
        )
        self.autoscale_enabled = config.get_bool(
            "oryx.fleet.autoscale.enabled", False
        )
        self.min_replicas = max(
            1, config.get_int("oryx.fleet.autoscale.min-replicas", 2)
        )
        self.max_replicas = config.get_int(
            "oryx.fleet.autoscale.max-replicas", 4
        )
        self.scale_up_burn = config.get_float(
            "oryx.fleet.autoscale.scale-up-burn", 6.0
        )
        self.scale_up_shed_rate = config.get_float(
            "oryx.fleet.autoscale.scale-up-shed-rate", 5.0
        )
        self.scale_down_occupancy = config.get_float(
            "oryx.fleet.autoscale.scale-down-occupancy", 0.15
        )
        self.scale_down_after = config.get_float(
            "oryx.fleet.autoscale.scale-down-after-sec", 120.0
        )
        self.cooldown = config.get_float(
            "oryx.fleet.autoscale.cooldown-sec", 60.0
        )
        self.drain_timeout = config.get_float(
            "oryx.fleet.autoscale.drain-timeout-sec", 30.0
        )
        self.tick_interval = config.get_float("oryx.fleet.control.tick-sec", 1.0)
        # a control POST waits as long as the front waits for any backend
        # exchange: an approve or rollback returns once the replica has
        # delivered the generation, which at 1M x 50 takes seconds (the
        # artifact read, the state, the device view), past the JAX
        # package's fixed 5 s
        self.post_timeout = config.get_float(
            "oryx.fleet.front.backend-timeout-sec", 60.0
        )
        self._rollout: _Rollout | None = None
        # generations this controller already rolled back: a canary gate
        # restart (fresh veto set) must not re-trigger the same rollout
        self._vetoed: set[int] = set()
        self._gave_up_seen: set[str] = set()
        # autoscaler state
        self._cooldown_until = 0.0
        self._low_occ_since: float | None = None
        self._draining: tuple[str, float] | None = None  # (rid, deadline)
        self._last_shed: tuple[float, float] | None = None  # (t, total)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        reg = get_registry()
        self._g_replicas = reg.gauge(
            "oryx_fleet_autoscale_replicas",
            "Live replicas the controller counts toward fleet capacity "
            "(draining and gave-up replicas excluded) — the autoscaler's "
            "current size, bounded by oryx.fleet.autoscale.min-replicas/"
            "max-replicas",
        )
        self._m_autoscale = reg.counter(
            "oryx_fleet_autoscale_events_total",
            "Autoscaling decisions the fleet controller executed, by "
            "direction (up = replica spawned and joined to routing, "
            "down = replica drained, stopped, and removed from the ring)",
            labeled=True,
        )
        self._m_canary = reg.counter(
            "oryx_fleet_canary_decisions_total",
            "Canary rollout decisions the fleet controller took, by "
            "outcome (start, promote, rollback)",
            labeled=True,
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="oryx-fleet-controller", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _loop(self) -> None:  # oryxlint: offloop (controller thread)
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - one bad tick never kills the loop
                log.exception("fleet controller tick failed")
            self._stop.wait(self.tick_interval)

    # -- one control pass (public so chaos/tests can drive it directly) ------

    def tick(self) -> None:
        self._mirror_gave_up()
        if self.canary_enabled:
            self._canary_tick()
        if self.autoscale_enabled:
            self._autoscale_tick()
        self._g_replicas.set(float(len(self._live_replicas())))

    def _live_replicas(self):
        return [
            r
            for r in self.front.replicas
            if r.state not in ("gave_up", "draining")
        ]

    def _mirror_gave_up(self) -> None:
        """Reflect the supervisor's crash-loop give-ups in the front's
        routing table (/fleet/status shows state=gave_up
        instead of a probe-flapping hole)."""
        for rid in list(self.supervisor.gave_up):
            if rid not in self._gave_up_seen:
                self._gave_up_seen.add(rid)
                self.front.mark_gave_up(rid)

    # -- canary rollout -------------------------------------------------------

    def _canary_tick(self) -> None:
        canary = next(
            (r for r in self.front.replicas if r.id == self.canary_rid), None
        )
        if canary is None:
            return
        holds = [
            r
            for r in self.front.replicas
            if r.id != self.canary_rid
            and isinstance(r.model_gate, dict)
            and r.model_gate.get("mode") == "hold"
        ]
        self._arm_holds(holds)
        if self._rollout is None:
            self._maybe_start(canary, holds)
            return
        if self._rollout.promoting:
            self._finish_promotion(canary, holds)
            return
        self._judge(canary, holds)

    def _arm_holds(self, holds) -> None:
        """Pin every UNARMED hold gate's watermark to the generation it
        already serves: from then on anything newer parks until this
        controller promotes it."""
        for r in holds:
            if r.model_gate.get("watermark") is None and r.generation:
                res = self._post(
                    r, "/control/model/approve", {"generation": r.generation}
                )
                if res is not None:
                    log.info(
                        "fleet controller: armed %s at generation %s",
                        r.id, r.generation,
                    )

    def _canary_generation(self, canary) -> int | None:
        mg = canary.model_gate if isinstance(canary.model_gate, dict) else {}
        gens = mg.get("generations") or []
        g = gens[-1] if gens else canary.generation
        return int(g) if isinstance(g, (int, float)) else None

    def _maybe_start(self, canary, holds) -> None:
        gen = self._canary_generation(canary)
        incumbents = [r.generation for r in holds if r.generation]
        incumbent = max(incumbents) if incumbents else None
        if (
            gen is None
            or incumbent is None
            or gen <= incumbent
            or gen in self._vetoed
        ):
            return
        baseline = 0
        if isinstance(canary.quality, dict) and isinstance(
            canary.quality.get("samples"), int
        ):
            baseline = canary.quality["samples"]
        self.front.set_canary(self.canary_rid, self.traffic_fraction)
        self._rollout = _Rollout(gen, incumbent, baseline)
        self._m_canary.inc(outcome="start")
        get_flightrec().record(
            kind="canary-start",
            replica=self.canary_rid,
            generation=gen,
            incumbent=incumbent,
            fraction=self.traffic_fraction,
        )
        log.info(
            "fleet controller: canary rollout of generation %s started on "
            "%s (incumbent %s, %.0f%% of traffic)",
            gen, self.canary_rid, incumbent, self.traffic_fraction * 100,
        )

    def _judge(self, canary, holds) -> None:
        ro = self._rollout
        sb = canary.slo_burn if isinstance(canary.slo_burn, dict) else {}
        q_burn = (sb.get("quality") or {}).get("fast")
        l_burn = (sb.get("serving-latency") or {}).get("fast")
        samples = None
        recall = None
        if isinstance(canary.quality, dict):
            s = canary.quality.get("samples")
            if isinstance(s, int):
                samples = max(0, s - ro.baseline_samples)
            recall = canary.quality.get("live_recall_at_10")
        incumbent_recall = _mean(
            [
                r.quality["live_recall_at_10"]
                for r in holds
                if isinstance(r.quality, dict)
                and isinstance(r.quality.get("live_recall_at_10"), (int, float))
            ]
        )
        evidence = {
            "generation": ro.generation,
            "incumbent": ro.incumbent,
            "samples": samples,
            "quality_burn": q_burn,
            "latency_burn": l_burn,
            "canary_recall": recall,
            "incumbent_recall": incumbent_recall,
        }
        if not canary.routable:
            self._rollback(canary, "canary-ejected", evidence)
            return
        if samples is not None and samples >= self.min_samples:
            breaches = []
            if isinstance(q_burn, (int, float)) and q_burn > self.max_quality_burn:
                breaches.append(f"quality-burn {q_burn} > {self.max_quality_burn}")
            if isinstance(l_burn, (int, float)) and l_burn > self.max_latency_burn:
                breaches.append(f"latency-burn {l_burn} > {self.max_latency_burn}")
            if (
                isinstance(recall, (int, float))
                and incumbent_recall is not None
                and recall < incumbent_recall - self.recall_slack
            ):
                breaches.append(
                    f"recall {recall} < incumbent {round(incumbent_recall, 4)}"
                    f" - {self.recall_slack}"
                )
            if breaches:
                self._rollback(canary, "; ".join(breaches), evidence)
                return
            # every gate leg green over enough samples: promote
            ro.promoting = True
            ro.promote_evidence = evidence
            log.info(
                "fleet controller: promoting generation %s (%s)",
                ro.generation, evidence,
            )
            self._finish_promotion(canary, holds)
            return
        if time.monotonic() - ro.started > self.hold_timeout:
            # fail closed: a canary that cannot accumulate evidence
            # inside the window never promotes
            self._rollback(canary, "hold-timeout", evidence)
            return
        # insufficient evidence yet: say so (episode-limited) so the
        # flight ring shows the gate WAITING, not silent
        get_flightrec().record(
            kind="canary-hold",
            episode_s=30.0,
            replica=self.canary_rid,
            generation=ro.generation,
            samples=samples,
            min_samples=self.min_samples,
        )

    def _finish_promotion(self, canary, holds) -> None:
        """Re-send approvals until every hold replica's watermark covers
        the promoted generation, then clear the split and close the
        story. Idempotent per tick: an unreachable replica just gets the
        approval again next pass."""
        ro = self._rollout
        behind = []
        for r in holds:
            wm = r.model_gate.get("watermark")
            if not isinstance(wm, (int, float)) or wm < ro.generation:
                behind.append(r)
        for r in behind:
            self._post(
                r, "/control/model/approve", {"generation": ro.generation}
            )
        # the prober refreshes model_gate between ticks; once nothing is
        # behind, the fleet serves the promoted generation
        if behind:
            return
        self.front.clear_canary()
        self._m_canary.inc(outcome="promote")
        get_flightrec().record(
            kind="canary-promote",
            replica=self.canary_rid,
            **{k: v for k, v in ro.promote_evidence.items() if v is not None},
        )
        log.info(
            "fleet controller: generation %s promoted fleet-wide",
            ro.generation,
        )
        self._rollout = None

    def _rollback(self, canary, reason: str, evidence: dict) -> None:
        ro = self._rollout
        res = self._post(canary, "/control/model/rollback", {"reason": reason})
        if res is None:
            # the pointer swap did not happen (gate has no prior adoption
            # in history, or the replica is unreachable): the canary is
            # still serving the vetoed generation, so clearing the split
            # would hash real users back onto it. A zero-fraction split
            # quarantines it — no cohort routes there, everyone else
            # avoids it — until the next rollout's verdict replaces the
            # split or a promote clears it.
            self.front.set_canary(self.canary_rid, 0.0)
        else:
            self.front.clear_canary()
        self._vetoed.add(ro.generation)
        self._m_canary.inc(outcome="rollback")
        get_flightrec().record(
            kind="canary-rollback",
            replica=self.canary_rid,
            reason=reason,
            rolled_back_to=(res or {}).get("rolled_back_to"),
            quarantined=res is None,
            **{k: v for k, v in evidence.items() if v is not None},
        )
        if res is None:
            log.warning(
                "fleet controller: rollback of generation %s on %s FAILED "
                "(%s); replica quarantined at zero traffic",
                ro.generation, self.canary_rid, reason,
            )
        else:
            log.warning(
                "fleet controller: rolled back generation %s on %s: %s",
                ro.generation, self.canary_rid, reason,
            )
        self._rollout = None

    # -- autoscaling -----------------------------------------------------------

    def _autoscale_tick(self) -> None:
        now = time.monotonic()
        if self._draining is not None:
            self._finish_drain(now)
            return
        if now < self._cooldown_until:
            return
        live = self._live_replicas()
        up_reason = self._up_signal(now)
        if up_reason is not None and len(live) < self.max_replicas:
            self._scale_up(up_reason)
            return
        self._maybe_scale_down(now, live)

    def _up_signal(self, now: float) -> str | None:
        """Scale-up wants FAST signals: the front's own availability
        burn (requests the client already lost) and the shed rate (work
        the fleet is actively refusing)."""
        burn = slo.current_burn("front-availability")
        if burn is not None and burn > self.scale_up_burn:
            return f"front-availability fast burn {round(burn, 2)} > {self.scale_up_burn}"
        shed = 0.0
        try:
            c = get_registry().counter("oryx_fleet_front_retries_total")
            shed = sum(
                v for k, v in c.series().items() if dict(k).get("reason") == "shed"
            )
        except Exception:  # noqa: BLE001 - registry families vary in tests
            return None
        last = self._last_shed
        self._last_shed = (now, shed)
        if last is None or now <= last[0]:
            return None
        rate = (shed - last[1]) / (now - last[0])
        if rate > self.scale_up_shed_rate:
            return f"shed rate {round(rate, 1)}/s > {self.scale_up_shed_rate}/s"
        return None

    def _scale_up(self, reason: str) -> None:
        rid, port = self.supervisor.scale_up()
        self.front.add_replica(rid, "127.0.0.1", port)
        self._cooldown_until = time.monotonic() + self.cooldown
        self._m_autoscale.inc(direction="up")
        get_flightrec().record(
            kind="autoscale", direction="up", replica=rid, port=port,
            reason=reason, replicas=len(self._live_replicas()),
        )
        log.warning("fleet controller: scaled up (%s): spawned %s", reason, rid)

    def _maybe_scale_down(self, now: float, live) -> None:
        occs = [
            float(r.occupancy["mean"])
            for r in live
            if r.routable
            and isinstance(r.occupancy, dict)
            and isinstance(r.occupancy.get("mean"), (int, float))
        ]
        occ = _mean(occs)
        if occ is None or occ >= self.scale_down_occupancy:
            self._low_occ_since = None
            return
        if self._low_occ_since is None:
            self._low_occ_since = now
            return
        if now - self._low_occ_since < self.scale_down_after:
            return
        if len(live) <= self.min_replicas:
            return
        victim = self._pick_victim(live)
        if victim is None:
            return
        self.front.begin_drain(victim.id)
        self._draining = (victim.id, now + self.drain_timeout)
        self._low_occ_since = None
        get_flightrec().record(
            kind="autoscale", direction="down", replica=victim.id,
            phase="drain", occupancy=round(occ, 4),
            threshold=self.scale_down_occupancy,
            replicas=len(live),
        )
        log.warning(
            "fleet controller: scaling down %s (mean occupancy %.3f < %.3f "
            "for %.0fs); draining",
            victim.id, occ, self.scale_down_occupancy, self.scale_down_after,
        )

    def _pick_victim(self, live):
        """Highest-index routable replica that is not the canary: the
        supervisor refills the highest slots first, and the canary
        replica's gate history is the fleet's rollback path."""
        for r in reversed(live):
            if r.routable and r.id != self.canary_rid:
                return r
        return None

    def _finish_drain(self, now: float) -> None:
        rid, deadline = self._draining
        inflight = self.front.inflight(rid)
        if inflight > 0 and now < deadline:
            return  # in-flight requests get their answers first
        self.supervisor.stop_replica(rid)
        self.front.remove_replica(rid)
        self._draining = None
        self._cooldown_until = now + self.cooldown
        self._m_autoscale.inc(direction="down")
        get_flightrec().record(
            kind="autoscale", direction="down", replica=rid, phase="stopped",
            forced=inflight > 0, replicas=len(self._live_replicas()),
        )
        log.warning(
            "fleet controller: scale-down of %s complete (%s)",
            rid, "drain deadline forced" if inflight > 0 else "drained clean",
        )

    # -- replica control endpoint ---------------------------------------------

    # blocking http.client is legal here: the controller is a dedicated
    # thread, never one of the front's event loops
    def _post(self, r, path: str, body: dict) -> dict | None:  # oryxlint: offloop (controller thread)
        import http.client

        try:
            conn = http.client.HTTPConnection(
                r.host, r.port, timeout=self.post_timeout
            )
            try:
                conn.request(
                    "POST", path, json.dumps(body),
                    {"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read().decode("utf-8", "replace")
                if resp.status != 200:
                    log.warning(
                        "fleet controller: POST %s to %s -> %d %s",
                        path, r.id, resp.status, data[:200],
                    )
                    return None
                return json.loads(data)
            finally:
                conn.close()
        except Exception:  # noqa: BLE001 - replica may be mid-restart
            log.warning(
                "fleet controller: POST %s to %s failed", path, r.id,
                exc_info=True,
            )
            return None
