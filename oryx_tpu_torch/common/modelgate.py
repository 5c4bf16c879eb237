"""Model gate: staged adoption of published generations on one replica (the
port's copy of oryx_tpu/common/modelgate.py).

The update topic broadcasts every generation to every replica (the
lambda contract — replicas are stateless consumers), which is exactly
wrong during a canary rollout: the point of a canary is that a NEW
generation serves on one replica while the rest of the fleet keeps the
incumbent until the gate promotes it. This module is the per-process
half of that control loop (the fleet half is ``fleet/control.py``,
which drives ``POST /control/model/approve|rollback``, as an operator
may): it
sits inside ``api._dispatch_update`` — the one choke point every
MODEL/MODEL-REF/TRACE message already flows through — and decides, per
generation, whether this replica adopts it now, holds it, or rolls it
back.

Modes (``oryx.serving.model-gate.mode``):

- ``off`` (default): zero behavior change; the gate is never consulted.
- ``canary``: every stamped generation is adopted immediately (this IS
  the canary replica), but the gate keeps an adoption history of
  (model message, publish stamp) pairs so a regressing generation can
  be rolled back to its predecessor as a pure pointer swap — a
  MODEL-REF re-dispatch resolves from the artifact relay cache
  (``common/artifact.py``), re-downloading nothing, and the relay PINS
  the history's refs so the rollback target cannot be LRU-evicted
  between adoption and the rollback that needs it.
- ``hold``: a generation newer than the approved watermark is parked —
  model message and stamp buffered, nothing loaded — until
  ``approve()`` raises the watermark (the fleet controller promotes a
  canary-validated generation) or a newer generation supersedes it
  (latest-wins, like live serving). An UNARMED hold gate
  (watermark ``None``) adopts everything: a restarting replica replays
  the topic from earliest and must not hold its bootstrap model
  hostage to a controller that has not probed it yet.

A gate can start from what its fleet already decided:
``oryx.serving.model-gate.watermark`` arms it at the promoted
generation and ``oryx.serving.model-gate.vetoed`` lists generations it
must never adopt. The fleet supervisor passes both to a replica it
restarts (``fleet/control.py`` ``gate_overlay``), so a replica that died
after a rollback replays the topic and serves the promoted generation,
never the vetoed one. (The JAX package's gate starts empty.)

Because a generation id travels on the TRACE stamp that FOLLOWS its
model on the (single-partition) update topic, the gate buffers each
MODEL/MODEL-REF until its stamp arrives and judges the pair — one
message of added latency, invisible next to model-load time.

Adoption order through the normal machinery is preserved exactly: the
model dispatches through ``api._dispatch_model`` (same retries, same
parking, same freshness hooks) and the stamp then feeds
``freshness.note_stamp`` — so generation gauges, quality-window resets
(a rollback does not inherit the bad generation's shadow samples), and
``generation`` flight events all fire as if the gate were not there.

An approve or rollback delivers a model under the gate's lock, and the
ALS manager then builds its device view (about a second at 1M x 50). So
``healthz_section`` reads a snapshot taken at the end of each change,
never the lock: ``/healthz`` runs on the async frontend's event loop and
must not wait for a delivery.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque

log = logging.getLogger(__name__)

_MODES = ("off", "hold", "canary")


class ModelGateError(Exception):
    """A gate control operation could not be performed (no history to
    roll back to, bad mode); maps to an HTTP 409 at the control
    endpoint."""


class _Adoption:
    """One adopted (or held) generation: everything needed to re-apply
    it later."""

    __slots__ = ("generation", "key", "message", "stamp", "handler")

    def __init__(self, generation, key, message, stamp, handler):
        self.generation = generation
        self.key = key
        self.message = message
        self.stamp = stamp
        self.handler = handler


def _stamp_generation(stamp_message: str) -> int | None:
    try:
        gen = json.loads(stamp_message).get("generation")
    except (json.JSONDecodeError, AttributeError):
        return None
    return int(gen) if isinstance(gen, (int, float)) else None


class ModelGate:
    """Per-process staged-adoption state; all mutation under one RLock
    (the update-listener thread and the /control/model/* endpoint
    threads both drive it)."""

    def __init__(self):
        self.mode = "off"
        self.history_depth = 4
        self._lock = threading.RLock()
        # MODEL/MODEL-REF seen, its TRACE stamp not yet (key, msg, handler)
        self._awaiting: tuple[str, str, object] | None = None  # guarded-by: _lock
        # held generation awaiting approval (hold mode, latest wins)
        self._pending: _Adoption | None = None  # guarded-by: _lock
        # newest approved generation; None = unarmed (adopt everything)
        self.watermark: int | None = None  # guarded-by: _lock
        # adopted generations, oldest first, newest = currently served
        self._history: deque[_Adoption] = deque()  # guarded-by: _lock
        # generations rolled back out of service: never re-adopted
        self._vetoed: set[int] = set()  # guarded-by: _lock
        # healthz_section's copy of the state, replaced after each change
        self._section: dict = {}  # guarded-by: _lock (writes)
        self._snapshot_locked()

    @property
    def active(self) -> bool:
        return self.mode != "off"

    def configure(self, config) -> None:
        mode = config.get_string("oryx.serving.model-gate.mode", "off")
        if mode not in _MODES:
            raise ValueError(
                f"oryx.serving.model-gate.mode must be one of {_MODES}, "
                f"got {mode!r}"
            )
        self.mode = mode
        self.history_depth = max(
            2, config.get_int("oryx.serving.model-gate.history", 4)
        )
        # what the fleet already decided, seeded before the update
        # listener replays the topic: a replica restarted after a rollback
        # must not re-adopt the vetoed generation, and its hold gate starts
        # armed at the promoted generation instead of adopting everything
        watermark = config.get("oryx.serving.model-gate.watermark", None)
        vetoed = config.get_list("oryx.serving.model-gate.vetoed", [])
        with self._lock:
            if self.active:
                if watermark is not None:
                    self.watermark = int(watermark)
                self._vetoed.update(int(g) for g in vetoed)
            self._snapshot_locked()

    # -- update-listener hook (api._dispatch_update) ------------------------

    def offer(self, handler, km) -> bool:
        """Consult the gate for one MODEL/MODEL-REF/TRACE message.
        Returns True when the gate consumed it (buffered, held, or
        adopted through its own delivery); False passes the message to
        the normal dispatch path untouched."""
        with self._lock:
            try:
                return self._offer_locked(handler, km)
            finally:
                self._snapshot_locked()

    def _offer_locked(self, handler, km) -> bool:  # oryxlint: holds=_lock
        if km.key in ("MODEL", "MODEL-REF"):
            prev = self._awaiting
            if prev is not None:
                # back-to-back models with no stamp between: abnormal
                # (every publish is MODEL then TRACE). The canary
                # adopts the orphan like the ungated path would; a
                # hold replica fails closed and drops it — an
                # unstamped model has no generation to judge.
                if self.mode == "canary":
                    log.warning(
                        "model gate: unstamped %s superseded; adopting "
                        "without a stamp", prev[0],
                    )
                    self._adopt_locked(
                        _Adoption(None, prev[0], prev[1], None, prev[2])
                    )
                else:
                    log.warning(
                        "model gate: dropping unstamped %s (hold mode "
                        "fails closed)", prev[0],
                    )
            self._awaiting = (km.key, km.message, handler)
            return True
        if km.key != "TRACE":
            return False
        aw = self._awaiting
        if aw is None:
            # stray stamp (its model never reached us, or load was
            # parked before the gate armed): normal path handles it
            return False
        gen = _stamp_generation(km.message)
        if gen is None and _bad_stamp(km.message):
            # unparseable stamp: adopt the model the way the ungated
            # path would (model loads at arrival, stamp ignored),
            # then let the normal TRACE branch log the bad stamp
            self._awaiting = None
            self._adopt_locked(
                _Adoption(None, aw[0], aw[1], None, aw[2])
            )
            return False
        self._awaiting = None
        entry = _Adoption(gen, aw[0], aw[1], km.message, aw[2])
        if gen is not None and gen in self._vetoed:
            log.warning(
                "model gate: generation %s was rolled back out of "
                "service; refusing re-adoption", gen,
            )
            return True
        if (
            self.mode == "hold"
            and self.watermark is not None
            and gen is not None
            and gen > self.watermark
        ):
            if self._pending is not None:
                log.info(
                    "model gate: held generation %s superseded by %s",
                    self._pending.generation, gen,
                )
            self._pending = entry
            log.info(
                "model gate: holding generation %s (watermark %s)",
                gen, self.watermark,
            )
            return True
        self._adopt_locked(entry)
        return True

    # -- control surface (POST /control/model/*) ----------------------------

    def approve(self, generation: int) -> dict:
        """Raise the approved watermark; a held generation at/under it is
        adopted immediately. The fleet controller calls this to ARM a
        hold replica (watermark = incumbent generation) and again to
        PROMOTE a canary-validated one."""
        with self._lock:
            try:
                return self._approve_locked(generation)
            finally:
                self._snapshot_locked()

    def _approve_locked(self, generation: int) -> dict:  # oryxlint: holds=_lock
        if not self.active:
            raise ModelGateError("model gate is off")
        self.watermark = int(generation)
        adopted = False
        if (
            self._pending is not None
            and self._pending.generation is not None
            and self._pending.generation <= self.watermark
        ):
            entry = self._pending
            self._pending = None
            self._adopt_locked(entry)
            adopted = True
        return {
            "watermark": self.watermark,
            "adopted": adopted,
            "generation": self._current_generation_locked(),
        }

    def rollback(self, reason: str | None = None) -> dict:
        """Re-apply the PREVIOUS adopted generation: a pure pointer swap
        — the model message re-dispatches through the normal load path,
        and a MODEL-REF resolves from the (pinned) relay cache without
        re-downloading a byte. The rolled-back generation is vetoed:
        a topic replay cannot re-adopt it."""
        with self._lock:
            try:
                return self._rollback_locked(reason)
            finally:
                self._snapshot_locked()

    def _rollback_locked(self, reason: str | None = None) -> dict:  # oryxlint: holds=_lock
        if not self.active:
            raise ModelGateError("model gate is off")
        if len(self._history) < 2:
            raise ModelGateError(
                "no previous generation in the gate's history to roll "
                "back to"
            )
        bad = self._history.pop()
        if bad.generation is not None:
            self._vetoed.add(bad.generation)
        prev = self._history[-1]
        # the watermark must drop with the pointer, or a hold gate
        # would immediately re-approve the vetoed generation's peers
        if (
            self.watermark is not None
            and prev.generation is not None
            and self.watermark > prev.generation
        ):
            self.watermark = prev.generation
        log.warning(
            "model gate: rolling back generation %s -> %s (%s)",
            bad.generation, prev.generation, reason or "operator request",
        )
        self._deliver_locked(prev)
        self._unpin_locked(bad)
        return {
            "rolled_back_to": prev.generation,
            "vetoed": bad.generation,
            "reason": reason,
        }

    def healthz_section(self) -> dict:
        """The /healthz ``model_gate`` block, from which a controller or an
        operator reads canary/hold progress: the snapshot of the last
        completed change (see the module docstring)."""
        return dict(self._section)

    def _snapshot_locked(self) -> None:  # oryxlint: holds=_lock
        self._section = {
            "mode": self.mode,
            "watermark": self.watermark,
            "pending_generation": (
                self._pending.generation
                if self._pending is not None else None
            ),
            "generations": [
                a.generation for a in self._history
            ],
            "vetoed": sorted(self._vetoed),
        }

    # -- internals -----------------------------------------------------------

    def _current_generation_locked(self):  # oryxlint: holds=_lock
        return self._history[-1].generation if self._history else None

    def _adopt_locked(self, entry: _Adoption) -> None:  # oryxlint: holds=_lock
        self._deliver_locked(entry)
        self._history.append(entry)
        self._pin_locked(entry)
        while len(self._history) > self.history_depth:
            self._unpin_locked(self._history.popleft())

    def _deliver_locked(self, entry: _Adoption) -> None:  # oryxlint: holds=_lock
        """Dispatch one adoption through the NORMAL model-load machinery:
        same retries, same parking, same freshness hooks — then feed its
        stamp so generation state, quality-window resets, and the
        ``generation`` flight event fire exactly as ungated."""
        from oryx_tpu_torch.api import _dispatch_model
        from oryx_tpu_torch.bus.api import KeyMessage

        _dispatch_model(entry.handler, KeyMessage(entry.key, entry.message))
        if entry.stamp is None:
            return
        try:
            from oryx_tpu_torch.common.freshness import model_freshness

            model_freshness().note_stamp(entry.stamp)
        except Exception:  # noqa: BLE001 - a bad stamp never kills adoption
            log.exception("model gate: stamp re-feed failed")

    def _pin_locked(self, entry: _Adoption) -> None:  # oryxlint: holds=_lock
        if entry.key != "MODEL-REF":
            return
        try:
            from oryx_tpu_torch.common.artifact import artifact_relay

            artifact_relay().pin(entry.message)
        except Exception:  # noqa: BLE001 - pinning is best-effort protection
            log.exception("model gate: pin failed")

    def _unpin_locked(self, entry: _Adoption) -> None:  # oryxlint: holds=_lock
        if entry.key != "MODEL-REF":
            return
        if any(
            a.key == "MODEL-REF" and a.message == entry.message
            for a in self._history
        ):
            return  # another history entry still needs this artifact
        try:
            from oryx_tpu_torch.common.artifact import artifact_relay

            artifact_relay().unpin(entry.message)
        except Exception:  # noqa: BLE001
            log.exception("model gate: unpin failed")


def _bad_stamp(message: str) -> bool:
    try:
        doc = json.loads(message)
    except json.JSONDecodeError:
        return True
    return not isinstance(doc, dict) or not isinstance(
        doc.get("published_ms"), (int, float)
    )


_instance: ModelGate | None = None
_instance_lock = threading.Lock()


def get_model_gate() -> ModelGate:
    global _instance
    with _instance_lock:
        if _instance is None:
            _instance = ModelGate()
        return _instance


def configure_model_gate(config) -> ModelGate:
    gate = get_model_gate()
    gate.configure(config)
    return gate
