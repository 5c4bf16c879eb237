"""User-facing SPI — the three interfaces an application implements (the
port's copy of oryx_tpu/api.py).

  - BatchLayerUpdate.run_update: invoked once per batch generation with the
    new-data window, all past data, the model dir, and an update-topic
    producer (reference .../api/batch/BatchLayerUpdate.java)
  - SpeedModelManager: consume() runs forever on the update-topic listener
    thread; build_updates() turns each micro-batch into update messages
    (reference .../api/speed/SpeedModelManager.java)
  - ServingModelManager / ServingModel: consume() reads the update topic;
    get_model() is read by the request resources; fraction_loaded gates
    readiness (reference .../api/serving/ServingModelManager.java,
    ServingModel.java)

Data items are KeyMessage(key, message) pairs (bus/api.py).
"""

from __future__ import annotations

import logging
import time
from abc import ABC, abstractmethod
from typing import Iterable, Iterator, Sequence

from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer
from oryx_tpu_torch.common.config import Config

_log = logging.getLogger(__name__)


def _note_model_freshness(
    key: str | None,
    loaded: bool,
    parked: bool = False,
    message: str | None = None,
) -> None:
    """Feed the model-freshness tracker (common/freshness.py) after a
    MODEL/MODEL-REF dispatch — no-op for other keys, and NEVER lets its
    own failure (e.g. a metric registration collision at tracker
    construction) escape into the update-listener thread, which must
    survive anything per _dispatch_update's isolation contract. `parked`
    marks a MODEL-REF awaiting a late artifact: its stamp is held for the
    re-dispatched load instead of dropped."""
    if key not in ("MODEL", "MODEL-REF"):
        return
    try:
        from oryx_tpu_torch.common.freshness import model_freshness

        if loaded:
            model_freshness().note_loaded(key, message=message)
        else:
            # the model did NOT load: its stamp must not claim an earlier
            # successful load (but a parked one may be claimed later)
            model_freshness().note_load_failed(parked=parked, message=message)
    except Exception:  # pragma: no cover - defensive
        _log.exception("model freshness hook failed")


def _dispatch_update(handler, km: KeyMessage) -> None:
    """Per-message dispatch with error isolation: a poison message must not
    kill the listener thread (it replays from earliest on restart and would
    hit the same message forever, freezing the model). MODEL/MODEL-REF I/O
    failures may be transient (MODEL-REF points at shared storage that can
    lag the publish), so only OSError retries — briefly, because replay
    also walks MODEL-REFs whose artifacts were TTL-pruned long ago, and
    every sleep here multiplies across that history. Parse/validation
    errors are deterministic and never retried."""
    if km.key == "MODEL-CHUNK":
        # framework-level artifact transfer (common/artifact.py
        # ArtifactRelay): assembled here so every app manager can resolve
        # a MODEL-REF without a shared filesystem; app handlers never see
        # the chunks
        from oryx_tpu_torch.common.artifact import artifact_relay

        try:
            artifact_relay().offer(km.message)
        except Exception:
            _log.exception("ignoring bad MODEL-CHUNK message")
        return
    if km.key in ("MODEL", "MODEL-REF", "TRACE"):
        # staged-adoption gate (common/modelgate.py): on a canary or
        # held replica the gate buffers each model until its stamp names
        # a generation, then adopts/holds/refuses it. Off (the default)
        # this is one attribute read; a consumed message is the gate's
        # to deliver later through _dispatch_model below.
        from oryx_tpu_torch.common.modelgate import get_model_gate

        gate = get_model_gate()
        if gate.active:
            try:
                if gate.offer(handler, km):
                    return
            except Exception:  # pragma: no cover - defensive
                _log.exception("model gate failed; dispatching ungated")
    if km.key == "TRACE":
        # framework-level publish stamp (common/freshness.py): follows its
        # MODEL/MODEL-REF on the update topic and feeds the
        # oryx_update_to_serve_seconds / oryx_model_staleness_seconds
        # metrics; app handlers never see it
        from oryx_tpu_torch.common.freshness import model_freshness

        try:
            model_freshness().note_stamp(km.message)
        except Exception:
            _log.exception("ignoring bad TRACE publish stamp")
        return
    _dispatch_model(handler, km)


def _dispatch_model(handler, km: KeyMessage) -> None:
    """The retry/park/freshness leg of _dispatch_update, factored out so
    the model gate can deliver an adopted generation through the exact
    same machinery (and a parked MODEL-REF's late re-dispatch re-enters
    HERE, below the gate — the gate already decided to adopt it)."""
    retries = 3 if km.key in ("MODEL", "MODEL-REF") else 0
    for attempt in range(retries + 1):
        try:
            handler(km.key, km.message)
            _note_model_freshness(km.key, loaded=True, message=km.message)
            return
        except OSError:
            if attempt < retries:
                _log.warning(
                    "model load I/O failure (attempt %d/%d); retrying",
                    attempt + 1, retries,
                )
                time.sleep(0.2 * (attempt + 1))
            else:
                parked = False
                if km.key == "MODEL-REF":
                    # park ONLY when the artifact itself is unresolvable
                    # (chunk stream in flight, sha-mismatch republish) —
                    # a handler failing for its own reasons with a
                    # resolvable artifact must not re-fire immediately
                    # and loop (park re-checks resolvability on entry)
                    from oryx_tpu_torch.common.artifact import artifact_relay

                    relay = artifact_relay()
                    try:
                        relay.resolve(km.message)
                    except OSError:
                        _log.warning(
                            "MODEL-REF %r unresolved after retries; parked "
                            "for re-dispatch on late artifact arrival",
                            km.message,
                        )
                        relay.park(
                            km.message, lambda: _dispatch_model(handler, km)
                        )
                        parked = True
                if not parked:
                    _log.exception(
                        "giving up on update message (key=%r)", km.key
                    )
                _note_model_freshness(
                    km.key, loaded=False, parked=parked, message=km.message,
                )
        except Exception:
            _note_model_freshness(km.key, loaded=False, message=km.message)
            _log.exception("ignoring bad update message (key=%r)", km.key)
            return


class BatchLayerUpdate(ABC):
    """Implemented by the batch tier of an app; config-named via
    oryx.batch.update-class."""

    @abstractmethod
    def run_update(
        self,
        timestamp_ms: int,
        new_data: Sequence[KeyMessage],
        past_data: Sequence[KeyMessage],
        model_dir: str,
        update_producer: TopicProducer,
    ) -> None: ...

    def finalize_generation(self, timestamp_ms: int) -> None:
        """Called by the batch layer AFTER the generation's window is
        persisted and its offsets committed. Updates that stage durable
        state during run_update (e.g. the incremental aggregate snapshot)
        promote it here — state made durable any earlier would double-fold
        the window if a crash in between re-delivered it."""

    def validate_record(self, km: KeyMessage) -> bool:
        """Cheap deserialize check, called once per record per generation
        BEFORE the window persists. Return False for a record that can
        never parse: the layer diverts it to the dead-letter store
        (common/quarantine.py) instead of letting it poison persisted
        history, where every later from-scratch rebuild would re-read it
        forever. Apps override with a parse-only check; the default
        accepts everything (the layer skips the sweep entirely when
        neither this nor validate_records is overridden)."""
        return True

    def validate_records(self, records: Sequence[KeyMessage]) -> Sequence[bool]:
        """Batch form of validate_record — override when a whole-window
        check is cheaper than per-record Python calls (the ALS apps run
        ONE native parse over the window and only Python-check the lines
        it flags). Default loops validate_record."""
        return [self.validate_record(km) for km in records]


class SpeedModelManager(ABC):
    """Implemented by the speed tier; config-named via
    oryx.speed.model-manager-class."""

    @abstractmethod
    def consume(self, updates: Iterator[KeyMessage]) -> None:
        """Read models/updates from the update topic forever."""

    @abstractmethod
    def build_updates(self, new_data: Sequence[KeyMessage]) -> Iterable[tuple[str, str]]:
        """Turn one micro-batch of input into (key, message) updates."""

    def validate_record(self, km: KeyMessage) -> bool:
        """Cheap deserialize check (see BatchLayerUpdate.validate_record):
        False diverts the record to the dead-letter store before
        build_updates ever sees it. Records that PARSE but break the
        fold-in are isolated separately by the speed layer's bisect pass
        after bounded window retries."""
        return True

    def validate_records(self, records: Sequence[KeyMessage]) -> Sequence[bool]:
        """Batch form of validate_record (see
        BatchLayerUpdate.validate_records). Default loops the per-record
        hook."""
        return [self.validate_record(km) for km in records]

    def close(self) -> None:
        pass


class AbstractSpeedModelManager(SpeedModelManager):
    """Dispatches consume() per message, the common pattern."""

    def consume(self, updates: Iterator[KeyMessage]) -> None:
        for km in updates:
            _dispatch_update(self.consume_key_message, km)

    @abstractmethod
    def consume_key_message(self, key: str | None, message: str) -> None: ...


class ServingModel(ABC):
    @abstractmethod
    def fraction_loaded(self) -> float:
        """1.0 when fully loaded; serving returns 503 below the configured
        min-model-load-fraction (reference ServingModel.getFractionLoaded)."""


class ServingModelManager(ABC):
    """Implemented by the serving tier; config-named via
    oryx.serving.model-manager-class."""

    def __init__(self, config: Config):
        self.config = config

    @abstractmethod
    def consume(self, updates: Iterator[KeyMessage]) -> None: ...

    @abstractmethod
    def get_model(self) -> ServingModel | None: ...

    def is_read_only(self) -> bool:
        return self.config.get_bool("oryx.serving.api.read-only", False)

    def close(self) -> None:
        pass


class AbstractServingModelManager(ServingModelManager):
    def consume(self, updates: Iterator[KeyMessage]) -> None:
        for km in updates:
            _dispatch_update(self.consume_key_message, km)

    @abstractmethod
    def consume_key_message(self, key: str | None, message: str) -> None: ...
