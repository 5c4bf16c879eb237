"""Serving-side SPI: the interfaces a serving application implements (the
port's copy of the serving half of oryx_tpu/api.py).

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
from typing import Iterator

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.config import Config

_log = logging.getLogger(__name__)


def _note_model_freshness(key: str | None, loaded: bool) -> None:
    """Feed the model-freshness tracker (common/freshness.py) after a
    MODEL/MODEL-REF dispatch — no-op for other keys, and NEVER lets its
    own failure escape into the update-listener thread."""
    if key not in ("MODEL", "MODEL-REF"):
        return
    try:
        from oryx_tpu_torch.common.freshness import model_freshness

        if loaded:
            model_freshness().note_loaded()
        else:
            # the model did NOT load: its stamp must not claim an earlier
            # successful load
            model_freshness().note_load_failed()
    except Exception:  # pragma: no cover - defensive
        _log.exception("model freshness hook failed")


def _dispatch_update(handler, km: KeyMessage) -> None:
    """Per-message dispatch with error isolation: a poison message must not
    kill the listener (it would replay the same message forever and freeze
    the model). MODEL/MODEL-REF I/O failures may be transient, so OSError
    retries briefly; parse/validation errors are logged and skipped.

    ``TRACE`` publish stamps (common/freshness.py) feed the freshness
    metrics and never reach the handler. The JAX package's MODEL-CHUNK
    relay and model gate are not ported yet (ROADMAP queue 1)."""
    if km.key == "TRACE":
        from oryx_tpu_torch.common.freshness import model_freshness

        try:
            model_freshness().note_stamp(km.message)
        except Exception:
            _log.exception("ignoring bad TRACE publish stamp")
        return
    retries = 3 if km.key in ("MODEL", "MODEL-REF") else 0
    for attempt in range(retries + 1):
        try:
            handler(km.key, km.message)
            _note_model_freshness(km.key, loaded=True)
            return
        except OSError:
            if attempt < retries:
                _log.warning(
                    "model load I/O failure (attempt %d/%d); retrying",
                    attempt + 1, retries,
                )
                time.sleep(0.2 * (attempt + 1))
            else:
                _log.exception("giving up on update message (key=%r)", km.key)
        except Exception:
            _log.exception("ignoring bad update message (key=%r)", km.key)
            break
    _note_model_freshness(km.key, loaded=False)


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
