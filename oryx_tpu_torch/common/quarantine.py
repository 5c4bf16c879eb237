"""Poison-record quarantine: a replayable dead-letter store (the port's
copy of oryx_tpu/common/quarantine.py).

A record that deterministically breaks its consumer must not be allowed
to rewind-loop a tier forever (the failure mode
``oryx_speed_failures_total`` makes visible, and what tf.data's input
hardening solves for malformed records, arxiv 2101.12127). Once bounded
retries are exhausted, the layer diverts the offending records HERE —
append-only JSONL files under ``oryx.monitoring.quarantine.dir`` — and
moves the stream forward. Nothing is lost: every diverted record carries
its key, message, reason, and timestamp, and ``load_quarantined`` /
``tools/chaos.py replay-quarantine`` turn a dead-letter file back into
records that can be re-ingested (e.g. POSTed to /ingest) after the bug
that poisoned them is fixed.

Layout: ``<dir>/<layer>/dl-<epoch_ms>-<pid>.jsonl`` — one file per divert
so concurrent layers never interleave, written tmp-then-rename so a crash
mid-divert can never leave a half-readable dead letter.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Iterable, Sequence

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.ioutil import mkdirs, strip_scheme

log = logging.getLogger(__name__)

_m_quarantined = None


def _metric():
    global _m_quarantined
    if _m_quarantined is None:
        from oryx_tpu_torch.common.metrics import get_registry

        _m_quarantined = get_registry().counter(
            "oryx_quarantined_records_total",
            "Records diverted to the dead-letter store by layer; replay "
            "them from oryx.monitoring.quarantine.dir once the poison "
            "cause is fixed",
            labeled=True,
        )
    return _m_quarantined


def ensure_metrics() -> None:
    """Register oryx_quarantined_records_total now (empty) so scrapes see
    the family from process start — a dead-letter alert needs the zero
    baseline, not a series that appears only after the first poison."""
    _metric()


class Quarantine:
    """Dead-letter writer for one layer ('speed', 'batch', ...)."""

    def __init__(self, root: str, layer: str):
        self.root = Path(strip_scheme(root))
        self.layer = layer
        self._seq = 0
        _metric()  # scrape-visible from layer construction, not first divert

    def divert(
        self, records: Sequence[KeyMessage], reason: str
    ) -> Path | None:
        """Persist the poison records and count them; returns the
        dead-letter path (None for an empty divert). Raises only on an
        unwritable quarantine dir — the caller decides whether losing the
        dead letter is worse than stalling (layers treat it as fatal for
        the window and keep rewinding: quarantine must never silently
        drop data)."""
        if not records:
            return None
        d = mkdirs(self.root / self.layer)
        now_ms = int(time.time() * 1000)
        self._seq += 1
        path = d / f"dl-{now_ms}-{os.getpid()}-{self._seq}.jsonl"
        tmp = d / (path.name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            for km in records:
                f.write(json.dumps({
                    "key": km.key,
                    "message": km.message,
                    "reason": reason,
                    "quarantined_ms": now_ms,
                }, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _metric().inc(len(records), layer=self.layer)
        log.error(
            "quarantined %d record(s) to %s (%s) — replayable via "
            "tools/chaos.py replay-quarantine", len(records), path, reason,
        )
        return path


def quarantine_files(root: str, layer: str | None = None) -> list[Path]:
    """Dead-letter files under the quarantine root, oldest first."""
    base = Path(strip_scheme(root))
    if layer is not None:
        base = base / layer
    if not base.is_dir():
        return []
    return sorted(p for p in base.rglob("dl-*.jsonl") if p.is_file())


def load_quarantined(path: str | Path) -> list[KeyMessage]:
    """One dead-letter file back into records (replay input)."""
    out: list[KeyMessage] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(KeyMessage(d.get("key"), d["message"]))
    return out


def iter_quarantined(root: str, layer: str | None = None) -> Iterable[KeyMessage]:
    for path in quarantine_files(root, layer):
        yield from load_quarantined(path)
