"""Generation data store: append-only persistence of each batch window,
plus the incremental-aggregate snapshot that lets generation N cost
O(new window) instead of O(all history) (the port's copy of
oryx_tpu/layers/datastore.py).

The reference appends every generation's input as Hadoop SequenceFiles
under dataDir/oryx-<timestamp>/ (SaveToHDFSFunction, skipping empty RDDs,
BatchLayer.java:122-130) and re-reads ALL past data each generation with a
glob (BatchUpdateFunction.java:103-130); TTL cleanup deletes aged dirs
(DeleteOldDataFn). Here each generation is one record-log file using the
bus wire format — so the native appender/scanner accelerate it too — under
<data-dir>/oryx-<timestamp>/data.log.

History reads stream in bounded chunks (iter_all_data) so the from-scratch
rebuild path never materializes the whole log in one read call, and the
incremental path (LazyPastData + the aggregate snapshot under
<data-dir>/.agg-snapshot/) never reads history at all.
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.bus.filelog import _PartitionIndex, encode_record, _maybe_native
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common.retry import retry_call
from oryx_tpu_torch.common.ioutil import (
    delete_recursively,
    list_generation_dirs,
    mkdirs,
    strip_scheme,
)

log = logging.getLogger(__name__)

_DATA_FILE = "data.log"

# Bounded read size for history streaming: one chunk of records is in
# memory per read call, never the whole multi-generation log.
_READ_CHUNK_RECORDS = 65_536

_SNAPSHOT_DIR = ".agg-snapshot"


def save_generation(data_dir: str, timestamp_ms: int, records: Sequence[KeyMessage]) -> Path | None:
    """Persist one generation's window; empty windows write nothing
    (SaveToHDFSFunction skips empty RDDs). The append runs under the
    bounded-retry contract (site "datastore.save"): losing a window to a
    transient disk hiccup is permanent input loss (the offsets commit
    right after), so this path absorbs what it can and fails loudly past
    the deadline — the caller then leaves offsets uncommitted and the
    window is re-delivered."""
    if not records:
        return None
    d = mkdirs(Path(strip_scheme(data_dir)) / f"oryx-{timestamp_ms}")
    path = d / _DATA_FILE
    blob = b"".join(encode_record(km.key, km.message) for km in records)
    native = _maybe_native()

    def _do() -> None:
        faults.fire("datastore.save_window")
        if native is not None:
            native.append_batch(str(path), blob)
        else:
            # single unbuffered append: a crash mid-write leaves a torn
            # TAIL, which the record scanner stops at (filelog
            # _PartitionIndex) — never a mid-log hole. A retried attempt
            # after a torn write would double-append, so roll back to the
            # pre-append size first.
            pre = path.stat().st_size if path.exists() else 0
            fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                try:
                    wrote = os.write(fd, blob)
                except OSError:
                    os.ftruncate(fd, pre)
                    raise
                if wrote != len(blob):
                    os.ftruncate(fd, pre)
                    raise OSError(f"short append to {path}")
            finally:
                os.close(fd)

    retry_call("datastore.save", _do)
    return d


def iter_all_data(
    data_dir: str, chunk_records: int = _READ_CHUNK_RECORDS
) -> Iterator[KeyMessage]:
    """Stream every persisted generation, oldest first, in bounded read
    chunks — the fallback full-rebuild path must not OOM on long
    histories by pulling the entire log through one read call."""
    for gen_dir in list_generation_dirs(strip_scheme(data_dir)):
        path = gen_dir / _DATA_FILE
        if not path.exists():
            continue
        idx = _PartitionIndex(path, _maybe_native())
        offset = 0
        while True:
            recs = idx.read(offset, chunk_records)
            if not recs:
                break
            for _, k, m in recs:
                yield KeyMessage(k, m)
            offset += len(recs)


def load_all_data(data_dir: str) -> list[KeyMessage]:
    """All persisted generations, oldest first — the 'pastData' input to a
    batch model build."""
    return list(iter_all_data(data_dir))


def latest_generation_ts(data_dir: str) -> int | None:
    """Timestamp of the newest persisted generation with data, or None."""
    from oryx_tpu_torch.common.ioutil import timestamp_from_dirname

    newest = None
    for gen_dir in list_generation_dirs(strip_scheme(data_dir)):
        if (gen_dir / _DATA_FILE).exists():
            ts = timestamp_from_dirname(gen_dir.name)
            if ts is not None and (newest is None or ts > newest):
                newest = ts
    return newest


class LazyPastData(Sequence):
    """Sequence view over persisted history that reads NOTHING until a
    consumer actually touches it. The incremental batch path merges only
    the new window into its aggregate snapshot and never materializes
    this; the from-scratch fallback (and any non-incremental update)
    list()s it and pays the streamed read then."""

    def __init__(self, data_dir: str):
        self._data_dir = data_dir
        self._records: list[KeyMessage] | None = None

    def _materialize(self) -> list[KeyMessage]:
        if self._records is None:
            self._records = load_all_data(self._data_dir)
        return self._records

    def known_len(self) -> int | None:
        """len() if already read, else None — trace attributes must not
        force the full history read the lazy path exists to avoid."""
        return None if self._records is None else len(self._records)

    def __len__(self) -> int:
        return len(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __bool__(self) -> bool:
        # cheap existence probe: any generation dir with a data file
        if self._records is not None:
            return bool(self._records)
        for gen_dir in list_generation_dirs(strip_scheme(self._data_dir)):
            if (gen_dir / _DATA_FILE).exists():
                return True
        return False


# ---------------------------------------------------------------------------
# aggregate snapshots: the persistent state behind incremental generations
# ---------------------------------------------------------------------------

def save_aggregate_snapshot(
    data_dir: str,
    timestamp_ms: int,
    fingerprint: str,
    arrays: dict[str, np.ndarray],
    keep: int = 2,
    staged: bool = False,
) -> Path:
    """Persist one generation's aggregate state as a compact columnar npz
    alongside the generation logs. Atomic (tmp + rename), fingerprinted
    against the aggregation schema, pruned to the newest `keep` so disk
    cost stays O(aggregate), not O(generations).

    staged=True writes an ``.npz.staged`` file that load ignores until
    finalize_aggregate_snapshot renames it. The batch layer finalizes
    AFTER the window is persisted and its offsets committed: a snapshot
    that became durable first would double-fold the window when a crash
    in between re-delivers it (the fold is in the snapshot, the window is
    re-read as new data)."""
    d = mkdirs(Path(strip_scheme(data_dir)) / _SNAPSHOT_DIR)
    path = d / f"agg-{timestamp_ms}.npz{'.staged' if staged else ''}"
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        faults.fire("datastore.snapshot_write")
        np.savez(
            tmp,
            fingerprint=np.asarray(fingerprint),
            through_ts=np.asarray(timestamp_ms, dtype=np.int64),
            **arrays,
        )
        # np.savez appends .npz to paths without the suffix; ours has it.
        # Retried (site "datastore.rename"): the tmp is complete, so only
        # the cheap rename replays.
        retry_call("datastore.rename", os.replace, tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise
    if not staged:
        _prune_snapshots(data_dir, keep, path)
    return path


def finalize_aggregate_snapshot(
    data_dir: str, timestamp_ms: int, keep: int = 2
) -> bool:
    """Promote a staged snapshot to loadable — called once the generation
    that folded it is persisted and committed. Returns False when nothing
    was staged (no-op)."""
    d = Path(strip_scheme(data_dir)) / _SNAPSHOT_DIR
    staged = d / f"agg-{timestamp_ms}.npz.staged"
    if not staged.exists():
        return False
    final = d / f"agg-{timestamp_ms}.npz"

    def _do() -> None:
        faults.fire("datastore.snapshot_rename")
        os.replace(staged, final)

    # a crash here (between the staged write and this promote) is SAFE by
    # construction: load ignores .staged files, so the next generation
    # sees a stale-or-missing snapshot and falls back to the from-scratch
    # rebuild that re-anchors it (pinned by tests/test_datastore_crash.py)
    retry_call("datastore.rename", _do)
    _prune_snapshots(data_dir, keep, final)
    return True


def _prune_snapshots(data_dir: str, keep: int, just_wrote: Path) -> None:
    if keep <= 0:
        return
    for old in _snapshot_paths(data_dir)[:-keep]:
        if old != just_wrote:
            delete_recursively(old)
    # staged leftovers from crashed generations are dead weight
    d = Path(strip_scheme(data_dir)) / _SNAPSHOT_DIR
    for p in d.iterdir():
        if p.name.endswith(".npz.staged") and p != just_wrote:
            try:
                if int(p.name[4:-11]) < int(just_wrote.name[4:-4]):
                    delete_recursively(p)
            except ValueError:
                continue


def _snapshot_paths(data_dir: str) -> list[Path]:
    d = Path(strip_scheme(data_dir)) / _SNAPSHOT_DIR
    if not d.is_dir():
        return []
    out = []
    for p in d.iterdir():
        if p.name.startswith("agg-") and p.name.endswith(".npz"):
            try:
                out.append((int(p.name[4:-4]), p))
            except ValueError:
                continue
    return [p for _, p in sorted(out)]


def load_aggregate_snapshot(
    data_dir: str, fingerprint: str
) -> tuple[int, dict[str, np.ndarray]] | None:
    """Newest snapshot whose fingerprint matches, as (through_ts, arrays).
    A missing, unreadable, or schema-mismatched snapshot returns None —
    the caller's cue for a from-scratch rebuild. Callers must ALSO check
    the through_ts against latest_generation_ts: a persisted window newer
    than the snapshot means a generation's merge was lost (e.g. a crash
    between persist and snapshot) and the state is stale."""
    for path in reversed(_snapshot_paths(data_dir)):
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["fingerprint"]) != fingerprint:
                    log.info(
                        "aggregate snapshot %s has fingerprint %s, want %s; "
                        "ignoring", path.name, z["fingerprint"], fingerprint,
                    )
                    continue
                arrays = {
                    k: z[k]
                    for k in z.files
                    if k not in ("fingerprint", "through_ts")
                }
                return int(z["through_ts"]), arrays
        except Exception:  # noqa: BLE001 - torn/corrupt snapshot = rebuild
            log.warning("ignoring unreadable aggregate snapshot %s", path)
    return None
