"""In-memory ALS model state shared by the speed and serving tiers (the
port's copy of oryx_tpu/apps/als/state.py).

The reference splits this across ALSSpeedModel (app/oryx-app .../speed/als/
ALSSpeedModel.java) and ALSServingModel (app/oryx-app-serving .../als/model/
ALSServingModel.java): string-keyed user/item factor stores, expected-ID
bookkeeping for fraction-loaded readiness, known-items map, and cached
Y^T.Y / X^T.X solvers invalidated on factor writes (SolverCache.java).

Instead of lock-partitioned hash maps scanned by a thread
pool, vectors live in a growing numpy arena whose device copy is resynced
lazily (version-stamped) — queries are one fused score + top-k over the
arena.
"""

from __future__ import annotations

import logging
import threading
from typing import NamedTuple

import numpy as np

from oryx_tpu_torch.common.locks import AutoReadWriteLock

# Dirty-row log bound: one (version, row) entry per factor write since the
# oldest still-delta-servable view. Past this the log trims from the front
# and views older than the trimmed tail fall back to a full resync — the
# log must stay small next to the arena it describes (65536 entries ≈ 1 MB
# vs a multi-GB factor matrix).
DELTA_LOG_CAP = 65536


class FactorDelta(NamedTuple):
    """Rows written since a base version: everything a device-view holder
    needs to catch up without copying the arena. ``rows`` are arena row
    indices (sorted, deduplicated), ``mat`` their current vectors, ``ids``
    their string ids row-aligned with ``rows`` (new rows appear here too —
    a row only exists because a write logged it, so rows >= the holder's
    old length extend its id list in index order), ``version`` the store
    version the delta is consistent with, ``n`` the current row count."""

    rows: np.ndarray  # [d] int64 arena row indices
    mat: np.ndarray   # [d, K] float32 current vectors
    ids: list[str]    # [d] string ids, row-aligned
    version: int
    n: int


class FactorStore:
    """Append/update factor vectors keyed by string id, backed by a growing
    arena so the whole store is one [N,K] matrix for device scoring.

    Every write also lands in a bounded dirty-row log so view holders can
    ask for *just the rows that changed* since their version
    (``delta_since``) instead of re-copying the arena — the TensorFlow
    device-resident-variable + sparse-scatter pattern (PAPERS: TensorFlow,
    2016) applied to the serving view."""

    def __init__(self, features: int):
        self.features = features
        self._ids: dict[str, int] = {}
        self._rev: list[str] = []
        self._arena = np.zeros((64, features), dtype=np.float32)
        self._n = 0
        self.version = 0
        self._lock = AutoReadWriteLock()
        # dirty-row log: append-ordered (version, row) pairs. _delta_floor
        # is the oldest base version delta_since can still serve; anything
        # older (log trimmed, arena compacted by retain) must full-resync.
        self.delta_log_cap = DELTA_LOG_CAP
        self._dirty_log: list[tuple[int, int]] = []
        self._delta_floor = 0

    # -- dirty-row bookkeeping (call with the write lock held) --------------

    def _log_rows(self, rows) -> None:
        n_rows = len(rows)
        if n_rows >= self.delta_log_cap:
            # a write bigger than the whole log (bulk model load): every
            # outstanding view needs a full resync anyway — invalidate
            # instead of churning through cap-many appends
            self._dirty_log.clear()
            self._delta_floor = self.version
            return
        v = self.version
        self._dirty_log.extend((v, int(r)) for r in rows)
        overflow = len(self._dirty_log) - self.delta_log_cap
        if overflow > 0:
            # trimming the front abandons the oldest base versions: views
            # at or below the last trimmed entry's version can no longer
            # be served a complete delta
            self._delta_floor = self._dirty_log[overflow - 1][0]
            del self._dirty_log[:overflow]

    def _invalidate_deltas(self) -> None:
        self._dirty_log.clear()
        self._delta_floor = self.version

    def set(self, ident: str, vector: np.ndarray) -> None:
        v = np.asarray(vector, dtype=np.float32)
        if v.shape != (self.features,):
            raise ValueError(f"vector rank {v.shape} != ({self.features},)")
        with self._lock.write():
            row = self._ids.get(ident)
            if row is None:
                if self._n == len(self._arena):
                    self._arena = np.vstack(
                        [self._arena, np.zeros_like(self._arena)]
                    )
                row = self._n
                self._ids[ident] = row
                self._rev.append(ident)
                self._n += 1
            self._arena[row] = v
            self.version += 1
            self._log_rows((row,))

    def bulk_set(self, idents: list[str], matrix: np.ndarray) -> None:
        """Set many vectors in one arena write — the model-load fast path
        (a MODEL artifact or a synthetic load-test model carries the whole
        factor table at once; per-row set() would version-bump and bounds-
        check a million times)."""
        m = np.asarray(matrix, dtype=np.float32)
        if m.ndim != 2 or m.shape != (len(idents), self.features):
            raise ValueError(f"matrix shape {m.shape} != ({len(idents)}, {self.features})")
        with self._lock.write():
            new = [i for i in idents if i not in self._ids]
            need = self._n + len(new)
            if need > len(self._arena):
                grow = max(need, 2 * len(self._arena))
                self._arena = np.vstack(
                    [self._arena, np.zeros((grow - len(self._arena), self.features), dtype=np.float32)]
                )
            rows = np.empty(len(idents), dtype=np.int64)
            for j, ident in enumerate(idents):
                row = self._ids.get(ident)
                if row is None:
                    row = self._n
                    self._ids[ident] = row
                    self._rev.append(ident)
                    self._n += 1
                rows[j] = row
            self._arena[rows] = m
            self.version += 1
            self._log_rows(rows)

    def get(self, ident: str) -> np.ndarray | None:
        with self._lock.read():
            row = self._ids.get(ident)
            return None if row is None else self._arena[row].copy()

    def get_many(self, idents) -> tuple[np.ndarray, np.ndarray]:
        """([n,K] matrix, [n] present mask) under ONE read lock — absent
        ids yield zero rows. The speed tier gathers whole micro-batches
        this way; per-id get() would take the lock per message."""
        with self._lock.read():
            rows = np.fromiter(
                (self._ids.get(i, -1) for i in idents), dtype=np.int64,
                count=len(idents),
            )
            present = rows >= 0
            out = np.zeros((len(idents), self.features), dtype=np.float32)
            if present.any():
                out[present] = self._arena[rows[present]]
            return out, present

    def __contains__(self, ident: str) -> bool:
        with self._lock.read():
            return ident in self._ids

    def __len__(self) -> int:
        with self._lock.read():
            return self._n

    def nbytes(self) -> int:
        """Host arena bytes (capacity, not just occupancy) — the serving
        memory figure the reference's heap table tracks per model size."""
        with self._lock.read():
            return int(self._arena.nbytes)

    def ids(self) -> list[str]:
        with self._lock.read():
            return list(self._rev)

    def snapshot(self) -> tuple[np.ndarray, list[str], int]:
        """(matrix [N,K] copy, row ids, version) — the scoring view."""
        with self._lock.read():
            return self._arena[: self._n].copy(), list(self._rev), self.version

    def get_version(self) -> int:
        """Cheap staleness probe — no arena copy."""
        with self._lock.read():
            return self.version

    def delta_since(
        self, base_version: int, max_rows: int | None = None
    ) -> FactorDelta | None:
        """Rows written after ``base_version``, or None when only a full
        resync can serve the caller: the base predates the dirty log's
        floor (log trimmed, or the arena was compacted by ``retain``), or
        the dirty set exceeds ``max_rows`` (past some fraction of the
        store a delta costs more than the snapshot it replaces — the
        caller's max-delta-fraction knob).

        An up-to-date base returns an EMPTY delta, not None — None always
        means "full resync required"."""
        with self._lock.read():
            if base_version < self._delta_floor:
                return None
            if base_version >= self.version:
                return FactorDelta(
                    np.zeros(0, dtype=np.int64),
                    np.zeros((0, self.features), dtype=np.float32),
                    [], self.version, self._n,
                )
            # the log is append-ordered by version: binary-search the
            # first entry past the base instead of scanning the whole log
            log_ = self._dirty_log
            lo, hi = 0, len(log_)
            while lo < hi:
                mid = (lo + hi) // 2
                if log_[mid][0] <= base_version:
                    lo = mid + 1
                else:
                    hi = mid
            rows = np.unique(
                np.fromiter(
                    (e[1] for e in log_[lo:]), dtype=np.int64,
                    count=len(log_) - lo,
                )
            )
            if max_rows is not None and rows.size > max_rows:
                return None
            return FactorDelta(
                rows,
                self._arena[rows],  # fancy indexing copies
                [self._rev[int(r)] for r in rows],
                self.version,
                self._n,
            )

    def index_of(self, ident: str) -> int | None:
        with self._lock.read():
            return self._ids.get(ident)

    def retain(self, keep: set[str]) -> None:
        """Drop vectors not in `keep` — the model-swap retention step
        (ALSServingModel retainRecent*, :317-370). Compacts the arena."""
        with self._lock.write():
            pairs = [(i, self._ids[i]) for i in self._rev if i in keep]
            new_arena = np.zeros((max(64, len(pairs)), self.features), dtype=np.float32)
            new_ids: dict[str, int] = {}
            new_rev: list[str] = []
            for j, (ident, old_row) in enumerate(pairs):
                new_arena[j] = self._arena[old_row]
                new_ids[ident] = j
                new_rev.append(ident)
            self._arena = new_arena
            self._ids = new_ids
            self._rev = new_rev
            self._n = len(pairs)
            self.version += 1
            # rows MOVED (compaction): old row indices no longer name the
            # same vectors, so no outstanding delta can be served
            self._invalidate_deltas()


class SolverCache:
    """Lazily-computed Cholesky of a store's Gram matrix, invalidated by
    version drift (reference SolverCache.java's dirty-flag recompute)."""

    def __init__(self, store: FactorStore):
        self._store = store
        self._chol: np.ndarray | None = None
        self._built_version = -1
        self._lock = threading.Lock()

    def get(self) -> np.ndarray | None:
        """Current Cholesky factor of (F^T.F + eps.I), or None if the store
        is empty."""
        with self._lock:
            v = self._store.version
            if self._chol is None or self._built_version != v:
                mat, _, _ = self._store.snapshot()
                if len(mat) == 0:
                    return None
                gram = mat.T @ mat + 1e-4 * np.eye(self._store.features, dtype=np.float32)
                self._chol = np.linalg.cholesky(gram).astype(np.float32)
                self._built_version = v
            return self._chol


class ALSState:
    """Full speed/serving-side model: X and Y stores, known-items, expected
    IDs, solver caches."""

    def __init__(self, features: int, implicit: bool):
        self.features = features
        self.implicit = implicit
        self.x = FactorStore(features)
        self.y = FactorStore(features)
        self.known_items: dict[str, set[str]] = {}
        self._known_lock = threading.Lock()
        self.expected_x: set[str] | None = None
        self.expected_y: set[str] | None = None
        # loaded-fraction counters maintained incrementally: the readiness
        # gate runs on EVERY request (app.py get_serving_model), so it must
        # be O(1), not a scan of million-entry expected-ID sets
        self._have_x = 0
        self._have_y = 0
        self._frac_lock = threading.Lock()
        self.yty = SolverCache(self.y)
        self.xtx = SolverCache(self.x)

    # -- factor writes (keep the readiness counters true) -------------------

    def set_x(self, ident: str, vector: np.ndarray) -> None:
        present_before = ident in self.x
        self.x.set(ident, vector)
        if self.expected_x is not None:
            with self._frac_lock:
                if ident not in self.expected_x:
                    self.expected_x.add(ident)
                    self._have_x += 1
                elif not present_before:
                    self._have_x += 1

    def set_y(self, ident: str, vector: np.ndarray) -> None:
        present_before = ident in self.y
        self.y.set(ident, vector)
        if self.expected_y is not None:
            with self._frac_lock:
                if ident not in self.expected_y:
                    self.expected_y.add(ident)
                    self._have_y += 1
                elif not present_before:
                    self._have_y += 1

    def recount(self) -> None:
        """Recompute the loaded counters from scratch — one O(N) pass, used
        after bulk mutations (model swap, inline-tensor ingest)."""
        with self._frac_lock:
            ex, ey = self.expected_x, self.expected_y
            self._have_x = len(ex & set(self.x.ids())) if ex is not None else 0
            self._have_y = len(ey & set(self.y.ids())) if ey is not None else 0

    # -- known items -------------------------------------------------------

    def add_known_items(self, user: str, items) -> None:
        with self._known_lock:
            self.known_items.setdefault(user, set()).update(items)

    def remove_known_item(self, user: str, item: str) -> None:
        with self._known_lock:
            s = self.known_items.get(user)
            if s:
                s.discard(item)

    def get_known_items(self, user: str) -> set[str]:
        with self._known_lock:
            return set(self.known_items.get(user, ()))

    def known_items_snapshot(self) -> dict[str, set[str]]:
        """Consistent copy for whole-map scans (popularity/activity)."""
        with self._known_lock:
            return {u: set(s) for u, s in self.known_items.items()}

    # -- readiness ---------------------------------------------------------

    def set_expected(self, x_ids, y_ids) -> None:
        self.expected_x = set(x_ids)
        self.expected_y = set(y_ids)
        self.recount()

    def fraction_loaded(self) -> float:
        """Loaded fraction of the announced model's vectors
        (ALSServingModel.getFractionLoaded, :386-400). O(1): counters are
        maintained by set_x/set_y/recount, never scanned per request."""
        if self.expected_x is None or self.expected_y is None:
            return 0.0
        total = len(self.expected_x) + len(self.expected_y)
        if total == 0:
            return 1.0
        with self._frac_lock:
            return (self._have_x + self._have_y) / total

    # -- model swap --------------------------------------------------------

    def retain_only(self, x_keep: set[str], y_keep: set[str]) -> None:
        self.x.retain(x_keep)
        self.y.retain(y_keep)
        with self._known_lock:
            self.known_items = {
                u: s for u, s in self.known_items.items() if u in x_keep
            }
        self.recount()


def _adopt_quality_profile(art, item_ids) -> None:
    """Hand the artifact's training profile (qualityProfile extension,
    stamped by the batch tier) to the live quality tracker so this
    process's drift gauges compare against the generation it now serves.
    Best-effort: a model without a profile just reads NaN drift."""
    try:
        prof = art.get_extension("qualityProfile", None)
        if not prof:
            return
        from oryx_tpu_torch.common.qualitystats import (
            TrainingProfile, get_qualitystats,
        )

        qs = get_qualitystats()
        qs.set_training_profile(TrainingProfile.from_json(prof))
        if item_ids:
            qs.note_catalog(item_ids)
    except Exception:  # noqa: BLE001 - drift telemetry never fails a model load
        logging.getLogger(__name__).warning(
            "could not adopt quality profile", exc_info=True
        )


# ---------------------------------------------------------------------------
# shared update-topic consumption (speed + serving tiers)
# ---------------------------------------------------------------------------

def apply_update_message(
    state: ALSState | None,
    key: str | None,
    message: str,
    *,
    with_known_items: bool = False,
) -> ALSState | None:
    """Apply one update-topic message to the in-memory model, returning the
    (possibly new) state. The single implementation behind both
    ALSSpeedModelManager.consumeKeyMessage (app/oryx-app .../als/
    ALSSpeedModelManager.java:68-133) and ALSServingModelManager's
    (app/oryx-app-serving .../als/model/ALSServingModelManager.java:69-135):

    MODEL / MODEL-REF -> a fresh state when the features hyperparam changed
    (retention is keyed on rank, ALSSpeedModelManager.java:100-115),
    otherwise retain only the announced IDs; ingest any inline factor
    tensors; the implicit flag is refreshed even when the state is kept.
    UP -> set one user/item vector (rank-mismatched stale updates dropped).
    """
    from oryx_tpu_torch.apps.als.common import parse_update_message
    from oryx_tpu_torch.common.artifact import read_artifact_from_update

    if key in ("MODEL", "MODEL-REF"):
        art = read_artifact_from_update(key, message)
        features = int(art.get_extension("features"))
        implicit = art.get_extension("implicit", "true") == "true"
        # validate BEFORE mutating: a raise below this block would leave a
        # half-applied model (pruned vectors, swapped expected sets) serving
        # silently after the listener skips the message
        xids = art.get_extension_list("XIDs")
        yids = art.get_extension_list("YIDs")
        for tname, ids in (("X", xids), ("Y", yids)):
            t = art.tensors.get(tname) if art.tensors else None
            if t is not None and len(ids) == len(t) and len(t) > 0:
                if t.ndim != 2 or t.shape[1] != features:
                    raise ValueError(
                        f"model artifact {tname} tensor shape {t.shape} "
                        f"inconsistent with features={features}"
                    )
        if state is None or state.features != features:
            state = ALSState(features, implicit)
        else:
            # same rank but possibly flipped feedback mode: the vectors stay
            # valid, the fold-in rule must follow the new model
            state.implicit = implicit
        if xids or yids:
            state.set_expected(xids, yids)
            state.retain_only(set(xids), set(yids))
        else:
            # skeleton without ID lists: expected IDs arrive via UP flood;
            # treat current contents as the expectation baseline
            state.set_expected(state.x.ids(), state.y.ids())
        if art.tensors:
            x, y = art.tensors.get("X"), art.tensors.get("Y")
            if y is not None and len(yids) == len(y) and len(y) > 0:
                state.y.bulk_set(yids, y)
            if x is not None and len(xids) == len(x) and len(x) > 0:
                state.x.bulk_set(xids, x)
            if x is not None or y is not None:
                state.recount()
            if with_known_items:
                for u, items in art.content.get("knownItems", {}).items():
                    state.add_known_items(u, items)
        _adopt_quality_profile(art, yids)
    elif key == "UP":
        if state is None:
            return None  # updates before any model: nothing to apply to
        kind, ident, vec, known = parse_update_message(message)
        if len(vec) != state.features:
            return state  # stale update from a different-rank model
        if kind == "X":
            state.set_x(ident, vec)
            if with_known_items and known:
                state.add_known_items(ident, known)
        elif kind == "Y":
            state.set_y(ident, vec)
    return state


def state_from_arrays(
    features: int,
    implicit: bool,
    x_ids,
    x: np.ndarray,
    y_ids,
    y: np.ndarray,
) -> ALSState:
    """An ALSState holding the given factor tables, e.g. the numpy
    ``(matrix, ids)`` pairs of another process's ``FactorStore.snapshot()``
    -- one model handed to two implementations. Every id is expected, so
    the state reads as fully loaded."""
    state = ALSState(features, implicit)
    x_ids, y_ids = list(x_ids), list(y_ids)
    if y_ids:
        state.y.bulk_set(y_ids, y)
    if x_ids:
        state.x.bulk_set(x_ids, x)
    state.set_expected(x_ids, y_ids)
    return state
