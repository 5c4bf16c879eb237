"""ALS serving tier: device factor view + query methods + manager (the
port's counterpart of oryx_tpu/apps/als/serving.py).

Mirrors ALSServingModel/ALSServingModelManager (app/oryx-app-serving
.../als/model/ALSServingModel.java:96-409, ALSServingModelManager.java:
69-182). The reference partitions Y by LSH bucket and fans requests over a
thread pool; here the whole Y store is one device matrix and top-N is one
coalesced fused score + top-k dispatch (serving/batcher.py -> ops/topk.py),
followed by an exact f32 re-rank of the candidates on the host.

With ``oryx.als.sample-rate < 1`` the model serves the reference's LSH
candidate sampling instead, as the JAX package does: the partition blocks
within the Hamming ball of the query's partition (apps/als/lsh.py) are
scored on the host, under a core-sized semaphore. That is the configured
mode's own semantics, not a fallback: it runs only when configured, and no
device failure ever routes a request there (a wedged card answers 503).
No device view is built in that mode.

A configured fraction of final answers (``oryx.monitoring.quality.
sample-rate``) is offered to the live quality sampler
(common/qualitystats.py), which rescores it exactly off the request path.
Every resync reports into the shared ``oryx_device_sync_*`` /
``oryx_view_resync_total`` families (serving/viewsync.py) and, with tracing
on, a ``view.resync`` span. Not ported yet: sharded and chunked views
(ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.api import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.apps.als.common import ALSConfig
from oryx_tpu_torch.apps.als.state import ALSState, apply_update_message
from oryx_tpu_torch.common.classutil import load_instance_of
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.tracing import current_span, get_tracer
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.als import compute_updated_xu
from oryx_tpu_torch.ops.topk import check_features
from oryx_tpu_torch.ops.transfer import (
    QuantizedMatrix,
    quantize_rows_int8,
    quantized_device_put,
    quantized_scatter_bytes,
    row_capacity,
    scatter_rows,
    scatter_transfer_bytes,
    staged_device_put,
    to_pitched,
)
from oryx_tpu_torch.serving.app import chain_future, configure_post_pool, post_pool
from oryx_tpu_torch.serving.batcher import TopKBatcher
from oryx_tpu_torch.serving.viewsync import (
    extend_view_ids,
    note_sync_bytes,
    view_sync_metrics,
)

log = logging.getLogger(__name__)

# Max LSH partition-rebuild frequency under live update ingestion.
_LSH_REFRESH_SEC = 1.0

# Background resync poll interval: the thread also wakes immediately on
# _request_resync, so this only bounds how long a pure speed-layer write
# storm (no queries observing the drift) can stay un-synced.
_RESYNC_POLL_S = 0.05

# Serving score modes (oryx.serving.api.score-mode): how the device view
# scores the catalog. "exact" = bf16 scan + f32 candidate re-rank;
# "quantized" = int8 rows + per-row scales (half the bytes) with the same
# exact f32 re-rank of survivors; "approx" = selection at a recall target
# (exact here, as jax.lax.approx_max_k is off the TPU).
SCORE_MODES = ("exact", "quantized", "approx")

# Recall target score-mode=approx uses when oryx.als.approx-recall is left
# at its exact default.
DEFAULT_APPROX_RECALL = 0.95


@dataclass
class SyncConfig:
    """How the serving model keeps its device/host scoring views in step
    with the live factor store (oryx.serving.api.sync.*).

    mode:
      - "delta" (default): dirty rows since the served view's version are
        scattered into a copy of the device matrix and the host mirror /
        unit view update the same rows; a background thread does
        all of it off the query path and swaps consistent view tuples.
      - "full": every resync rebuilds from a snapshot (still in the
        background) — the bisection mode when delta application is
        suspected.
      - "blocking": the next query after a version bump rebuilds the whole
        view synchronously under the sync lock.
    capacity_headroom: the host f32 mirror's rows are allocated for the
      CURRENT store size grown by this fraction (then bucket-laddered,
      ops/transfer.py row_capacity), so growth within it stays a delta
      resync. The device view holds the live rows only: a delta that
      appends rows scatters into a grown copy, and no padding row is ever
      scored.
    max_delta_fraction: a dirty set larger than this fraction of the store
      full-resyncs instead.
    """

    mode: str = "delta"
    capacity_headroom: float = 0.125
    max_delta_fraction: float = 0.2

    @staticmethod
    def from_config(config: Config) -> "SyncConfig":
        g = lambda k, d: config.get(f"oryx.serving.api.sync.{k}", d)
        mode = str(g("mode", "delta"))
        if mode not in ("delta", "full", "blocking"):
            raise ValueError(
                "oryx.serving.api.sync.mode must be delta, full or "
                f"blocking, got {mode!r}"
            )
        headroom = float(g("capacity-headroom", 0.125))
        if headroom < 0.0:
            raise ValueError(
                "oryx.serving.api.sync.capacity-headroom must be >= 0"
            )
        frac = float(g("max-delta-fraction", 0.2))
        if not (0.0 < frac <= 1.0):
            raise ValueError(
                "oryx.serving.api.sync.max-delta-fraction must be in (0, 1]"
            )
        if int(g("shard-count", 1)) != 1:
            raise ValueError(
                "oryx.serving.api.sync.shard-count > 1: sharded views are "
                "not ported yet"
            )
        return SyncConfig(mode, headroom, frac)


class _LshPartitions:
    """Per-partition contiguous scoring blocks for the LSH host path:
    rows[p] maps block rows back to store rows, mats[p] is the contiguous
    factor block, norms[p] its row norms (for cosine queries). One matched
    snapshot, rebuilt with the partition view."""

    __slots__ = ("rows", "mats", "norms")

    def __init__(self, rows, mats, norms):
        self.rows = rows
        self.mats = mats
        self.norms = norms


def _normalize_rows(a: torch.Tensor) -> torch.Tensor:
    """The cosine view of an item view: unit rows, pitched like ``a``."""
    af = a.float()
    n = torch.clamp(torch.linalg.norm(af, dim=1, keepdim=True), min=1e-12)
    return to_pitched((af / n).to(a.dtype))


class ALSServingModel(ServingModel):
    def __init__(
        self,
        state: ALSState,
        approx_recall: float = 1.0,
        sync: SyncConfig | None = None,
        score_mode: str = "exact",
        device=None,
        sample_rate: float = 1.0,
        num_cores: int | None = None,
        lsh_max_bits_differing: int | None = None,
    ):
        self.state = state
        self.device = resolve_device(device)
        self.approx_recall = approx_recall
        if score_mode not in SCORE_MODES:
            raise ValueError(
                f"score_mode must be one of {SCORE_MODES}, got {score_mode!r}"
            )
        if score_mode == "exact" and approx_recall < 1.0:
            # the legacy knob: oryx.als.approx-recall < 1 meant approximate
            # device selection before score-mode existed
            score_mode = "approx"
        self.score_mode = score_mode
        if self.device.type == "cuda":
            # the kernel's widest rows: a model too wide for it fails here,
            # once, and not on every request
            check_features(
                state.features,
                torch.int8 if score_mode == "quantized" else torch.bfloat16,
            )
        self.sync = sync or SyncConfig()
        # (device matrix [n,K], ids [n], version, host f32 mirror
        # [capacity,K]) swapped as ONE tuple: readers always see a matched
        # set, no lock on the read path
        self._sync_lock = threading.Lock()
        self._device_view: tuple | None = None  # guarded-by: _sync_lock (writes)
        # row-normalized view, same keying
        self._unit_view: tuple | None = None  # guarded-by: _sync_lock (writes)
        self._resync_thread: threading.Thread | None = None  # guarded-by: _sync_lock (writes)
        self._resync_evt = threading.Event()
        self._stop = threading.Event()
        # last completed resync: {kind, rows, bytes, seconds, version}
        self.last_resync: dict | None = None  # guarded-by: _sync_lock (writes)
        # LSH candidate sampling (sample_rate < 1): the partition view is
        # built in place of the device view
        self.sample_rate = sample_rate
        self._num_cores = num_cores
        self._lsh_max_bits = lsh_max_bits_differing
        self._lsh = None  # guarded-by: _sync_lock (writes)
        # (ids, parts, version, _LshPartitions) — no flat matrix copy: the
        # partition blocks inside _LshPartitions are the snapshot
        self._partition_view: tuple | None = None  # guarded-by: _sync_lock (writes)
        self._partition_built_at = 0.0  # guarded-by: _sync_lock (writes)
        # Host LSH scoring gates on a core-sized semaphore: each request
        # dots O(sample_rate·N·F) of partition blocks, and unbounded
        # request concurrency would multiply that working set by the
        # thread count. Cores-many scorers keep the CPUs busy with bounded
        # memory; the rest queue.
        self._host_score_sem = threading.Semaphore(
            max(1, num_cores if num_cores else (os.cpu_count() or 1))
        )

    def close(self) -> None:
        """Stop the background resync thread (the manager calls this when
        a MODEL update replaces the serving model)."""
        self._stop.set()
        self._resync_evt.set()

    def effective_recall(self) -> float:
        """1.0 outside approx mode; in approx mode the configured
        oryx.als.approx-recall, or DEFAULT_APPROX_RECALL when that knob was
        left at its exact default."""
        if self.score_mode != "approx":
            return 1.0
        return (
            self.approx_recall if self.approx_recall < 1.0
            else DEFAULT_APPROX_RECALL
        )

    def served_version(self) -> int | None:
        """Store version of the currently SERVED device view (None before
        the first build)."""
        view = self._device_view
        return None if view is None else view[2]

    def fraction_loaded(self) -> float:
        """The announced model's loaded fraction, and 0 until its scoring
        view exists (the device view, or with LSH the partition view): the
        manager builds it on the update listener's thread, or on the thread
        that installs the model, so /ready never answers 200 for a model
        whose first request would have to build it."""
        if self._scoring_view() is None:
            return 0.0
        return self.state.fraction_loaded()

    def _scoring_view(self) -> tuple | None:
        """The view queries score against: the LSH partition view when
        sample_rate < 1, else the device view (None before its build)."""
        return self._partition_view if self.sample_rate < 1.0 else self._device_view

    def build_views(self) -> None:
        """Build the scoring view now instead of on the first query: the
        device view, or with LSH the host partition view."""
        if self.sample_rate < 1.0:
            self._lsh_index()
        else:
            self._y_view_full()

    # -- LSH partition view (sample_rate < 1) ------------------------------

    def _ensure_lsh(self):
        from oryx_tpu_torch.apps.als.lsh import LocalitySensitiveHash

        if self._lsh is None:
            with self._sync_lock:
                if self._lsh is None:
                    self._lsh = LocalitySensitiveHash(
                        self.sample_rate, self.state.features, self._num_cores,
                        max_bits_differing=self._lsh_max_bits,
                    )
        return self._lsh

    def _build_partition_view(self) -> tuple:  # oryxlint: holds=_sync_lock
        """Full LSH re-partition from a store snapshot — O(N.H.F) plus the
        O(N.F) snapshot copy, so its cost is recorded (lsh.rebuild span +
        oryx_lsh_rebuild_seconds). Call under _sync_lock."""
        t0 = time.monotonic()
        mat, ids, version = self.state.y.snapshot()
        mat = np.asarray(mat, dtype=np.float32)
        parts = self._lsh.indices_for(mat)
        # partition -> (row indices, contiguous block, norms), grouped
        # once per snapshot: the query path touches only candidate
        # partitions — no O(N) isin scan and no per-request gather
        order = np.argsort(parts, kind="stable")
        sorted_parts = parts[order]
        bounds = np.searchsorted(
            sorted_parts, np.arange(self._lsh.num_partitions + 1)
        )
        rows_by_part = [
            order[bounds[p]:bounds[p + 1]]
            for p in range(self._lsh.num_partitions)
        ]
        mats = [np.ascontiguousarray(mat[r]) for r in rows_by_part]
        pindex = _LshPartitions(
            rows=rows_by_part,
            mats=mats,
            norms=[np.linalg.norm(m, axis=1) for m in mats],
        )
        # the partition blocks are a complete copy of the store: no flat
        # matrix is kept beside them
        view = (ids, parts, version, pindex)
        self._partition_view = view
        self._partition_built_at = time.monotonic()
        view_sync_metrics()[3].observe(time.monotonic() - t0)
        tr = get_tracer()
        if tr.enabled:
            tr.record_interval(
                "lsh.rebuild", t0, rows=len(ids), version=version,
            )
        return view

    def _lsh_index(self):
        """(lsh, ids, partitions-per-row, partition index) — ONE matched
        snapshot: id list, partition assignment and partition blocks all
        from the same store version. In the background sync modes a stale
        view is served as-is and the resync thread reassigns only DIRTY
        rows between partitions (full re-partitions only on drift
        overflow, at most once per refresh window); blocking mode rebuilds
        inline, rate-limited to once per refresh window."""
        self._ensure_lsh()
        view = self._partition_view
        version = self.state.y.get_version()
        if view is not None and view[2] == version:
            return self._lsh, view[0], view[1], view[3]
        if view is not None and self.sync.mode != "blocking":
            # serve the previous consistent snapshot; catch up off-path
            self._request_resync()
            return self._lsh, view[0], view[1], view[3]
        now = time.monotonic()
        if view is None or now - self._partition_built_at >= _LSH_REFRESH_SEC:
            with self._sync_lock:
                view = self._partition_view
                if view is None or (
                    view[2] != self.state.y.get_version()
                    and time.monotonic() - self._partition_built_at
                    >= _LSH_REFRESH_SEC
                ):
                    view = self._build_partition_view()
        return self._lsh, view[0], view[1], view[3]

    # -- device scoring view ----------------------------------------------

    def _y_view_full(self) -> tuple:
        """(device Y matrix [n,K], row ids [n], version, host Y
        matrix [capacity,K]). On drift the background sync modes serve the
        PREVIOUS consistent snapshot and hand the catch-up to the resync
        thread; only the first build — and every drift in blocking mode —
        runs inline."""
        view = self._device_view
        if view is not None:
            if view[2] == self.state.y.get_version():
                return view
            if self.sync.mode != "blocking":
                self._request_resync()
                return view
        with self._sync_lock:
            view = self._device_view
            if view is not None and (
                self.sync.mode != "blocking"
                or view[2] == self.state.y.get_version()
            ):
                return view
            return self._build_views_full()

    def _y_unit_view(self):
        """Row-normalized Y for cosine queries, cached per store version.
        unit/ids/host matrix come from ONE view tuple."""
        view = self._unit_view
        if view is not None:
            if view[2] != self.state.y.get_version():
                if self.sync.mode != "blocking":
                    self._request_resync()
                    return view[0], view[1], view[3]
            else:
                return view[0], view[1], view[3]
        self._y_view_full()
        with self._sync_lock:
            view = self._unit_view
            dv = self._device_view
            if view is not None and (
                view[2] == dv[2] or self.sync.mode != "blocking"
            ):
                return view[0], view[1], view[3]
            # from the CURRENT device view, read under the lock: the unit
            # view must mirror exactly one device snapshot
            view = self._build_unit_view(*dv)
        return view[0], view[1], view[3]

    def _build_unit_view(self, y, ids, version, host_mat) -> tuple:  # holds _sync_lock
        """Normalize the device view into the cosine unit view. A quantized
        view normalizes by SCALE alone and shares
        the int8 rows."""
        unit = y.unit_scaled() if isinstance(y, QuantizedMatrix) else _normalize_rows(y)
        view = (unit, ids, version, host_mat)
        self._unit_view = view
        return view

    def _build_views_full(self) -> tuple:  # holds _sync_lock
        """Full snapshot rebuild of the device + host scoring views (and
        the unit view, when materialized)."""
        t0 = time.monotonic()
        mat, ids, version = self.state.y.snapshot()
        mat = np.asarray(mat, dtype=np.float32)
        n = len(ids)
        features = self.state.features
        quantize = self.score_mode == "quantized"
        itemsize = 1 if quantize else 2
        # a capacity-padded host mirror: store growth within the headroom
        # updates it in place (blocking mode rebuilds per drift anyway)
        cap = n
        if self.sync.mode != "blocking":
            cap = row_capacity(n, self.sync.capacity_headroom)
        if cap > n:
            host = np.zeros((cap, features), dtype=np.float32)
            host[:n] = mat
        else:
            host = mat
        # exact/approx: bf16 (half the bytes of f32 for the scan);
        # quantized: int8 rows + per-row f32 scales. Live rows only: the
        # kernel takes the row count at run time, so padding would only add
        # rows to score. The f32 host matrix rides along, row-aligned, for
        # the exact candidate re-rank.
        if quantize:
            y_dev = quantized_device_put(mat, device=self.device)
        else:
            y_dev = staged_device_put(mat, dtype=torch.bfloat16, device=self.device)
        view = (y_dev, ids, version, host)
        self._device_view = view
        if self._unit_view is not None:
            self._build_unit_view(y_dev, ids, version, host)
        sync_bytes = n * features * itemsize + (n * 4 if quantize else 0)
        self._note_resync("full", n, sync_bytes, time.monotonic() - t0, version)
        return view

    # -- background resync --------------------------------------------------

    def _note_resync(self, kind: str, rows: int, n_bytes: int,  # holds _sync_lock
                     seconds: float, version: int) -> None:
        m_bytes, m_secs, m_total = view_sync_metrics()[:3]
        note_sync_bytes(m_bytes, n_bytes, None)
        m_secs.observe(seconds)
        m_total.inc(kind=kind)
        self.last_resync = {
            "kind": kind, "rows": rows, "bytes": n_bytes,
            "seconds": seconds, "version": version,
        }
        tr = get_tracer()
        if tr.enabled:
            tr.record_interval(
                "view.resync", time.monotonic() - seconds,
                kind=kind, rows=rows, bytes=n_bytes, version=version,
            )

    def _request_resync(self) -> None:
        """Wake (starting if needed) the background resync thread. Queries
        call this on observing version drift and keep serving the old
        snapshot."""
        t = self._resync_thread
        if t is None or not t.is_alive():
            with self._sync_lock:
                t = self._resync_thread
                if (t is None or not t.is_alive()) and not self._stop.is_set():
                    t = threading.Thread(
                        target=self._resync_loop, name="oryx-als-resync",
                        daemon=True,
                    )
                    self._resync_thread = t
                    t.start()
        self._resync_evt.set()

    def _views_stale(self) -> bool:
        v = self.state.y.get_version()
        dv = self._device_view
        if dv is not None and dv[2] != v:
            return True
        uv = self._unit_view
        if dv is not None and uv is not None and uv[2] != dv[2]:
            return True
        pv = self._partition_view
        return pv is not None and pv[2] != v

    def _resync_loop(self) -> None:
        while not self._stop.is_set():
            self._resync_evt.wait(_RESYNC_POLL_S)
            self._resync_evt.clear()
            if self._stop.is_set():
                return
            try:
                while not self._stop.is_set() and self._views_stale():
                    if not self._resync_once():
                        break  # rate-limited: retry on the next poll tick
            except Exception:
                log.exception("background view resync failed")
                # don't spin on a persistent failure (e.g. device OOM);
                # queries keep serving the last consistent snapshot
                time.sleep(0.5)

    def _resync_once(self) -> bool:
        """Bring every materialized view up to the current store version:
        dirty-row deltas when the drift is small (mode delta), snapshot
        rebuilds otherwise. Swaps are atomic tuple stores under
        _sync_lock. Returns False when the only remaining work is a
        rate-limited LSH re-partition (the caller backs off instead of
        spinning on the limiter)."""
        progress = False
        with self._sync_lock:
            dv = self._device_view
            if dv is not None and dv[2] != self.state.y.get_version():
                if not (self.sync.mode == "delta" and self._try_apply_delta(dv)):
                    self._build_views_full()
                progress = True
            dv, uv = self._device_view, self._unit_view
            if dv is not None and uv is not None and uv[2] != dv[2]:
                self._build_unit_view(*dv)
                progress = True
            pv = self._partition_view
            if pv is not None and pv[2] != self.state.y.get_version():
                if self.sync.mode == "delta" and self._try_partition_delta(pv):
                    progress = True
                # full re-partition is O(N.H.F): rate-limited so a
                # delta-overflow storm can't spin it back-to-back
                elif (time.monotonic() - self._partition_built_at
                        >= _LSH_REFRESH_SEC):
                    self._build_partition_view()
                    progress = True
        return progress

    def _try_apply_delta(self, dv: tuple) -> bool:  # holds _sync_lock
        """Apply a dirty-row delta to the device/host/unit views. Returns
        False when only a full rebuild can serve (drift overflow, growth
        past the host mirror's capacity, arena compaction). A quantized
        view re-quantizes ONLY the dirty rows; appended rows grow the
        device copies the scatter makes anyway."""
        t0 = time.monotonic()
        y_dev, ids, _version, host_mat = dv
        n_old = len(ids)
        capacity = int(host_mat.shape[0])
        delta = self.state.y.delta_since(
            dv[2],
            max_rows=max(1, int(self.sync.max_delta_fraction * max(n_old, 1))),
        )
        if delta is None or delta.n > capacity:
            return False
        if delta.rows.size == 0:
            return True  # raced an already-applied version
        rows, mat_rows = delta.rows, delta.mat
        ids = extend_view_ids(ids, delta)
        if ids is None:
            return False
        n_new = len(ids)
        uv = self._unit_view
        if uv is not None and uv[2] != dv[2]:
            uv = None  # diverged: _resync_once rebuilds it whole
        # the host f32 mirror updates the SAME rows in place (a racing
        # reader may see a dirty row one version newer in the advisory f32
        # re-rank, never a torn matrix/ids pairing)
        host_mat[rows] = mat_rows
        # not in place: in-flight coalesced dispatches still score the old
        # buffer; the old view stays whole until the swap below
        quantized = isinstance(y_dev, QuantizedMatrix)
        features = self.state.features
        if quantized:
            # quantize the dirty rows ONCE so the unit view can keep
            # SHARING the device view's int8 rows
            q_rows, s_rows = quantize_rows_int8(mat_rows)
            y_new = QuantizedMatrix(
                scatter_rows(y_dev.q, rows, q_rows, n_new),
                scatter_rows(y_dev.scale, rows, s_rows, n_new),
            )
            n_bytes = quantized_scatter_bytes(rows.size, features)
        else:
            y_new = scatter_rows(y_dev, rows, mat_rows, n_new)
            n_bytes = scatter_transfer_bytes(rows.size, 2, features)
        self._device_view = (y_new, ids, delta.version, host_mat)
        if uv is not None:
            if quantized:
                qn = np.linalg.norm(q_rows.astype(np.float32), axis=1)
                unit_scales = np.where(
                    qn > 0, 1.0 / np.maximum(qn, 1e-12), 0.0
                ).astype(np.float32)
                unit_new = QuantizedMatrix(
                    y_new.q, scatter_rows(uv[0].scale, rows, unit_scales, n_new)
                )
                n_bytes += scatter_transfer_bytes(rows.size, 4, 1)
            else:
                norms = np.linalg.norm(mat_rows, axis=1)
                unit_rows = mat_rows / np.maximum(norms, 1e-12)[:, None]
                unit_new = scatter_rows(uv[0], rows, unit_rows, n_new)
                n_bytes += scatter_transfer_bytes(rows.size, 2, features)
            self._unit_view = (unit_new, ids, delta.version, host_mat)
        self._note_resync(
            "delta", int(rows.size), n_bytes, time.monotonic() - t0,
            delta.version,
        )
        return True

    def _try_partition_delta(self, pv: tuple) -> bool:  # oryxlint: holds=_sync_lock
        """Reassign only dirty rows between LSH partitions instead of
        re-partitioning the whole store. Touched partitions get rebuilt
        contiguous blocks; untouched partitions share their arrays with
        the previous view. Call under _sync_lock."""
        ids, parts, _version, pindex = pv
        n_old = len(ids)
        delta = self.state.y.delta_since(
            pv[2],
            max_rows=max(1, int(self.sync.max_delta_fraction * max(n_old, 1))),
        )
        if delta is None:
            return False
        if delta.rows.size == 0:
            return True
        t0 = time.monotonic()
        rows, mat_rows = delta.rows, delta.mat
        ids = extend_view_ids(ids, delta)
        if ids is None:
            return False
        new_parts_of_dirty = self._lsh.indices_for(
            np.ascontiguousarray(mat_rows, dtype=np.float32)
        )
        parts = np.concatenate([parts, np.zeros(delta.n - n_old, dtype=parts.dtype)]) \
            if delta.n > n_old else parts.copy()
        old_parts_of_dirty = parts[rows]
        parts[rows] = new_parts_of_dirty
        touched = set(int(p) for p in old_parts_of_dirty[rows < n_old]) | set(
            int(p) for p in new_parts_of_dirty
        )
        new_rows = list(pindex.rows)
        new_mats = list(pindex.mats)
        new_norms = list(pindex.norms)
        vec_of = {int(r): mat_rows[j] for j, r in enumerate(rows)}
        dirty_set = set(int(r) for r in rows)
        for p in touched:
            old_block_rows = pindex.rows[p]
            keep = ~np.isin(old_block_rows, rows)
            kept_rows = old_block_rows[keep]
            kept_mat = pindex.mats[p][keep]
            add = np.asarray(
                sorted(r for r in dirty_set if parts[r] == p), dtype=np.int64
            )
            if add.size:
                add_mat = np.stack([vec_of[int(r)] for r in add])
                block_rows = np.concatenate([kept_rows, add])
                block_mat = np.ascontiguousarray(
                    np.concatenate([kept_mat, add_mat.astype(np.float32)])
                )
            else:
                block_rows, block_mat = kept_rows, np.ascontiguousarray(kept_mat)
            new_rows[p] = block_rows
            new_mats[p] = block_mat
            new_norms[p] = np.linalg.norm(block_mat, axis=1)
        self._partition_view = (
            ids, parts, delta.version,
            _LshPartitions(rows=new_rows, mats=new_mats, norms=new_norms),
        )
        # no device traffic: pure host reindex — recorded as a delta
        # resync with zero sync bytes so view freshness is still visible
        self._note_resync(
            "delta", int(rows.size), 0, time.monotonic() - t0, delta.version,
        )
        return True

    # -- queries -----------------------------------------------------------

    def _shadow_sample(
        self, vec, pairs, how_many, exclude, cosine, mode, trace_id,
        snapshot_fn,
    ) -> None:
        """Offer this served response to the live quality sampler
        (common/qualitystats.py): a config-gated fraction is re-scored
        exactly on the sampler's drain thread. Called AFTER the response
        is final, on the post pool / host-path caller thread — never the
        batcher dispatcher — and rescorer-filtered responses are skipped
        (their exact reference would need the rescorer replayed)."""
        from oryx_tpu_torch.common.qualitystats import get_qualitystats

        get_qualitystats().maybe_sample(
            vec, pairs, how_many=how_many, exclude=exclude, cosine=cosine,
            score_mode=mode, trace_id=trace_id, snapshot_fn=snapshot_fn,
        )

    def _lsh_top_n(self, user_vector, how_many, exclude, rescorer, cosine,
                   trace_id) -> list[tuple[str, float]]:
        """LSH candidate sampling: score only items whose partition is
        within the Hamming ball of the query's (the reference's
        candidate-partition fan-out, ALSServingModel.java:264-279), on the
        host, gated by the core-sized scoring semaphore (bounded memory
        under load). Ids, partitions and blocks are one matched snapshot
        from _lsh_index."""
        lsh, ids, _parts, pindex = self._lsh_index()
        if not ids:
            return []
        k = min(len(ids), how_many + len(exclude) + 8)
        cand_parts = [
            int(p) for p in lsh.candidate_indices(user_vector)
            if pindex.rows[int(p)].size
        ]
        if not cand_parts:
            return []
        q = np.asarray(user_vector, dtype=np.float32)
        with self._host_score_sem:
            # dot each candidate partition's contiguous block; the
            # per-partition scores and row maps concatenate into one
            # ranking problem
            scores = np.concatenate([pindex.mats[p] @ q for p in cand_parts])
            rows = np.concatenate([pindex.rows[p] for p in cand_parts])
            if cosine:
                norms = np.concatenate([pindex.norms[p] for p in cand_parts])
                scores = scores / np.maximum(norms, 1e-12)
            kk = min(k, rows.size)
            top = np.argpartition(-scores, kk - 1)[:kk]
            top = top[np.argsort(-scores[top])]
            vals, idx = scores[top], rows[top]
        pairs = _trim_pairs(vals, idx, ids, how_many, exclude, rescorer)
        if rescorer is None and pairs:
            # LSH live recall: the exact reference is a fresh full-store
            # snapshot, taken on the sampler's drain thread
            store = self.state.y

            def lsh_snapshot():
                mat, snap_ids, _v = store.snapshot()
                return np.asarray(mat, dtype=np.float32), snap_ids, len(snap_ids)

            self._shadow_sample(
                user_vector, pairs, how_many, exclude, cosine, "lsh",
                trace_id, lsh_snapshot,
            )
        return pairs

    def _top_n_plan(self, user_vector, how_many, exclude, rescorer, cosine):
        """Shared front half of top_n/top_n_async: ("done", pairs) when
        the answer is complete on this thread (nothing to score, or LSH
        host scoring), or ("fut", batcher_future, post_fn)."""
        span = current_span()
        trace_id = span.trace_id if span is not None else None
        if self.sample_rate < 1.0:
            return "done", self._lsh_top_n(
                user_vector, how_many, exclude, rescorer, cosine, trace_id
            )
        if cosine:
            y, ids, host_mat = self._y_unit_view()
        else:
            y, ids, _v, host_mat = self._y_view_full()
        n = len(ids)
        if n == 0:
            return "done", []
        # over-fetch to survive exclusions/filters, then trim; concurrent
        # requests coalesce into one bucketed-shape dispatch
        k = min(n, how_many + len(exclude) + 8)
        fut = TopKBatcher.shared().submit_nowait(
            user_vector, k, y, recall=self.effective_recall(),
            score_mode=self.score_mode,
        )

        def _post(result):
            vals, idx = result
            # the device selects candidates in bf16/int8; near-ties inside
            # the candidate set are re-ranked EXACTLY against the
            # row-aligned f32 host matrix
            vals, idx = _rerank_exact(user_vector, vals, idx, host_mat, cosine)
            pairs = _trim_pairs(vals, idx, ids, how_many, exclude, rescorer)
            if rescorer is None and pairs:
                # device-path live recall: the exact reference is the
                # row-aligned host mirror the response was re-ranked
                # against (no copy; the drain reads it by reference)
                self._shadow_sample(
                    user_vector, pairs, how_many, exclude, cosine,
                    self.score_mode, trace_id, lambda: (host_mat, ids, n),
                )
            return pairs

        return "fut", fut, _post

    def top_n(
        self,
        user_vector: np.ndarray,
        how_many: int,
        exclude: set[str] = frozenset(),
        rescorer=None,
        cosine: bool = False,
    ) -> list[tuple[str, float]]:
        """Blocking top-N. Post-processing runs on the CALLER's thread, so
        rescorers issuing nested blocking queries cannot exhaust the post
        pool into a deadlock."""
        plan = self._top_n_plan(user_vector, how_many, exclude, rescorer, cosine)
        if plan[0] == "done":
            return plan[1]
        _, fut, post = plan
        return post(fut.result())

    def top_n_async(
        self,
        user_vector: np.ndarray,
        how_many: int,
        exclude: set[str] = frozenset(),
        rescorer=None,
        cosine: bool = False,
    ) -> Future:
        """top_n as a Future: the host post-processing (exact re-rank,
        exclusion/rescorer trim) chains onto the batcher future on the
        post pool, never on the batcher's dispatcher thread."""
        out: Future = Future()
        try:
            plan = self._top_n_plan(
                user_vector, how_many, exclude, rescorer, cosine
            )
        except Exception as e:  # carried to the caller
            out.set_exception(e)
            return out
        if plan[0] == "done":
            out.set_result(plan[1])
            return out
        _, fut, post = plan
        return chain_future(fut, post, executor=post_pool())

    def get_user_vector(self, user: str) -> np.ndarray | None:
        return self.state.x.get(user)

    def get_item_vector(self, item: str) -> np.ndarray | None:
        return self.state.y.get(item)

    def dot(self, user: str, item: str) -> float | None:
        xu = self.state.x.get(user)
        yi = self.state.y.get(item)
        if xu is None or yi is None:
            return None
        return float(xu @ yi)

    def fold_in_user_vector(
        self, item_strengths: list[tuple[str, float]], implicit: bool | None = None
    ) -> np.ndarray | None:
        """Anonymous-user vector from (item, strength) prefs: iterated
        fold-in against the cached Y solver (EstimateForAnonymous.java:
        47-85 / RecommendToAnonymous pattern), on the model's device."""
        chol = self.state.yty.get()
        if chol is None:
            return None
        implicit = self.state.implicit if implicit is None else implicit
        chol_t = torch.from_numpy(chol).to(self.device)
        xu = torch.zeros(self.state.features, dtype=torch.float32, device=self.device)
        folded = False
        for item, strength in item_strengths:
            yi = self.state.y.get(item)
            if yi is None:
                continue
            xu = compute_updated_xu(
                chol_t, float(strength), xu,
                torch.from_numpy(yi).to(self.device), implicit=implicit,
            )
            folded = True
        return xu.cpu().numpy() if folded else None

    def cosine_to_items(self, items: list[str]) -> np.ndarray | None:
        """Mean unit-vector of the given items (similarity queries)."""
        vecs = [self.state.y.get(i) for i in items]
        vecs = [v for v in vecs if v is not None]
        if not vecs:
            return None
        m = np.stack(vecs)
        norms = np.linalg.norm(m, axis=1, keepdims=True)
        norms[norms == 0] = 1
        return (m / norms).mean(axis=0)

    def most_popular_items(self, how_many: int, rescorer=None) -> list[tuple[str, int]]:
        counts: dict[str, int] = {}
        for items in self.state.known_items_snapshot().values():
            for i in items:
                counts[i] = counts.get(i, 0) + 1
        out = [
            (i, c) for i, c in counts.items()
            if rescorer is None or not rescorer.is_filtered(i)
        ]
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:how_many]

    def representative_items(self, how_many: int) -> list[str]:
        """A spread of items across the factor space. With LSH enabled this
        is the reference's one-item-per-partition sample
        (PopularRepresentativeItems), entirely on the host; otherwise an
        even stride over the store serves the same diverse-sample
        purpose."""
        if self.sample_rate < 1.0:
            _lsh, ids, parts, _pindex = self._lsh_index()
            if not ids:
                return []
            _, first_rows = np.unique(parts, return_index=True)
            return [ids[int(r)] for r in first_rows[:how_many]]
        ids = self._y_view_full()[1]
        if not ids:
            return []
        stride = max(1, len(ids) // how_many)
        return list(ids[::stride][:how_many])

    def most_active_users(self, how_many: int) -> list[tuple[str, int]]:
        out = [(u, len(s)) for u, s in self.state.known_items_snapshot().items()]
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:how_many]


def _trim_pairs(
    vals, idx, ids, how_many: int, exclude: set[str], rescorer
) -> list[tuple[str, float]]:
    """Ranked (id, score) pairs after exclusion filtering and optional
    rescoring (the reference's per-request filter/rescore pass)."""
    out: list[tuple[str, float]] = []
    for v, j in zip(np.asarray(vals), np.asarray(idx)):
        ident = ids[int(j)]
        if ident in exclude:
            continue
        score = float(v)
        if rescorer is not None:
            if rescorer.is_filtered(ident):
                continue
            score = rescorer.rescore(ident, score)
            if score is None or np.isnan(score):
                continue
        out.append((ident, score))
        if len(out) == how_many and rescorer is None:
            break
    if rescorer is not None:
        out.sort(key=lambda t: -t[1])
        out = out[:how_many]
    return out


def _rerank_exact(user_vector, vals, idx, host_mat: np.ndarray, cosine: bool):
    """Recompute candidate scores with one vectorized f32 gather against
    the host matrix row-aligned with the device view, and re-sort."""
    idx = np.asarray(idx)
    uv = np.asarray(user_vector, dtype=np.float32)
    rows = host_mat[idx]
    vals = rows @ uv
    if cosine:
        vals = vals / np.maximum(np.linalg.norm(rows, axis=1), 1e-12)
    order = np.argsort(-vals, kind="stable")
    return vals[order], idx[order]


class ALSServingModelManager(AbstractServingModelManager):
    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.als = ALSConfig.from_config(config)
        self.sync = SyncConfig.from_config(config)
        # validated here so a typo fails at startup, not on the first
        # /recommend
        self.score_mode = str(config.get("oryx.serving.api.score-mode", "exact"))
        if self.score_mode not in SCORE_MODES:
            raise ValueError(
                "oryx.serving.api.score-mode must be one of "
                f"{SCORE_MODES}, got {self.score_mode!r}"
            )
        # the load fraction at which the listener builds a model's device
        # view (the readiness gate, ServingApp.get_serving_model)
        self.min_fraction = config.get_float(
            "oryx.serving.min-model-load-fraction", 0.8
        )
        self._model: ALSServingModel | None = None
        self._rescorer_provider = _load_rescorer_provider(config)
        configure_post_pool(config.get_int("oryx.serving.api.post-workers", 8))

    @property
    def model(self) -> ALSServingModel | None:
        return self._model

    @model.setter
    def model(self, model: ALSServingModel | None) -> None:
        """Install the served model. A model installed outside the update
        listener (``manager.model = ALSServingModel(state)``) gets its
        scoring view here, on the installing thread, once enough of it
        has loaded to serve: readiness then never waits on a build that
        only the listener would have started."""
        if (model is not None and model._scoring_view() is None
                and model.state.fraction_loaded() >= self.min_fraction):
            model.build_views()
        self._model = model

    def get_model(self) -> ALSServingModel | None:
        return self._model

    def rescorer_provider(self):
        return self._rescorer_provider

    def consume_key_message(self, key: str | None, message: str) -> None:
        """Apply one update-topic message. A new model's device view is
        built here, on the listener's thread, once enough of it has loaded
        to serve, and before it replaces the served model: requests keep
        the old model meanwhile, and readiness waits for the view."""
        old = self.model
        prev = old.state if old is not None else None
        state = apply_update_message(prev, key, message, with_known_items=True)
        if state is None:
            return
        model = old
        if state is not prev:
            model = ALSServingModel(
                state,
                approx_recall=self.als.approx_recall,
                sync=self.sync,
                score_mode=self.score_mode,
                device=self.device,
                sample_rate=self.als.sample_rate,
                num_cores=(self.als.candidate_partitions or None),
                lsh_max_bits_differing=self.als.lsh_max_bits_differing,
            )
        if (model._scoring_view() is None
                and state.fraction_loaded() >= self.min_fraction):
            model.build_views()
        if model is not old:
            self.model = model
            if old is not None:
                old.close()  # stop the replaced model's resync thread

    def close(self) -> None:
        if self._model is not None:
            self._model.close()


def _load_rescorer_provider(config: Config):
    """Optional result-rescoring plugin, config-named like the reference's
    oryx.als.rescorer-provider-class (ALSServingModelManager.java:147-180)."""
    name = config.get_string("oryx.als.rescorer-provider-class", None)
    if not name:
        return None
    return load_instance_of(name)
