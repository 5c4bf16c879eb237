"""ALS serving tier: device factor view + query methods + manager (the
port's counterpart of oryx_tpu/apps/als/serving.py).

Mirrors ALSServingModel/ALSServingModelManager (app/oryx-app-serving
.../als/model/ALSServingModel.java:96-409, ALSServingModelManager.java:
69-182). The reference partitions Y by LSH bucket and fans requests over a
thread pool; here the whole Y store is one device matrix and top-N is one
coalesced fused score + top-k dispatch (serving/batcher.py -> ops/topk.py),
followed by an exact f32 re-rank of the candidates on the host.

Every resync reports into the shared ``oryx_device_sync_*`` /
``oryx_view_resync_total`` families (serving/viewsync.py) and, with tracing
on, a ``view.resync`` span. Not ported yet: LSH candidate sampling
(sample-rate < 1, ROADMAP queue 1 item 4), shadow quality sampling (item
4), sharded and chunked views (item 11).
"""

from __future__ import annotations

import logging
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
from oryx_tpu_torch.common.tracing import get_tracer
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
        """The announced model's loaded fraction, and 0 until the scoring
        view exists on the model's device: the manager builds it on the
        update listener's thread, so /ready never answers 200 for a model
        whose first request would have to build it."""
        if self._device_view is None:
            return 0.0
        return self.state.fraction_loaded()

    def build_views(self) -> None:
        """Build the device scoring view now instead of on the first
        query."""
        self._y_view_full()

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
        dv = self._device_view
        if dv is not None and dv[2] != self.state.y.get_version():
            return True
        uv = self._unit_view
        return dv is not None and uv is not None and uv[2] != dv[2]

    def _resync_loop(self) -> None:
        while not self._stop.is_set():
            self._resync_evt.wait(_RESYNC_POLL_S)
            self._resync_evt.clear()
            if self._stop.is_set():
                return
            try:
                while not self._stop.is_set() and self._views_stale():
                    self._resync_once()
            except Exception:
                log.exception("background view resync failed")
                # don't spin on a persistent failure (e.g. device OOM);
                # queries keep serving the last consistent snapshot
                time.sleep(0.5)

    def _resync_once(self) -> None:
        """Bring every materialized view up to the current store version:
        dirty-row deltas when the drift is small (mode delta), snapshot
        rebuilds otherwise. Swaps are atomic tuple stores under
        _sync_lock."""
        with self._sync_lock:
            dv = self._device_view
            if dv is not None and dv[2] != self.state.y.get_version():
                if not (self.sync.mode == "delta" and self._try_apply_delta(dv)):
                    self._build_views_full()
            dv, uv = self._device_view, self._unit_view
            if dv is not None and uv is not None and uv[2] != dv[2]:
                self._build_unit_view(*dv)

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

    # -- queries -----------------------------------------------------------

    def _top_n_plan(self, user_vector, how_many, exclude, rescorer, cosine):
        """Shared front half of top_n/top_n_async: ("done", pairs) when
        nothing needs scoring, or ("fut", batcher_future, post_fn)."""
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
            return _trim_pairs(vals, idx, ids, how_many, exclude, rescorer)

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
        """An even stride over the store: a diverse item sample."""
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
        if self.als.sample_rate < 1.0:
            raise ValueError(
                "oryx.als.sample-rate < 1 (LSH candidate sampling) is not "
                "ported yet"
            )
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
        self.model: ALSServingModel | None = None
        self._rescorer_provider = _load_rescorer_provider(config)
        configure_post_pool(config.get_int("oryx.serving.api.post-workers", 8))

    def get_model(self) -> ALSServingModel | None:
        return self.model

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
            )
        if (model._device_view is None
                and state.fraction_loaded() >= self.min_fraction):
            model.build_views()
        if model is not old:
            self.model = model
            if old is not None:
                old.close()  # stop the replaced model's resync thread

    def close(self) -> None:
        if self.model is not None:
            self.model.close()


def _load_rescorer_provider(config: Config):
    """Optional result-rescoring plugin, config-named like the reference's
    oryx.als.rescorer-provider-class (ALSServingModelManager.java:147-180)."""
    name = config.get_string("oryx.als.rescorer-provider-class", None)
    if not name:
        return None
    return load_instance_of(name)
