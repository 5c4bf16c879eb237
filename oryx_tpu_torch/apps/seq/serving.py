"""Seq serving tier: GRU session encoder + top-k over item embeddings (the
port's counterpart of oryx_tpu/apps/seq/serving.py).

The request path is the ALS shape on purpose: encode the session's item
history into a hidden state (the "user vector") on the model's device, then
score the whole catalog with ONE fused product + top-k through the shared
micro-batcher (serving/batcher.py -> ops/als.py topk_dot_batch: on the card
the hand-written bf16 partial kernel and the merge for k <= 128), followed by
an exact f32 re-rank of the candidates on the host.

The device view follows the port's ALS design (apps/als/serving.py): a
bf16 upload of the live rows only (``staged_device_put``), kept in step with
the FactorStore by dirty-row deltas (``scatter_rows(..., n_rows)`` grows the
copy for appended rows), beside a capacity-padded f32 host mirror for the
re-rank. No padding row is ever scored, so the JAX package's pad backstop
has nothing to do here. The manager builds a new model's view on the update
listener's thread once enough of it has loaded, and readiness waits for
it; later drift catches up on the first query that sees it, under the sync
lock, as in the JAX package. Not ported yet: sharded views (ROADMAP queue 1
item 11).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from oryx_tpu_torch.api import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.apps.als.serving import SyncConfig, _rerank_exact
from oryx_tpu_torch.apps.seq.common import SeqConfig
from oryx_tpu_torch.apps.seq.state import SeqState, apply_seq_update
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.qualitystats import get_qualitystats
from oryx_tpu_torch.common.tracing import current_span
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.seq import encode_vectors, gru_from_numpy
from oryx_tpu_torch.ops.topk import check_features
from oryx_tpu_torch.ops.transfer import (
    row_capacity,
    scatter_rows,
    scatter_transfer_bytes,
    staged_device_put,
)
from oryx_tpu_torch.serving.app import chain_future, configure_post_pool, post_pool
from oryx_tpu_torch.serving.batcher import TopKBatcher
from oryx_tpu_torch.serving.viewsync import (
    extend_view_ids,
    note_sync_bytes,
    view_sync_metrics,
)


class SeqServingModel(ServingModel):
    def __init__(self, state: SeqState, sync: SyncConfig | None = None,
                 device=None):
        self.state = state
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the kernel's widest rows: a model too wide for it fails here,
            # once, and not on every request
            check_features(state.dim, torch.bfloat16)
        self.sync = sync or SyncConfig()
        self._sync_lock = threading.Lock()
        # (device E [n,d] bf16, ids [n], version, host f32 mirror
        # [capacity,d]) swapped as ONE tuple: readers take the snapshot
        # lock-free
        self._device_view: tuple | None = None  # guarded-by: _sync_lock (writes)
        # (state.params it was made from, the same weights on the device)
        self._params_dev: tuple | None = None

    def fraction_loaded(self) -> float:
        """The announced model's loaded fraction, and 0 until its device
        view exists (the manager builds it on the listener's thread, or on
        the thread that installs the model)."""
        if self._device_view is None:
            return 0.0
        return self.state.fraction_loaded()

    def served_version(self) -> int | None:
        view = self._device_view
        return None if view is None else view[2]

    # -- device view (FactorStore delta sync) ------------------------------

    def build_view(self) -> None:
        """Build the device view now instead of on the first query."""
        self._view()

    def _view(self) -> tuple:
        view = self._device_view
        if view is not None and view[2] == self.state.items.get_version():
            return view
        with self._sync_lock:
            view = self._device_view
            if view is not None and view[2] == self.state.items.get_version():
                return view
            if view is not None and self._try_apply_delta(view):
                return self._device_view
            return self._build_view_full()

    def _note_resync(self, kind: str, n_bytes: int, t0: float) -> None:
        m_bytes, m_secs, m_total = view_sync_metrics()[:3]
        note_sync_bytes(m_bytes, n_bytes, None)
        m_secs.observe(time.monotonic() - t0)
        m_total.inc(kind=kind)

    def _try_apply_delta(self, view: tuple) -> bool:  # holds _sync_lock
        """Catch the device view up by dirty-row scatter. Returns False when
        only a full rebuild can serve (drift overflow, growth past the host
        mirror's capacity, arena compaction after a model swap). Not in
        place: in-flight coalesced dispatches still score the old buffer."""
        t0 = time.monotonic()
        y_dev, ids, version, host_mat = view
        n_old = len(ids)
        delta = self.state.items.delta_since(
            version,
            max_rows=max(1, int(self.sync.max_delta_fraction * max(n_old, 1))),
        )
        if delta is None or delta.n > int(host_mat.shape[0]):
            return False
        if delta.rows.size == 0:
            return True  # raced an already-applied version
        ids = extend_view_ids(ids, delta)
        if ids is None:
            return False
        host_mat[delta.rows] = delta.mat
        y_new = scatter_rows(y_dev, delta.rows, delta.mat, len(ids))
        self._device_view = (y_new, ids, delta.version, host_mat)
        self._note_resync(
            "delta", scatter_transfer_bytes(delta.rows.size, 2, self.state.dim), t0)
        return True

    def _build_view_full(self) -> tuple:  # holds _sync_lock
        """Initial load / delta-overflow fallback: one bf16 upload of the
        live rows, and a capacity-padded f32 host mirror."""
        t0 = time.monotonic()
        mat, ids, version = self.state.items.snapshot()
        mat = np.asarray(mat, dtype=np.float32)
        n = len(ids)
        cap = row_capacity(n, self.sync.capacity_headroom)
        host = np.zeros((cap, self.state.dim), dtype=np.float32)
        host[:n] = mat
        y_dev = staged_device_put(mat, dtype=torch.bfloat16, device=self.device)
        view = (y_dev, ids, version, host)
        self._device_view = view
        self._note_resync("full", n * self.state.dim * 2, t0)
        return view

    # -- queries -----------------------------------------------------------

    def _device_params(self) -> dict:
        """The recurrent weights on the model's device, uploaded once per
        weight set (a MODEL of the same width swaps state.params)."""
        src = self.state.params
        cached = self._params_dev
        if cached is None or cached[0] is not src:
            cached = (src, gru_from_numpy(None, src, self.device))
            self._params_dev = cached
        return cached[1]

    def encode(self, context_items: list[str]) -> np.ndarray | None:
        """Session item history (oldest -> newest) -> hidden state, or
        None when no context item is known to the model."""
        if not context_items or self.state.params is None:
            return None
        ctx = context_items[-self.state.window:]
        vecs, have = self.state.items.get_many(ctx)
        if not have.any():
            return None
        # left-pad to the fixed window, as the JAX package does
        w = self.state.window
        mat = np.zeros((1, w, self.state.dim), dtype=np.float32)
        mask = np.zeros((1, w), dtype=np.float32)
        mat[0, w - len(ctx):] = vecs
        mask[0, w - len(ctx):] = have.astype(np.float32)
        h = encode_vectors(
            self._device_params(),
            torch.from_numpy(mat).to(self.device),
            torch.from_numpy(mask).to(self.device),
        )
        return h[0].cpu().numpy()

    def next_items_async(
        self,
        context_items: list[str],
        how_many: int,
        exclude: set[str] = frozenset(),
    ) -> Future:
        """Top next items for a session context, excluding the session's
        own history: a Future, so the deferred endpoint holds no worker
        thread while the coalesced device dispatch is in flight."""
        out: Future = Future()
        try:
            h = self.encode(context_items)
            if h is not None:
                y_dev, ids, _version, host_mat = self._view()
        except Exception as e:  # carried to the caller
            out.set_exception(e)
            return out
        if h is None:
            out.set_result(None)  # no known context item: 404 at the route
            return out
        n = len(ids)
        if n == 0:
            out.set_result([])
            return out
        span = current_span()
        trace_id = span.trace_id if span is not None else None
        k = min(n, how_many + len(exclude) + 8)
        fut = TopKBatcher.shared().submit_nowait(h, k, y_dev)

        def _post(result):
            # the device selects in bf16; the candidates are re-ranked
            # exactly against the row-aligned f32 host mirror
            vals, idx = _rerank_exact(h, result[0], result[1], host_mat, False)
            pairs = []
            for v, j in zip(vals, idx):
                ident = ids[int(j)]
                if ident in exclude:
                    continue
                pairs.append([ident, float(v)])
                if len(pairs) == how_many:
                    break
            if pairs:
                # live recall: offer the served page to the shadow rescore
                # sampler (post-pool thread, never the batcher dispatcher)
                get_qualitystats().maybe_sample(
                    h, pairs, how_many=how_many, exclude=exclude,
                    score_mode="exact", trace_id=trace_id,
                    snapshot_fn=lambda: (host_mat, ids, n),
                )
            return pairs

        return chain_future(fut, _post, executor=post_pool())

    def next_items(
        self,
        context_items: list[str],
        how_many: int,
        exclude: set[str] = frozenset(),
    ):
        return self.next_items_async(context_items, how_many, exclude).result()


class SeqServingModelManager(AbstractServingModelManager):
    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.seq = SeqConfig.from_config(config)
        self.sync = SyncConfig.from_config(config)
        # the load fraction at which the listener builds a model's device
        # view (the readiness gate, ServingApp.get_serving_model)
        self.min_fraction = config.get_float(
            "oryx.serving.min-model-load-fraction", 0.8
        )
        self._model: SeqServingModel | None = None
        configure_post_pool(
            config.get_int("oryx.serving.api.post-workers", 8)
        )

    @property
    def model(self) -> SeqServingModel | None:
        return self._model

    @model.setter
    def model(self, model: SeqServingModel | None) -> None:
        """Install the served model. A model installed outside the update
        listener gets its device view here, on the installing thread, once
        enough of it has loaded to serve."""
        if (model is not None and model._device_view is None
                and model.state.fraction_loaded() >= self.min_fraction):
            model.build_view()
        self._model = model

    def get_model(self) -> SeqServingModel | None:
        return self._model

    def consume_key_message(self, key: str | None, message: str) -> None:
        """Apply one update-topic message. A new model's device view is
        built here, on the listener's thread, once enough of it has loaded
        to serve, and before it replaces the served model."""
        old = self.model
        prev = old.state if old is not None else None
        state = apply_seq_update(prev, key, message)
        if state is None:
            return
        model = old
        if state is not prev:
            model = SeqServingModel(state, sync=self.sync, device=self.device)
        if (model._device_view is None
                and state.fraction_loaded() >= self.min_fraction):
            model.build_view()
        if model is not old:
            self.model = model
