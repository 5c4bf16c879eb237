"""Seq batch tier: windowed next-item GRU builds per generation (the port's
copy of oryx_tpu/apps/seq/batch.py; the GRU trains and evaluates on the
update's device).

Rides the shared MLUpdate harness (ml/update.py) exactly like ALS:
temporal holdout split (shared split_by_time), from-scratch candidate
builds, AND the incremental-generation machinery — a mergeable
per-session aggregate snapshot persisted between generations, so a
steady-state generation parses only its new window, merges it into the
session log, warm-starts the GRU from the previous generation's
embeddings (ops/als.py align_factors — the id-table alignment is
model-agnostic) and early-stops on prediction convergence.

Published artifacts are the ALS skeleton pattern: the MODEL message
carries the small recurrent weights inline plus the expected item-id
list; the embedding matrix streams row-by-row as UP ["E", id, [vec]]
messages so speed/serving rebuild it incrementally and the serving
device view syncs by dirty-row scatter.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Sequence

import numpy as np

from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer
from oryx_tpu_torch.common.artifact import ModelArtifact
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.tracing import get_tracer
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ml.update import MLUpdate, split_by_time
from oryx_tpu_torch.ops.als import align_factors
from oryx_tpu_torch.ops.seq import GRU_PARAM_NAMES, next_item_hit_rate, train_gru
from oryx_tpu_torch.apps.seq.common import (
    SeqConfig,
    item_sequences,
    parse_session_events,
    sessionize,
    valid_session_line,
    valid_session_lines,
    windowed_examples,
)
from oryx_tpu_torch.apps.updates import batch_update_messages

log = logging.getLogger(__name__)

# hit-rate@k the batch eval reports (also the quality gate's k)
EVAL_K = 10

_AGG_FINGERPRINT_VERSION = 1


class SeqAggregateState:
    """Mergeable per-session event log — the seq analogue of ALS's
    AggregateState: merge(new window) is order-insensitive up to
    the per-session (ts, item) sort + dedup + newest-N cap it re-applies,
    so generation N folds only its window instead of re-reading history."""

    def __init__(self, sessions: dict[str, list[tuple[int, str]]], max_events: int):
        self.sessions = sessions
        self.max_events = max_events

    @property
    def entries(self) -> int:
        return sum(len(v) for v in self.sessions.values())

    @staticmethod
    def empty(max_events: int) -> "SeqAggregateState":
        return SeqAggregateState({}, max_events)

    @staticmethod
    def from_events(users, sess, items, tss, max_events: int) -> "SeqAggregateState":
        return SeqAggregateState(
            sessionize(users, sess, items, tss, max_events=max_events), max_events
        )

    def merge(self, other: "SeqAggregateState") -> "SeqAggregateState":
        from oryx_tpu_torch.apps.seq.common import sort_dedup_cap

        merged: dict[str, list[tuple[int, str]]] = {
            k: list(v) for k, v in self.sessions.items()
        }
        for k, evs in other.sessions.items():
            merged.setdefault(k, []).extend(evs)
        out = {
            k: sort_dedup_cap(evs, self.max_events)
            for k, evs in merged.items()
        }
        return SeqAggregateState(out, self.max_events)

    def to_arrays(self) -> dict:
        keys = sorted(self.sessions)
        counts = np.asarray([len(self.sessions[k]) for k in keys], dtype=np.int64)
        items: list[str] = []
        tss: list[int] = []
        for k in keys:
            for t, i in self.sessions[k]:
                items.append(i)
                tss.append(t)
        return {
            "session_keys": np.asarray(keys, dtype=str) if keys else np.zeros(0, "<U1"),
            "session_counts": counts,
            "event_items": np.asarray(items, dtype=str) if items else np.zeros(0, "<U1"),
            "event_tss": np.asarray(tss, dtype=np.int64),
        }

    @staticmethod
    def from_arrays(arrays: dict, max_events: int) -> "SeqAggregateState":
        keys = [str(k) for k in arrays["session_keys"]]
        counts = np.asarray(arrays["session_counts"], dtype=np.int64)
        items = [str(i) for i in arrays["event_items"]]
        tss = np.asarray(arrays["event_tss"], dtype=np.int64)
        sessions: dict[str, list[tuple[int, str]]] = {}
        pos = 0
        for k, c in zip(keys, counts):
            sessions[k] = [
                (int(tss[j]), items[j]) for j in range(pos, pos + int(c))
            ]
            pos += int(c)
        return SeqAggregateState(sessions, max_events)


class SeqUpdate(MLUpdate):
    def __init__(self, config: Config, device=None):
        super().__init__(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        self.seq = SeqConfig.from_config(config)
        self.data_dir = config.get_string("oryx.batch.storage.data-dir", None)
        self.warm_start = config.get_bool("oryx.batch.train.warm-start", True)
        self.train_tol = config.get_float("oryx.batch.train.tol", 0.02)
        self.train_min_iterations = config.get_int(
            "oryx.batch.train.min-iterations", 2
        )
        self.train_check_every = config.get_int("oryx.batch.train.check-every", 2)
        self.max_drift_fraction = config.get_float(
            "oryx.batch.storage.incremental.max-drift-fraction", 0.5
        )
        self.snapshots_kept = config.get_int(
            "oryx.batch.storage.incremental.snapshots-kept", 2
        )
        self._agg_state: SeqAggregateState | None = None
        self._agg_pending = None  # holdout (users, sessions, items, tss)
        self._agg_through_ts: int | None = None
        self._staged_state: SeqAggregateState | None = None
        self._staged_pending = None
        self._staged_ts: int | None = None
        self._prev_item_ids: list | None = None
        self._prev_e: np.ndarray | None = None
        self._prev_params: dict | None = None
        reg = get_registry()
        self._m_agg_sessions = reg.gauge(
            "oryx_seq_aggregate_sessions",
            "Sessions tracked by the persistent seq batch aggregate (0 "
            "until the first incremental generation)",
        )
        self._m_epochs = reg.gauge(
            "oryx_seq_train_epochs",
            "GRU training epochs actually run by the last seq batch "
            "generation (prediction-convergence early stop; equals the "
            "configured epoch count on cold starts)",
        )

    # ---- SPI hooks -------------------------------------------------------

    def validate_record(self, km) -> bool:
        return valid_session_line(km.message)

    def validate_records(self, records):
        return valid_session_lines(km.message for km in records)

    def hyperparam_ranges(self) -> dict[str, Any]:
        return {"dim": self.seq.dim, "lr": self.seq.lr}

    def split_train_test(self, data: Sequence[KeyMessage]):
        """Temporal holdout: the newest test-fraction of session events
        (token 3 is the timestamp) — next-item prediction on the future,
        never a random shuffle that would leak later clicks into train."""
        return split_by_time(data, self.test_fraction, super().split_train_test)

    # ---- building --------------------------------------------------------

    def _train_from_sessions(
        self, sessions: dict[str, list[str]], hyperparams: dict[str, Any],
        warm: bool = False,
    ):
        """sessions (item lists) -> (GruModel, epochs, vocab). Raises when
        nothing is trainable (the harness treats that as a failed
        candidate)."""
        vocab = sorted({i for its in sessions.values() for i in its})
        if not vocab:
            raise ValueError("no parseable session events")
        item_to_row = {i: r for r, i in enumerate(vocab)}
        contexts, mask, targets = windowed_examples(
            sessions, item_to_row, self.seq.window, self.seq.min_session_length
        )
        if len(targets) == 0:
            raise ValueError(
                "no next-item training examples (all sessions below "
                "oryx.seq.min-session-length)"
            )
        dim = int(hyperparams.get("dim", self.seq.dim))
        resume_e = resume_params = None
        if warm and self.warm_start:
            resume_e = align_factors(
                self._prev_item_ids, self._prev_e, vocab, dim
            )
            if resume_e is not None:
                resume_params = self._prev_params
        model, epochs = train_gru(
            contexts, mask, targets,
            n_items=len(vocab), dim=dim, item_ids=vocab,
            epochs=self.seq.epochs,
            lr=float(hyperparams.get("lr", self.seq.lr)),
            batch=self.seq.batch,
            resume_e=resume_e,
            resume_params=resume_params,
            tol=self.train_tol if resume_e is not None else 0.0,
            min_epochs=self.train_min_iterations,
            check_every=self.train_check_every,
            device=self.device,
        )
        self._m_epochs.set(epochs)
        return model, epochs, vocab

    def eval_metric_name(self) -> str:
        return "hit_rate_at_10"

    def _artifact_from_model(self, model, hyperparams: dict[str, Any]) -> ModelArtifact:
        art = ModelArtifact(
            "seq",
            extensions={
                "dim": str(int(hyperparams.get("dim", self.seq.dim))),
                "window": str(self.seq.window),
            },
            tensors={"E": model.e, **model.params},
        )
        art.set_extension("ItemIDs", list(model.item_ids))
        self._attach_quality_profile(art, model)
        return art

    def _attach_quality_profile(self, art: ModelArtifact, model) -> None:
        """Stamp the generation's training profile (the ALS pattern,
        apps/als/batch.py): the window's item-event sketch + event rate,
        new-item fraction vs the previous generation's vocabulary, and a
        sample of hidden-state·Eᵀ scores for prediction-drift. Never
        fails a build."""
        try:
            from oryx_tpu_torch.common.qualitystats import build_training_profile

            items, tss = getattr(self, "_window_events", (None, None))
            if items is None or len(items) == 0:
                return
            e = np.asarray(model.e)
            scores = None
            if len(e):
                # same statistic as the live side (mean of served top-k):
                # sampled embedding rows stand in for hidden states (the
                # speed tier blends targets toward h with magnitudes
                # matched to trained row norms, so e-rows are the honest
                # cheap proxy), scored over the whole vocabulary
                rng = np.random.default_rng(7)
                h = e[rng.integers(0, len(e), 32)]
                k = min(10, len(e))
                full = h @ e.T
                part = -np.partition(-full, k - 1, axis=1)[:, :k]
                scores = part.mean(axis=1)
            profile = build_training_profile(
                items,
                timestamps_ms=tss,
                prev_item_ids=self._prev_item_ids,
                scores=scores,
            )
            art.set_extension("qualityProfile", profile.to_json())
        except Exception:  # noqa: BLE001 - the profile must never fail a build
            log.warning("seq quality profile build failed", exc_info=True)

    def build_model(
        self, train: Sequence[KeyMessage], hyperparams: dict[str, Any]
    ) -> ModelArtifact:
        users, sess, items, tss = parse_session_events(train)
        self._window_events = (items, tss)  # quality-profile window inputs
        sessions = item_sequences(
            sessionize(users, sess, items, tss,
                       max_events=self.seq.max_session_events)
        )
        model, _epochs, _vocab = self._train_from_sessions(sessions, hyperparams)
        return self._artifact_from_model(model, hyperparams)

    def evaluate(self, model: ModelArtifact, train, test) -> float:
        """Hit-rate@10 of the held-out next-item events: each test event
        is predicted from the session context that precedes it (train
        events plus earlier test events of the same session)."""
        contexts, mask, targets = self._eval_examples(model, train, test)
        if len(targets) == 0:
            return float("nan")
        params = {k: model.tensors[k] for k in GRU_PARAM_NAMES}
        return next_item_hit_rate(
            model.tensors["E"], params, contexts, mask, targets, k=EVAL_K,
            device=self.device,
        )

    def _eval_examples(self, model: ModelArtifact, train, test):
        item_ids = model.get_extension_list("ItemIDs")
        item_to_row = {i: r for r, i in enumerate(item_ids)}
        window = int(model.get_extension("window", self.seq.window))
        tr_u, tr_s, tr_i, tr_t = parse_session_events(train)
        te_u, te_s, te_i, te_t = parse_session_events(test)
        # combined per-session order, train events first on ts ties (the
        # holdout is the newest slice, so ties resolve train-before-test)
        sessions = sessionize(
            np.concatenate([tr_u, te_u]), np.concatenate([tr_s, te_s]),
            np.concatenate([tr_i, te_i]), np.concatenate([tr_t, te_t]),
            max_events=self.seq.max_session_events,
        )
        test_events = set(zip(
            (str(u) for u in te_u), (str(s) for s in te_s),
            (str(i) for i in te_i), (int(t) for t in te_t),
        ))
        from oryx_tpu_torch.apps.seq.common import SESSION_KEY_SEP

        ctx_rows, tgt_rows = [], []
        for key, evs in sessions.items():
            user, sess_id = key.split(SESSION_KEY_SEP, 1)
            rows = [item_to_row.get(i, -1) for _, i in evs]
            for j in range(1, len(evs)):
                t, i = evs[j]
                if (user, sess_id, i, t) not in test_events:
                    continue
                if rows[j] < 0:
                    continue
                ctx = rows[max(0, j - window) : j]
                if any(r < 0 for r in ctx):
                    continue
                ctx_rows.append(ctx)
                tgt_rows.append(rows[j])
        from oryx_tpu_torch.apps.seq.common import pad_examples

        return pad_examples(ctx_rows, tgt_rows, window)

    # ---- publication (skeleton + UP row flood) ---------------------------

    def publish_model(
        self, model: ModelArtifact, model_path: str, producer: TopicProducer
    ) -> None:
        """MODEL carries the small recurrent weights inline plus the
        expected item ids; the embedding matrix streams separately as UP
        rows (publish_additional_model_data) so consumers rebuild it
        incrementally — the ALS skeleton pattern."""
        from oryx_tpu_torch.common.artifact import publish_model_ref

        skeleton = ModelArtifact(
            "seq", dict(model.extensions), {},
            tensors={k: model.tensors[k] for k in GRU_PARAM_NAMES},
        )
        serialized = skeleton.to_string()
        if len(serialized.encode("utf-8")) <= self.max_message_size:
            producer.send("MODEL", serialized)
        else:
            publish_model_ref(
                producer, serialized, model_path, self.max_message_size,
                transfer=self.artifact_transfer,
            )
        self.send_publish_stamp(model_path, producer)

    def publish_additional_model_data(
        self, model: ModelArtifact, model_path: str, producer: TopicProducer
    ) -> None:
        ids = model.get_extension_list("ItemIDs")
        e = model.tensors["E"]

        def chunks():
            step = 8192
            for lo in range(0, len(ids), step):
                part = ids[lo : lo + step]
                block = np.asarray(e[lo : lo + len(part)])
                finite = np.isfinite(block).all(axis=1)
                if not finite.all():
                    rows = np.nonzero(finite)[0]
                    part = [part[j] for j in rows]
                    block = block[rows]
                yield from batch_update_messages("E", part, block)

        producer.send_batch(chunks())
        log.info("published %d seq item-embedding rows", len(ids))

    # ---- incremental generations -------------------------------------------

    @property
    def _fingerprint(self) -> str:
        return (
            f"seq:v{_AGG_FINGERPRINT_VERSION}:w{self.seq.window}"
            f":cap{self.seq.max_session_events}"
        )

    def _parse_to_str(self, data):
        users, sess, items, tss = parse_session_events(data)
        return (
            np.asarray(users, dtype=str),
            np.asarray(sess, dtype=str),
            np.asarray(items, dtype=str),
            tss,
        )

    def _load_snapshot(self):
        from oryx_tpu_torch.layers.datastore import (
            latest_generation_ts,
            load_aggregate_snapshot,
        )

        if not self.data_dir:
            return None
        loaded = load_aggregate_snapshot(self.data_dir, self._fingerprint)
        if loaded is None:
            return None
        through_ts, arrays = loaded
        newest = latest_generation_ts(self.data_dir)
        if newest is not None and newest > through_ts:
            log.info(
                "seq aggregate snapshot through %d older than persisted "
                "generation %d; full rebuild", through_ts, newest,
            )
            return None
        try:
            state = SeqAggregateState.from_arrays(
                arrays, self.seq.max_session_events
            )
            pending = (
                np.asarray(arrays["pending_users"], dtype=str),
                np.asarray(arrays["pending_sessions"], dtype=str),
                np.asarray(arrays["pending_items"], dtype=str),
                np.asarray(arrays["pending_tss"], dtype=np.int64),
            )
        except KeyError:
            return None
        return state, pending

    def _snapshot_arrays(self, state: SeqAggregateState, pending) -> dict:
        arrays = state.to_arrays()
        users, sess, items, tss = pending
        arrays["pending_users"] = users if users.size else np.zeros(0, "<U1")
        arrays["pending_sessions"] = sess if sess.size else np.zeros(0, "<U1")
        arrays["pending_items"] = items if items.size else np.zeros(0, "<U1")
        arrays["pending_tss"] = tss.astype(np.int64)
        return arrays

    def _persist_snapshot(self, timestamp_ms: int, state, pending) -> None:
        from oryx_tpu_torch.layers.datastore import save_aggregate_snapshot

        if not self.data_dir:
            return
        save_aggregate_snapshot(
            self.data_dir, timestamp_ms, self._fingerprint,
            self._snapshot_arrays(state, pending), keep=self.snapshots_kept,
            staged=True,
        )

    def _memory_state_fresh(self) -> bool:
        from oryx_tpu_torch.layers.datastore import latest_generation_ts

        if not self.data_dir or self._agg_through_ts is None:
            return False
        newest = latest_generation_ts(self.data_dir)
        return newest is None or newest <= self._agg_through_ts

    def _set_state(self, state, pending, timestamp_ms: int, persisted=False) -> None:
        """Stage the folded state; finalize_generation promotes it once
        the batch layer persisted + committed the window (the
        crash-between-snapshot-and-persist discipline)."""
        self._staged_state = state
        self._staged_pending = pending
        self._staged_ts = timestamp_ms
        if not persisted:
            self._persist_snapshot(timestamp_ms, state, pending)

    def finalize_generation(self, timestamp_ms: int) -> None:
        from oryx_tpu_torch.layers.datastore import finalize_aggregate_snapshot

        if self._staged_ts != timestamp_ms or self._staged_state is None:
            return
        self._agg_state = self._staged_state
        self._agg_pending = self._staged_pending
        self._agg_through_ts = timestamp_ms
        self._staged_state = self._staged_pending = None
        self._staged_ts = None
        if self.data_dir:
            try:
                finalize_aggregate_snapshot(
                    self.data_dir, timestamp_ms, keep=self.snapshots_kept
                )
            except Exception:  # noqa: BLE001 - next generation rebuilds
                log.exception("seq aggregate snapshot finalize failed")

    def incremental_update(
        self,
        timestamp_ms: int,
        new_data,
        model_dir: str,
        update_producer: TopicProducer,
    ) -> bool:
        """One O(window) generation: merge the new window's events into
        the persisted per-session log, warm-start the GRU from the
        previous generation's embeddings, evaluate on the window's
        temporal holdout, publish, and snapshot — the snapshot write
        overlapping the training scan exactly as ALS does."""
        if self.candidates > 1:
            return False
        if (
            self._agg_state is not None
            and self._memory_state_fresh()
        ):
            state_pending = (self._agg_state, self._agg_pending)
        else:
            state_pending = self._load_snapshot()
        if state_pending is None:
            return False
        state, pending = state_pending
        tr = get_tracer()
        t_merge = time.monotonic()
        train_msgs, test_msgs = self.split_train_test(list(new_data))
        users, sess, items, tss = self._parse_to_str(train_msgs)
        self._window_events = (items, tss)  # quality-profile window inputs
        if pending is not None and len(pending[3]):
            # the previous generation's holdout is persisted history the
            # from-scratch path would train on: fold it in now
            users = np.concatenate([pending[0], users])
            sess = np.concatenate([pending[1], sess])
            items = np.concatenate([pending[2], items])
            tss = np.concatenate([pending[3], tss])
        window = SeqAggregateState.from_events(
            users, sess, items, tss, self.seq.max_session_events
        )
        if state.entries == 0 and window.entries == 0:
            log.info("no data at generation %d; skipping model build", timestamp_ms)
            return True
        if (
            state.entries
            and window.entries > self.max_drift_fraction * state.entries
        ):
            log.info(
                "window carries %d events (> %.0f%% of %d aggregated): "
                "drift past max-drift-fraction; full rebuild",
                window.entries, 100 * self.max_drift_fraction, state.entries,
            )
            self._agg_state = None  # re-anchor from history
            return False
        merged = state.merge(window)
        tr.record_interval(
            "batch.merge", t_merge, window_rows=window.entries,
            aggregate_rows=merged.entries,
        )
        self._m_agg_sessions.set(len(merged.sessions))
        pending_next = self._parse_to_str(test_msgs)
        sessions = item_sequences(merged.sessions)
        hyperparams = {"dim": self.seq.dim, "lr": self.seq.lr}

        # snapshot write overlaps the device training scan (pure host I/O)
        snap_err: list[BaseException] = []

        def _snapshot():
            try:
                self._persist_snapshot(timestamp_ms, merged, pending_next)
            except BaseException as e:  # noqa: BLE001 - surfaced after join
                snap_err.append(e)

        snap_thread = threading.Thread(
            target=_snapshot, name="oryx-seq-agg-snapshot", daemon=True
        )
        snap_thread.start()
        model = None
        try:
            try:
                model, epochs, _vocab = self._train_from_sessions(
                    sessions, hyperparams, warm=True
                )
            except ValueError:
                # merged history still below min-session-length everywhere:
                # nothing trainable yet, but the fold itself must survive —
                # the return happens AFTER the snap_err check below, so a
                # failed snapshot write raises loudly on this path too
                log.info(
                    "generation %d: no trainable seq examples after merge",
                    timestamp_ms,
                )
        finally:
            snap_thread.join()
        if snap_err:
            raise snap_err[0]
        if model is None:
            self._set_state(merged, pending_next, timestamp_ms, persisted=True)
            return True

        art = self._artifact_from_model(model, hyperparams)
        score = (
            self.evaluate(art, train_msgs, test_msgs) if test_msgs else float("nan")
        )
        log.info(
            "incremental seq generation %d: %d sessions / %d events, "
            "%d/%d epochs, hit-rate@%d %s", timestamp_ms,
            len(merged.sessions), merged.entries, epochs, self.seq.epochs,
            EVAL_K, score,
        )
        self._set_state(merged, pending_next, timestamp_ms, persisted=True)
        if (
            self.threshold is not None
            and np.isfinite(score)
            and score < float(self.threshold)
        ):
            log.warning(
                "incremental seq eval %.6f below threshold %s; not "
                "publishing model", score, self.threshold,
            )
            return True

        from pathlib import Path

        from oryx_tpu_torch.common.ioutil import delete_recursively, mkdirs, strip_scheme

        root = Path(strip_scheme(model_dir))
        staged = art.write(mkdirs(root / ".incremental") / str(timestamp_ms))
        self.note_eval(score)  # the stamp carries this generation's hit-rate
        self.promote_and_publish(staged, root, timestamp_ms, update_producer)
        delete_recursively(root / ".incremental")
        self._prev_item_ids = list(model.item_ids)
        self._prev_e = model.e
        self._prev_params = model.params
        return True

    def after_full_build(self, timestamp_ms, train, test, model) -> None:
        """Re-anchor the incremental state after a from-scratch build
        (model is None when the eval threshold withheld publication — the
        window persisted regardless, so the aggregates re-anchor)."""
        try:
            users, sess, items, tss = self._parse_to_str(train)
            state = SeqAggregateState.from_events(
                users, sess, items, tss, self.seq.max_session_events
            )
            pending = self._parse_to_str(test)
            self._set_state(state, pending, timestamp_ms)
            self._m_agg_sessions.set(len(state.sessions))
            self._m_epochs.set(self.seq.epochs)
            if model is not None:
                try:
                    self._prev_item_ids = model.get_extension_list("ItemIDs")
                    self._prev_e = model.tensors.get("E")
                    self._prev_params = {
                        k: model.tensors[k]
                        for k in GRU_PARAM_NAMES
                        if k in model.tensors
                    }
                except Exception:  # noqa: BLE001 - warm start is best-effort
                    self._prev_item_ids = self._prev_e = self._prev_params = None
        except Exception:  # noqa: BLE001 - snapshotting must never fail a
            # published generation; the next generation rebuilds again
            log.exception("seq aggregate snapshot rebuild failed; next "
                          "generation will run a full rebuild")
