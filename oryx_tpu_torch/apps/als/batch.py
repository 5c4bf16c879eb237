"""ALS batch tier: the full model rebuild per generation, trained on the
card (the port's copy of oryx_tpu/apps/als/batch.py).

Replaces the reference's Spark-MLlib pipeline (app/oryx-app-mllib
.../als/ALSUpdate.java): parse events, aggregate with decay/delete
semantics, train ALS (ops/als.py), evaluate (implicit: mean per-user AUC; explicit:
negative RMSE), publish a *skeleton* artifact (hyperparams + expected ID
lists, no tensors — factor matrices are streamed row-by-row as UP messages
through publish_additional_model_data, the reference's
EnqueueFeatureVecsFn pattern at ALSUpdate.java:286-318), and split
train/test by time instead of randomly (ALSUpdate.java:325-342).

Factors come back to the host as numpy float32 before the artifact is
built, so the artifact is the JAX package's, byte for byte, with the
training profile (``qualityProfile``, common/qualitystats.py) the serving
and speed tiers measure drift against. Not ported: multi-device training
(ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import logging
import pathlib
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
from oryx_tpu_torch.ml.evaluate import auc_mean_per_user, rmse
from oryx_tpu_torch.ml.update import MLUpdate
from oryx_tpu_torch.ops.als import (
    AggregateState,
    agg_state_fingerprint,
    aggregate_interactions,
    align_factors,
    train_als,
    train_als_warm,
)
from oryx_tpu_torch.apps.als.common import (
    ALSConfig,
    parse_events,
    batch_update_messages,
    valid_event_line,
    valid_event_lines,
)

log = logging.getLogger(__name__)


class ALSUpdate(MLUpdate):
    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.als = ALSConfig.from_config(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        # incremental generations: persistent aggregate snapshot + warm
        # starts (docs/operations.md "Incremental generations & warm start")
        self.data_dir = config.get_string("oryx.batch.storage.data-dir", None)
        self.warm_start = config.get_bool("oryx.batch.train.warm-start", True)
        self.train_tol = config.get_float("oryx.batch.train.tol", 0.02)
        self.train_min_iterations = config.get_int(
            "oryx.batch.train.min-iterations", 2
        )
        self.train_check_every = config.get_int("oryx.batch.train.check-every", 2)
        # factor sharding over that many devices (ops/als.py train_als
        # shard_mesh; multi-device training is ROADMAP queue 1 item 11)
        self.train_shards = config.get_int("oryx.batch.train.shards", 1)
        self.max_drift_fraction = config.get_float(
            "oryx.batch.storage.incremental.max-drift-fraction", 0.5
        )
        self.snapshots_kept = config.get_int(
            "oryx.batch.storage.incremental.snapshots-kept", 2
        )
        self._agg_state: AggregateState | None = None  # in-memory, authoritative
        self._agg_pending = None  # (users, items, vals, tss) holdout to fold next gen
        # fold staged by the in-flight generation; adopted (and the staged
        # snapshot promoted) only in finalize_generation, after the batch
        # layer has persisted + committed the window — otherwise a crash
        # between snapshot and persist would re-deliver the window into a
        # state that already contains it (double-counted strengths)
        self._staged_state: AggregateState | None = None
        self._staged_pending = None
        self._staged_ts: int | None = None
        self._agg_through_ts: int | None = None  # newest generation folded
        self._prev_item_ids = None  # last generation's Y alignment table
        self._prev_y: np.ndarray | None = None
        reg = get_registry()
        self._m_agg_rows = reg.gauge(
            "oryx_batch_aggregate_rows",
            "Entries in the persistent batch aggregate state (0 until the "
            "first incremental generation)",
        )
        self._m_warm_iters = reg.gauge(
            "oryx_batch_warm_iterations",
            "ALS sweeps actually run by the last batch generation "
            "(convergence early stop; equals the configured iteration "
            "count on cold starts)",
        )

    # ---- incremental generations ---------------------------------------

    @property
    def _with_days(self) -> bool:
        return self.als.implicit and self.als.decay_factor < 1.0

    def validate_record(self, km) -> bool:
        """Deserialize check for the batch layer's quarantine sweep: a
        line parse_events would reject diverts to the dead-letter store
        instead of entering persisted history (where every from-scratch
        rebuild would re-read it forever)."""
        return valid_event_line(km.message)

    def validate_records(self, records):
        """Batch sweep: one native parse per window (see
        valid_event_lines) instead of a Python parse per record."""
        return valid_event_lines(km.message for km in records)

    @property
    def _fingerprint(self) -> str:
        return agg_state_fingerprint(
            implicit=self.als.implicit, with_days=self._with_days
        )

    def _parse_to_str(self, data):
        """parse_events with id arrays normalized to unicode — pending
        holdout buffers round-trip through npz, which cannot hold object
        arrays without pickling."""
        users, items, vals, tss = parse_events(data)
        return (
            np.asarray(users, dtype=str),
            np.asarray(items, dtype=str),
            vals,
            tss,
        )

    def _load_snapshot(self):
        """Persisted (state, pending) for the current schema, or None when
        missing/mismatched/stale. Stale = a persisted generation newer
        than the snapshot's through_ts: that window was never folded
        (crash between persist and snapshot), so the state lies."""
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
                "aggregate snapshot through %d is older than persisted "
                "generation %d; full rebuild", through_ts, newest,
            )
            return None
        try:
            state = AggregateState.from_arrays(arrays)
            pending = (
                np.asarray(arrays["pending_users"], dtype=str),
                np.asarray(arrays["pending_items"], dtype=str),
                np.asarray(arrays["pending_vals"], dtype=np.float64),
                np.asarray(arrays["pending_tss"], dtype=np.int64),
            )
        except KeyError:
            return None
        return state, pending

    def _snapshot_arrays(self, state: AggregateState, pending) -> dict:
        arrays = state.to_arrays()
        users, items, vals, tss = pending
        arrays["pending_users"] = (
            users if users.size else np.zeros(0, "<U1")
        )
        arrays["pending_items"] = (
            items if items.size else np.zeros(0, "<U1")
        )
        arrays["pending_vals"] = vals.astype(np.float64)
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

    def incremental_update(
        self,
        timestamp_ms: int,
        new_data,
        model_dir: str,
        update_producer: TopicProducer,
    ) -> bool:
        """One O(window) generation: merge the new window into the
        persisted aggregate state, warm-start training from the previous
        generation's factors, evaluate on the window's temporal holdout,
        publish, and snapshot — overlapping the snapshot write with the
        device training scan. Returns False (→ full rebuild) when the
        snapshot is missing/stale/mismatched, when the window drifts past
        max-drift-fraction of the state, or when a hyperparameter search
        is configured (candidates > 1 needs the full path's scoring)."""
        if self.candidates > 1:
            return False
        if (
            self._agg_state is not None
            and self._agg_state.fingerprint == self._fingerprint
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
        users, items, vals, tss = self._parse_to_str(train_msgs)
        self._window_tss = tss  # event-rate input of the quality profile
        if pending is not None and len(pending[2]):
            # the previous generation's holdout is persisted history the
            # from-scratch path would train on: fold it in now
            users = np.concatenate([pending[0], users])
            items = np.concatenate([pending[1], items])
            vals = np.concatenate([pending[2], vals])
            tss = np.concatenate([pending[3], tss])
        window = AggregateState.from_window(
            users, items, vals, tss,
            implicit=self.als.implicit, with_days=self._with_days,
        )
        if state.entries == 0 and window.entries == 0:
            log.info("no data at generation %d; skipping model build", timestamp_ms)
            return True
        if (
            state.entries
            and window.entries > self.max_drift_fraction * state.entries
        ):
            log.info(
                "window touches %d aggregate rows (> %.0f%% of %d): drift "
                "past oryx.batch.storage.incremental.max-drift-fraction; "
                "full rebuild", window.entries,
                100 * self.max_drift_fraction, state.entries,
            )
            self._agg_state = None  # re-anchor from history
            return False
        merged = state.merge(window)
        agg = merged.materialize(
            decay_factor=self.als.decay_factor,
            zero_threshold=self.als.zero_threshold,
            now_ms=int(time.time() * 1000),
            log_strength=self.als.log_strength,
            epsilon=self.als.epsilon,
        )
        tr.record_interval(
            "batch.merge", t_merge, window_rows=window.entries,
            aggregate_rows=merged.entries,
        )
        if len(agg.values) == 0 or agg.n_users == 0 or agg.n_items == 0:
            # everything deleted/thresholded away: nothing to train, but
            # the fold itself must survive
            log.info("generation %d: empty aggregate after merge", timestamp_ms)
            self._set_state(merged, self._parse_to_str(test_msgs), timestamp_ms)
            return True

        hyperparams = {
            "features": self.als.features,
            "lambda": self.als.lam,
            "alpha": self.als.alpha,
        }
        features = int(hyperparams["features"])
        t_warm = time.monotonic()
        resume_y = None
        if self.warm_start:
            if self._prev_y is None:
                self._load_prev_factors(model_dir)
            resume_y = align_factors(
                self._prev_item_ids, self._prev_y, agg.item_ids, features,
            )
        tr.record_interval(
            "batch.warmstart", t_warm,
            resumed_rows=0 if resume_y is None else len(agg.item_ids),
        )
        # snapshot write overlaps training: the card is busy for the
        # whole solve, the npz write is pure host I/O
        pending_next = self._parse_to_str(test_msgs)
        snap_err: list[BaseException] = []

        def _snapshot():
            try:
                self._persist_snapshot(timestamp_ms, merged, pending_next)
            except BaseException as e:  # noqa: BLE001 - surfaced after join
                snap_err.append(e)

        snap_thread = threading.Thread(
            target=_snapshot, name="oryx-agg-snapshot", daemon=True
        )
        snap_thread.start()
        try:
            model, sweeps = train_als_warm(
                agg,
                features=features,
                lam=float(hyperparams["lambda"]),
                alpha=float(hyperparams["alpha"]),
                iterations=self.als.iterations,
                implicit=self.als.implicit,
                compute_dtype=self.als.compute_dtype,
                resume_y=resume_y,
                tol=self.train_tol if resume_y is not None else 0.0,
                min_iterations=self.train_min_iterations,
                check_every=self.train_check_every,
                shard_mesh=self._shard_mesh(),
                device=self.device,
            )
        finally:
            snap_thread.join()
        if snap_err:
            raise snap_err[0]
        self._m_warm_iters.set(sweeps)
        self._m_agg_rows.set(merged.entries)
        art = self._artifact_from_model(model, hyperparams, agg)

        score = self.evaluate(art, train_msgs, test_msgs) if test_msgs else float("nan")
        log.info(
            "incremental generation %d: %d aggregate rows, %d/%d sweeps "
            "(warm=%s), eval %s", timestamp_ms, merged.entries, sweeps,
            self.als.iterations, resume_y is not None, score,
        )
        self._set_state(merged, pending_next, timestamp_ms, persisted=True)
        if (
            self.threshold is not None
            and np.isfinite(score)
            and score < float(self.threshold)
        ):
            log.warning(
                "incremental eval %.6f below threshold %s; not publishing "
                "model", score, self.threshold,
            )
            return True

        from pathlib import Path

        from oryx_tpu_torch.common.ioutil import delete_recursively, mkdirs, strip_scheme

        root = Path(strip_scheme(model_dir))
        staged = art.write(mkdirs(root / ".incremental") / str(timestamp_ms))
        self.note_eval(score)  # the stamp carries this generation's AUC
        self.promote_and_publish(staged, root, timestamp_ms, update_producer)
        delete_recursively(root / ".incremental")
        self._prev_item_ids = list(model.item_ids)
        self._prev_y = model.y
        return True

    def _memory_state_fresh(self) -> bool:
        """The in-memory state must pass the SAME newest-persisted-
        generation check as a loaded snapshot: a generation whose build
        raised AFTER its window was polled still gets that window
        persisted and committed by the batch layer — trusting the
        in-memory state blindly would drop those events from every
        future aggregate."""
        from oryx_tpu_torch.layers.datastore import latest_generation_ts

        if not self.data_dir or self._agg_through_ts is None:
            return False
        newest = latest_generation_ts(self.data_dir)
        return newest is None or newest <= self._agg_through_ts

    def _load_prev_factors(self, model_dir: str) -> None:
        """Restart path: resume warm starts from the newest published
        model artifact's Y (the in-memory copy dies with the process)."""
        from oryx_tpu_torch.common.ioutil import list_generation_dirs

        try:
            gens = list_generation_dirs(model_dir)
            if not gens:
                return
            art = ModelArtifact.read(gens[-1])
            y = art.tensors.get("Y")
            ids = art.get_extension_list("YIDs")
            if y is not None and ids and len(ids) == len(y):
                self._prev_item_ids = ids
                self._prev_y = np.asarray(y, dtype=np.float32)
        except Exception:  # noqa: BLE001 - warm start is best-effort
            log.warning("could not load previous factors for warm start",
                        exc_info=True)

    def _set_state(self, state, pending, timestamp_ms: int, persisted=False) -> None:
        """Stage the folded state. Both the in-memory adoption and the
        durable snapshot become visible in finalize_generation, once the
        window itself is persisted and committed."""
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
                log.exception("aggregate snapshot finalize failed")

    def after_full_build(self, timestamp_ms, train, test, model) -> None:
        """Re-anchor the incremental state after a from-scratch build: one
        extra linear pass over the already-materialized train/test splits,
        so the NEXT generation runs O(window) again. model is None when
        the build was withheld by the eval threshold — the aggregates
        still re-anchor (the window is persisted either way); only the
        warm-start factors are skipped."""
        try:
            users, items, vals, tss = self._parse_to_str(train)
            state = AggregateState.from_window(
                users, items, vals, tss,
                implicit=self.als.implicit, with_days=self._with_days,
            )
            pending = self._parse_to_str(test)
            self._set_state(state, pending, timestamp_ms)
            self._m_agg_rows.set(state.entries)
            # cold builds run the full configured sweep count; without
            # this a fallback generation would keep showing the previous
            # warm generation's low figure
            self._m_warm_iters.set(self.als.iterations)
            if model is not None:
                try:
                    self._prev_item_ids = model.get_extension_list("YIDs")
                    self._prev_y = model.tensors.get("Y")
                except Exception:  # noqa: BLE001 - warm start is best-effort
                    self._prev_item_ids = self._prev_y = None
        except Exception:  # noqa: BLE001 - snapshotting must never fail a
            # published generation; next generation just rebuilds again
            log.exception("aggregate snapshot rebuild failed; next "
                          "generation will run a full rebuild")

    def hyperparam_ranges(self) -> dict[str, Any]:
        return {
            "features": self.als.features,
            "lambda": self.als.lam,
            "alpha": self.als.alpha,
        }

    def split_train_test(self, data: Sequence[KeyMessage]):
        """Temporal split: newest test-fraction of events held out
        (ALSUpdate.java:325-342 sorts by timestamp) — the shared
        split_by_time helper (ml/update.py), falling back to the random
        split when no line carries a usable timestamp."""
        from oryx_tpu_torch.ml.update import split_by_time

        return split_by_time(
            data, self.test_fraction, super().split_train_test
        )

    def _shard_mesh(self):
        """Device count for row-sharded training, or None to train on one
        device. The shard count clamps to the cards that exist, so a
        2-shard config on a one-card host (or on the CPU) trains unsharded
        instead of failing the build; more than one card raises in
        train_als until multi-device training is ported (ROADMAP queue 1
        item 11)."""
        if self.train_shards <= 1 or self.device.type != "cuda":
            return None
        import torch

        n = min(self.train_shards, torch.cuda.device_count())
        return n if n > 1 else None

    def _aggregate(self, data: Sequence[KeyMessage]):
        users, items, vals, tss = parse_events(data)
        if len(vals) == 0:
            raise ValueError("no parseable interactions")
        self._window_tss = tss  # event-rate input of the quality profile
        return aggregate_interactions(
            users, items, vals, tss,
            implicit=self.als.implicit,
            decay_factor=self.als.decay_factor,
            zero_threshold=self.als.zero_threshold,
            now_ms=int(time.time() * 1000),
            log_strength=self.als.log_strength,
            epsilon=self.als.epsilon,
        )

    def build_model(self, train: Sequence[KeyMessage], hyperparams: dict[str, Any]) -> ModelArtifact:
        agg = self._aggregate(train)
        shard_mesh = self._shard_mesh()
        kwargs = dict(
            device=self.device,
            features=int(hyperparams["features"]),
            lam=float(hyperparams["lambda"]),
            alpha=float(hyperparams["alpha"]),
            iterations=self.als.iterations,
            implicit=self.als.implicit,
            compute_dtype=self.als.compute_dtype,
        )
        model_dir = self.config.get_string("oryx.batch.storage.model-dir", None)
        if self.als.checkpoint_interval > 0 and model_dir:
            # long builds survive preemption: resume from the last
            # checkpointed sweep instead of restarting the generation.
            # One subdir per hyperparam combo — candidates may build in
            # parallel (oryx.ml.eval.parallelism) and must not share a
            # checkpoint file
            import hashlib
            import json as _json

            from oryx_tpu_torch.common.ioutil import strip_scheme
            from oryx_tpu_torch.ops.als import train_als_checkpointed

            combo = hashlib.sha1(
                _json.dumps(hyperparams, sort_keys=True, default=str).encode()
            ).hexdigest()[:12]
            m = train_als_checkpointed(
                agg,
                pathlib.Path(strip_scheme(model_dir)) / ".als-checkpoint" / combo,
                self.als.checkpoint_interval,
                shard_mesh=shard_mesh,
                **kwargs,
            )
        else:
            m = train_als(agg, shard_mesh=shard_mesh, **kwargs)
        return self._artifact_from_model(m, hyperparams, agg)

    def _artifact_from_model(self, m, hyperparams, agg) -> ModelArtifact:
        """Model arrays + aggregate -> the publishable skeleton artifact
        (shared by the from-scratch candidate builds and the incremental
        warm-start path)."""
        art = ModelArtifact(
            "als",
            extensions={
                "features": str(int(hyperparams["features"])),
                "lambda": str(float(hyperparams["lambda"])),
                "alpha": str(float(hyperparams["alpha"])),
                "implicit": str(self.als.implicit).lower(),
                "logStrength": str(self.als.log_strength).lower(),
            },
            tensors={"X": m.x, "Y": m.y},
        )
        art.set_extension("XIDs", m.user_ids)
        art.set_extension("YIDs", m.item_ids)
        self._attach_quality_profile(art, m, agg)
        # knownItems per user ride with the X rows at publish time.
        # Vectorized grouping: a per-pair Python dict loop costs ~20s at
        # the 25M-interaction benchmark scale (measured 3x slower than
        # this sort-and-slice form)
        if not self.als.no_known_items and len(agg.users):
            item_arr = np.asarray(agg.item_ids, dtype=object)
            order = np.argsort(agg.users, kind="stable")
            us = agg.users[order]
            its = item_arr[agg.items[order]]
            cut = np.nonzero(np.r_[True, us[1:] != us[:-1]])[0]
            ends = np.r_[cut[1:], len(us)]
            art.content["knownItems"] = {
                agg.user_ids[us[c]]: its[c:e].tolist()
                for c, e in zip(cut, ends)
            }
        return art

    def _attach_quality_profile(self, art: ModelArtifact, m, agg) -> None:
        """Stamp the generation's training profile (item-popularity
        sketch, event rate, new-item fraction, predicted-score
        distribution) into the artifact so the serving/speed tiers can
        measure drift against what this model actually trained on. Never
        fails a build — a generation without a profile just reads NaN
        drift."""
        try:
            from oryx_tpu_torch.common.qualitystats import build_training_profile

            counts = np.bincount(
                agg.items, minlength=agg.n_items
            ).astype(np.float64)
            scores = None
            x, y = np.asarray(m.x), np.asarray(m.y)
            if len(x) and len(y):
                # the LIVE side of prediction drift is the mean of served
                # top-k scores (an extreme order statistic), so the
                # baseline must be the SAME statistic — mean top-10 score
                # of sampled training users over the full catalog — or a
                # perfectly healthy model reads as drifted forever
                rng = np.random.default_rng(7)
                us = rng.integers(0, len(x), 32)
                k = min(10, len(y))
                full = x[us] @ y.T  # (32, n_items), a few GFLOP at 1M rows
                part = -np.partition(-full, k - 1, axis=1)[:, :k]
                scores = part.mean(axis=1)
            profile = build_training_profile(
                agg.item_ids, counts,
                timestamps_ms=getattr(self, "_window_tss", None),
                prev_item_ids=self._prev_item_ids,
                scores=scores,
            )
            art.set_extension("qualityProfile", profile.to_json())
        except Exception:  # noqa: BLE001 - the profile must never fail a build
            log.warning("quality profile build failed", exc_info=True)

    def eval_metric_name(self) -> str:
        # implicit feedback evaluates mean per-user AUC; explicit a
        # negated RMSE (bigger is better either way)
        return "auc" if self.als.implicit else "neg_rmse"

    def evaluate(self, model: ModelArtifact, train, test) -> float:
        users, items, vals, _ = parse_events(test)
        if len(vals) == 0:
            return float("nan")
        xids = model.get_extension_list("XIDs")
        yids = model.get_extension_list("YIDs")
        umap = {u: j for j, u in enumerate(xids)}
        imap = {i: j for j, i in enumerate(yids)}
        keep = [
            (umap[u], imap[i], v)
            for u, i, v in zip(users, items, vals)
            if u in umap and i in imap and not np.isnan(v)
        ]
        if not keep:
            return float("nan")
        tu = np.asarray([a for a, _, _ in keep])
        ti = np.asarray([b for _, b, _ in keep])
        tv = np.asarray([c for _, _, c in keep])
        x, y = model.tensors["X"], model.tensors["Y"]
        if self.als.implicit:
            known = {
                umap[u]: {imap[i] for i in its if i in imap}
                for u, its in model.content.get("knownItems", {}).items()
                if u in umap
            }
            return auc_mean_per_user(x, y, tu, ti, known)
        return -rmse(x, y, tu, ti, tv)

    def publish_model(self, model: ModelArtifact, model_path: str, producer: TopicProducer) -> None:
        """Publish a tensor-free skeleton; factor rows stream separately
        (the reference's skeleton-PMML-with-extensions pattern). An
        oversized skeleton ships its bytes as bus chunks ahead of the
        MODEL-REF so other hosts resolve it with no shared mount."""
        from oryx_tpu_torch.common.artifact import publish_model_ref

        skeleton = ModelArtifact("als", dict(model.extensions), {})
        serialized = skeleton.to_string()
        if len(serialized.encode("utf-8")) <= self.max_message_size:
            producer.send("MODEL", serialized)
        else:
            publish_model_ref(
                producer, serialized, model_path, self.max_message_size,
                transfer=self.artifact_transfer,
            )
        # freshness stamp (SPI contract: every publish_model override ends
        # with this), read by oryx_model_generation / update-to-serve
        # freshness on every consuming tier
        self.send_publish_stamp(model_path, producer)

    def publish_additional_model_data(
        self, model: ModelArtifact, model_path: str, producer: TopicProducer
    ) -> None:
        """Stream every Y row then every X row as UP messages
        (ALSUpdate.java:286-318: Y first so user solves see item vectors)."""
        xids = model.get_extension_list("XIDs")
        yids = model.get_extension_list("YIDs")
        x, y = model.tensors["X"], model.tensors["Y"]
        known = model.content.get("knownItems", {})

        def chunks(kind, ids, mat, known_of=None):
            # batched message building (one C-encoder pass per chunk), in
            # bounded chunks so a million-row flood never materializes one
            # multi-hundred-MB JSON blob
            step = 8192
            dropped = 0
            for lo in range(0, len(ids), step):
                part = ids[lo : lo + step]
                block = mat[lo : lo + len(part)]
                finite = np.isfinite(block).all(axis=1)
                if not finite.all():  # builder contract: NaN is not JSON
                    dropped += int((~finite).sum())
                    rows = np.nonzero(finite)[0]
                    part = [part[j] for j in rows]
                    block = block[rows]
                yield from batch_update_messages(
                    kind, part, block,
                    known_lists=(
                        [known_of.get(i, []) for i in part]
                        if known_of is not None else None
                    ),
                )
            if dropped:
                log.warning("dropped %d non-finite %s factor rows at publish", dropped, kind)

        producer.send_batch(chunks("Y", yids, y))
        producer.send_batch(chunks("X", xids, x, known))
        log.info("published %d Y and %d X factor rows", len(yids), len(xids))
