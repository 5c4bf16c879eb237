"""The batch-training harness: hyperparam candidates -> build -> eval ->
publish the winner (the port's copy of oryx_tpu/ml/update.py).

MLUpdate (reference framework/oryx-ml .../ml/MLUpdate.java:60-378).
Per generation it: splits train/test (random by default, overridable — ALS
splits by time), chooses hyperparameter combos, builds + evaluates each
candidate (sequential by default: the card is the scarce resource,
concurrent builds share it — eval parallelism is for CPU-side eval),
applies the acceptance threshold, atomically renames the winner into
model_dir/<timestamp>, and publishes it to the update topic inline
("MODEL") or as a path reference ("MODEL-REF") when it exceeds the topic's
max message size (MLUpdate.java:212-231), then streams any oversized extras
via publish_additional_model_data (e.g. ALS factor rows).

Single process, single card: the JAX package's pod branches (the
process-group candidate search, the winner fetch across hosts) and its
sub-mesh pool are ROADMAP queue 1 item 11. A config that enables a pod
(``oryx.compute.distributed.*``) raises ValueError; with no mesh,
candidates run in threads (``collect_in_parallel``) and share the card.
"""

from __future__ import annotations

import logging
from abc import abstractmethod
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from oryx_tpu_torch.api import BatchLayerUpdate
from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer
from oryx_tpu_torch.common.artifact import ModelArtifact
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.executil import collect_in_parallel
from oryx_tpu_torch.common.ioutil import atomic_rename, delete_recursively, mkdirs, strip_scheme
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.device import reject_pod_config
from oryx_tpu_torch.ml.hyperparams import choose_combos

log = logging.getLogger(__name__)



def split_by_time(
    data: Sequence[KeyMessage],
    test_fraction: float,
    fallback,
    ts_token: int = 3,
) -> tuple[Sequence[KeyMessage], Sequence[KeyMessage]]:
    """Temporal holdout split shared by the timestamped apps (ALS event
    lines and seq session lines both carry the timestamp as CSV token
    ``ts_token``): the newest ``test_fraction`` of records is held out
    (the reference's ALSUpdate.java:325-342 sort-by-time split).
    Timestamps are read per line in place — unparseable lines get -1 and
    stay in train, so indices always align with ``data``. When no line
    carries a usable timestamp (or all are equal), ``fallback(data)``
    decides (usually the random split)."""
    if test_fraction <= 0 or len(data) == 0:
        return data, []
    from oryx_tpu_torch.common.text import parse_input_line

    ts = np.full(len(data), -1, dtype=np.int64)
    for j, km in enumerate(data):
        try:
            tok = parse_input_line(km.message)
            if len(tok) > ts_token and tok[ts_token] != "":
                ts[j] = int(float(tok[ts_token]))
        except (ValueError, IndexError, OverflowError):
            pass
    valid = ts[ts >= 0]
    if len(valid) == 0 or np.all(valid == valid[0]):
        return fallback(data)
    order = np.argsort(ts, kind="stable")
    n_test = int(len(data) * test_fraction)
    if n_test == 0:
        return data, []
    test_set = set(order[-n_test:].tolist())
    train = [d for j, d in enumerate(data) if j not in test_set]
    test = [d for j, d in enumerate(data) if j in test_set]
    return train, test


class MLUpdate(BatchLayerUpdate):
    def __init__(self, config: Config):
        self.config = config
        self.test_fraction = config.get_float("oryx.ml.eval.test-fraction", 0.1)
        self.candidates = config.get_int("oryx.ml.eval.candidates", 1)
        self.search = config.get_string("oryx.ml.eval.hyperparam-search", "random")
        self.eval_parallelism = config.get_int("oryx.ml.eval.parallelism", 1)
        self.threshold = config.get("oryx.ml.eval.threshold", None)
        self.max_message_size = config.get_int("oryx.update-topic.message.max-size", 1 << 24)
        # bus-chunked MODEL-REF artifact bytes (cross-host resolution with
        # no shared mount); off, the default here, is the reference's
        # bare-path publish
        self.artifact_transfer = config.get_bool(
            "oryx.update-topic.artifact-transfer", False
        )
        reject_pod_config(config)
        # incremental generations: apps that maintain a persistent
        # aggregate snapshot (incremental_update) make generation N cost
        # O(new window)
        self.incremental = config.get_bool(
            "oryx.batch.storage.incremental.enabled", True
        )
        self._m_incremental = get_registry().counter(
            "oryx_batch_incremental_total",
            "Batch model builds by kind: delta = merged into the persisted "
            "aggregate snapshot, full = from-scratch over all history",
            labeled=True,
        )

    # ---- hooks an app implements -----------------------------------------

    @abstractmethod
    def build_model(self, train: Sequence[KeyMessage], hyperparams: dict[str, Any]) -> ModelArtifact:
        """Train one candidate on the train split."""

    @abstractmethod
    def evaluate(
        self,
        model: ModelArtifact,
        train: Sequence[KeyMessage],
        test: Sequence[KeyMessage],
    ) -> float:
        """Bigger-is-better eval of a candidate on held-out data; NaN = bad."""

    def hyperparam_ranges(self) -> dict[str, Any]:
        """Config-valued hyperparameter ranges (name -> scalar/list/dict)."""
        return {}

    def eval_metric_name(self) -> str:
        """Name of the number ``evaluate`` returns (e.g. "auc",
        "hit_rate_at_10") — the label the generation's quality scorecard
        carries through the publish stamp into
        ``oryx_generation_quality{metric}`` on every consuming tier."""
        return "score"

    def note_eval(self, score: float | None) -> None:
        """Remember the winning candidate's eval score so the publish
        stamp that follows can carry the generation's scorecard. Every
        publish path (candidate search, app incremental_update
        overrides) calls this just before promote_and_publish; a
        non-finite score clears the card instead of stamping a lie."""
        if score is not None and np.isfinite(score):
            self._last_eval = {self.eval_metric_name(): float(score)}
        else:
            self._last_eval = None

    def split_train_test(
        self, data: Sequence[KeyMessage]
    ) -> tuple[Sequence[KeyMessage], Sequence[KeyMessage]]:
        """Random holdout by test-fraction (MLUpdate.java:370-376); apps
        with temporal data override to split by time."""
        if self.test_fraction <= 0 or len(data) == 0:
            return data, []
        rng = RandomManager.get_random()
        mask = rng.random(len(data)) < self.test_fraction
        train = [d for d, m in zip(data, mask) if not m]
        test = [d for d, m in zip(data, mask) if m]
        return train, test

    def publish_additional_model_data(
        self,
        model: ModelArtifact,
        model_path: str,
        producer: TopicProducer,
    ) -> None:
        """Hook for streaming data too large for the artifact message (ALS
        streams every factor row here, MLUpdate.java:233-236)."""

    def incremental_update(
        self,
        timestamp_ms: int,
        new_data: Sequence[KeyMessage],
        model_dir: str,
        update_producer: TopicProducer,
    ) -> bool:
        """App hook: attempt an O(new-window) incremental generation
        against a persisted aggregate snapshot (see apps/als/batch.py).
        Return True when the generation was fully handled — model built
        and published, or legitimately withheld (threshold) — with the
        window folded into the snapshot. Return False to fall back to the
        from-scratch path over materialized history (snapshot missing,
        schema-mismatched, stale, or window drift past the configured
        fraction)."""
        return False

    def after_full_build(
        self,
        timestamp_ms: int,
        train: Sequence[KeyMessage],
        test: Sequence[KeyMessage],
        model: ModelArtifact | None,
    ) -> None:
        """App hook, called after a from-scratch build: rebuild and stage
        the aggregate snapshot so the NEXT generation can run
        incrementally again (the delta-vs-full discipline: every full
        rebuild re-anchors the incremental state). model is None when the
        eval threshold withheld publication — aggregates re-anchor
        regardless, since the window is persisted regardless."""

    def training_mesh(self):
        """The mesh candidate builds run on: always None in the port, which
        trains on one card (meshes are ROADMAP queue 1 item 11)."""
        return None

    # ---- the harness -----------------------------------------------------

    def run_update(
        self,
        timestamp_ms: int,
        new_data: Sequence[KeyMessage],
        past_data: Sequence[KeyMessage],
        model_dir: str,
        update_producer: TopicProducer,
    ) -> None:
        if self.incremental:
            # the incremental path never touches past_data: when the app's
            # aggregate snapshot is valid, generation cost is O(window)
            if self.incremental_update(
                timestamp_ms, new_data, model_dir, update_producer
            ):
                self._m_incremental.inc(kind="delta")
                return
        data = list(past_data) + list(new_data)
        if not data:
            log.info("no data at generation %d; skipping model build", timestamp_ms)
            return
        self._m_incremental.inc(kind="full")
        train, test = self.split_train_test(data)
        if not train:
            train, test = data, []
        combos = choose_combos(self.hyperparam_ranges(), self.candidates, self.search)

        root = Path(strip_scheme(model_dir))
        cand_root = mkdirs(root / ".candidates" / str(timestamp_ms))

        parallelism = min(self.eval_parallelism, len(combos))
        results = collect_in_parallel(
            len(combos),
            lambda i: self._build_one(i, combos, train, test, cand_root),
            parallelism,
        )
        scores = [s for s, _ in results]
        paths = [p for _, p in results]
        has_model = [p is not None for p in paths]

        best_i, best_score = -1, float("-inf")
        for i, (score, ok) in enumerate(zip(scores, has_model)):
            if not ok:
                continue
            if np.isnan(score):
                # no test data / failed eval: candidate is acceptable only
                # if nothing scored beats it (mirror of the reference's
                # NaN-tolerant pickBest)
                if best_i < 0:
                    best_i = i
            elif score > best_score:
                best_i, best_score = i, score
        if best_i < 0:
            delete_recursively(cand_root)
            raise RuntimeError("no model candidate built successfully")

        if (
            self.threshold is not None
            and np.isfinite(best_score)  # only gate actually-evaluated models:
            # a NaN-pick leaves best_score=-inf, which must not block publication
            and best_score < float(self.threshold)
        ):
            log.warning(
                "best eval %.6f below threshold %s; not publishing model",
                best_score, self.threshold,
            )
            delete_recursively(cand_root)
            # still re-anchor the aggregate snapshot: the window persists
            # either way, and skipping this would leave the snapshot
            # permanently stale — every later generation would repeat the
            # O(history) full rebuild until eval crossed the threshold
            if self.incremental:
                self.after_full_build(timestamp_ms, train, test, None)
            return

        # the winner's eval rides the publish stamp as the generation's
        # quality scorecard (best_score is -inf on a NaN-tolerant pick)
        self.note_eval(best_score if np.isfinite(best_score) else None)
        model = self.promote_and_publish(
            paths[best_i], root, timestamp_ms, update_producer
        )
        delete_recursively(root / ".candidates")
        if self.incremental:
            self.after_full_build(timestamp_ms, train, test, model)

    def promote_and_publish(
        self,
        staged_dir: Path,
        model_root: Path,
        timestamp_ms: int,
        update_producer: TopicProducer,
    ) -> ModelArtifact:
        """Atomically promote a built candidate dir to
        model_root/<timestamp> and publish it (MODEL/MODEL-REF + extras)
        — the one publish tail shared by the candidate-search and
        incremental paths."""
        final_dir = model_root / str(timestamp_ms)
        delete_recursively(final_dir)
        # bounded retry (common/retry.py): the built candidate is complete
        # on disk, so only the cheap promote rename replays on a transient
        # filesystem error — losing a finished multi-hour build to one
        # EIO here would be the worst trade in the system
        from oryx_tpu_torch.common.retry import retry_call

        retry_call("datastore.rename", atomic_rename, staged_dir, final_dir)
        model = ModelArtifact.read(final_dir)
        self.publish_model(model, str(final_dir), update_producer)
        self.publish_additional_model_data(model, str(final_dir), update_producer)
        return model

    def _build_one(
        self,
        i: int,
        combos: list[dict[str, Any]],
        train: Sequence[KeyMessage],
        test: Sequence[KeyMessage],
        cand_root: Path,
    ) -> tuple[float, Path | None]:
        """Build, write, and evaluate candidate i — the single copy of the
        candidate build-and-score contract."""
        try:
            model = self.build_model(train, combos[i])
            cand_dir = model.write(cand_root / str(i))
            score = self.evaluate(model, train, test) if test else float("nan")
            log.info("candidate %d %s -> eval %s", i, combos[i], score)
            return score, cand_dir
        except Exception:
            log.exception("candidate %d failed", i)
            return float("nan"), None

    def publish_model(
        self, model: ModelArtifact, model_path: str, producer: TopicProducer
    ) -> None:
        """Inline when small enough, else a path reference
        (MLUpdate.java:212-231) — preceded by the bus-chunked artifact
        bytes (common/artifact.py publish_model_ref). The port's consumers
        resolve a MODEL-REF by path and skip the chunks (the relay that
        assembles them is ROADMAP queue 1 item 3)."""
        from oryx_tpu_torch.common.artifact import publish_model_ref

        serialized = model.to_string()
        if len(serialized.encode("utf-8")) <= self.max_message_size:
            producer.send("MODEL", serialized)
        else:
            publish_model_ref(
                producer, serialized, model_path, self.max_message_size,
                transfer=self.artifact_transfer,
            )
        self.send_publish_stamp(model_path, producer)

    def send_publish_stamp(
        self, model_path: str, producer: TopicProducer
    ) -> None:
        """Publish-time freshness stamp, sent AFTER the model message
        (app-visible record order is unchanged; consumers claim the stamp
        for the model that just loaded): feeds
        oryx_update_to_serve_seconds / oryx_model_staleness_seconds on
        every consuming tier and carries the generation's trace context.
        An SPI contract point: apps overriding publish_model (the ALS/seq
        skeleton pattern) call this at the end of their override so every
        packaged app's generations stay observable the same way."""
        from oryx_tpu_torch.common.freshness import publish_stamp

        try:
            generation = int(Path(model_path).name)
        except (TypeError, ValueError):
            generation = None
        producer.send(
            "TRACE",
            publish_stamp(
                generation=generation,
                quality=getattr(self, "_last_eval", None),
            ),
        )
