"""RDF batch tier: full forest rebuild per generation (the port of
oryx_tpu/apps/rdf/batch.py).

Replaces RDFUpdate (app/oryx-app-mllib .../batch/mllib/rdf/RDFUpdate.java):
build categorical value encodings from all training data (:205-231),
encode + quantile-bin predictors, grow the histogram forest on the card
(ops/rdf.py), and evaluate accuracy (classification) or -RMSE (regression)
on the held-out split (:179-205), its rows routed on the card. Hyperparameters match the reference's
tuned set: max-split-candidates, max-depth, impurity (:100-105).
"""

from __future__ import annotations

import logging
from typing import Any, Sequence

import numpy as np

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.artifact import ModelArtifact
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_input_line
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ml.update import MLUpdate
from oryx_tpu_torch.ops.rdf import (
    bin_dataset,
    class_probs_from_leaves,
    grow_forest,
    regression_from_leaves,
)
from oryx_tpu_torch.apps.rdf.common import RDFConfig, artifact_to_model, forest_to_artifact
from oryx_tpu_torch.apps.schema import CategoricalValueEncodings, InputSchema, encode_matrix

log = logging.getLogger(__name__)


def _parse_rows(data: Sequence[KeyMessage]) -> list[list[str]]:
    rows = []
    for km in data:
        try:
            rows.append(parse_input_line(km.message))
        except ValueError:
            continue
    return rows


class RDFUpdate(MLUpdate):
    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.rdf = RDFConfig.from_config(config)
        self.schema = InputSchema(config)
        if not self.schema.has_target():
            raise ValueError("RDF requires a target feature")
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)

    def hyperparam_ranges(self) -> dict[str, Any]:
        return {
            "max-split-candidates": self.rdf.max_split_candidates,
            "max-depth": self.rdf.max_depth,
            "impurity": self.rdf.impurity,
        }

    def build_model(
        self, train: Sequence[KeyMessage], hyperparams: dict[str, Any]
    ) -> ModelArtifact:
        rows = _parse_rows(train)
        if not rows:
            raise ValueError("no parseable training rows")
        encodings = CategoricalValueEncodings.from_data(self.schema, rows)
        x, y = encode_matrix(self.schema, encodings, rows)
        keep = ~np.isnan(y)
        x, y = x[keep], y[keep]
        if len(y) == 0:
            raise ValueError("no rows with a target value")

        is_cat = np.array(
            [
                self.schema.is_categorical(self.schema.predictor_to_feature_index(j))
                for j in range(self.schema.num_predictors)
            ]
        )
        cat_counts = np.array(
            [
                encodings.get_value_count(self.schema.predictor_to_feature_index(j))
                for j in range(self.schema.num_predictors)
            ]
        )
        data = bin_dataset(
            x, is_cat, cat_counts, int(hyperparams["max-split-candidates"])
        )
        classification = self.schema.is_classification()
        n_classes = (
            encodings.get_value_count(self.schema.target_index) if classification else 0
        )
        impurity = str(hyperparams["impurity"]).lower()
        if not classification:
            impurity = "variance"
        forest = grow_forest(
            data,
            y,
            num_trees=self.rdf.num_trees,
            max_depth=int(hyperparams["max-depth"]),
            impurity=impurity,
            n_classes=n_classes,
            feature_subset=self.rdf.feature_subset,
            device=self.device,
        )
        return forest_to_artifact(
            forest, data.edges, data.n_bins, encodings, self.schema, hyperparams
        )

    def evaluate(self, model: ModelArtifact, train, test) -> float:
        rows = _parse_rows(test)
        if not rows:
            return float("nan")
        rdf_model = artifact_to_model(model, self.schema, device=self.device)
        x, y = rdf_model.rows_to_matrix(rows)
        keep = ~np.isnan(y)
        x, y = x[keep], y[keep]
        if len(y) == 0:
            return float("nan")
        leaves = rdf_model.terminal_nodes(rdf_model.bin_matrix(x))
        if self.schema.is_classification():
            probs = class_probs_from_leaves(rdf_model.forest, leaves)
            acc = float(np.mean(np.argmax(probs, axis=1) == y.astype(np.int64)))
            log.info("accuracy: %.5f", acc)
            return acc
        preds = regression_from_leaves(rdf_model.forest, leaves)
        rmse = float(np.sqrt(np.mean((preds - y) ** 2)))
        log.info("RMSE: %.5f", rmse)
        return -rmse
