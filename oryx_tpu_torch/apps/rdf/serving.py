"""RDF serving tier: in-memory forest + live terminal-node updates (the
port of oryx_tpu/apps/rdf/serving.py).

Mirrors RDFServingModel / RDFServingModelManager (app/oryx-app-serving
.../rdf/model/): MODEL(-REF) replaces the forest; "UP"
[treeID, nodeID, ...] messages fold counts (classification) or a
(mean, count) summary (regression) into the addressed terminal node's
prediction (RDFServingModelManager.java:57-84). fraction_loaded is 1
once a model is present (the forest arrives whole, unlike ALS factors).
A request's datum is routed on the card (``RDFModel.terminal_nodes``);
imported PMML forests evaluate their predicate trees on the host.
"""

from __future__ import annotations

import json
import logging

from oryx_tpu_torch.api import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common.artifact import read_artifact_from_update
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.apps.rdf.common import RDFModel, artifact_to_model
from oryx_tpu_torch.apps.schema import InputSchema

log = logging.getLogger(__name__)


class RDFServingModel(ServingModel):
    def __init__(self, model: RDFModel):
        self.rdf = model

    def fraction_loaded(self) -> float:
        return 1.0

    @property
    def schema(self) -> InputSchema:
        return self.rdf.schema

    def predict(self, datum: str):
        return self.rdf.predict_datum(datum)

    def classification_distribution(self, datum: str) -> dict[str, float]:
        """Category value -> probability for one datum."""
        if not self.rdf.forest.is_classification:
            raise ValueError("not a classification model")
        _, probs = self.rdf.predict_datum(datum)
        ti = self.schema.target_index
        return {
            self.rdf.encodings.decode(ti, c): float(p) for c, p in enumerate(probs)
        }

    def feature_importance(self) -> list[float]:
        return self.rdf.feature_importance()


class PMMLForestServingModel(ServingModel):
    """Serves a forest imported from reference-published PMML (common/
    pmml.py): same query surface as RDFServingModel — predict,
    classification distribution, live UP folding by PMML node id — so a
    migrated deployment answers /predict immediately, no retraining. New
    batch generations then replace it with the native vectorized forest."""

    def __init__(self, forest, schema: InputSchema):
        self.forest = forest
        self.schema = schema

    def fraction_loaded(self) -> float:
        return 1.0

    def _features(self, datum: str) -> dict:
        from oryx_tpu_torch.common.text import parse_input_line
        from oryx_tpu_torch.apps.rdf.common import tokens_to_features

        features, _ = tokens_to_features(self.schema, parse_input_line(datum))
        return features

    def predict(self, datum: str):
        result = self.forest.predict(self._features(datum))
        if self.forest.is_classification:
            return result  # (label, distribution dict)
        return result, None

    def classification_distribution(self, datum: str) -> dict[str, float]:
        if not self.forest.is_classification:
            raise ValueError("not a classification model")
        _, dist = self.forest.predict(self._features(datum))
        return dist

    def feature_importance(self) -> list[float]:
        # PMML MiningModels carry no importances; report zeros
        return [0.0] * self.schema.num_predictors


class RDFServingModelManager(AbstractServingModelManager):
    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.schema = InputSchema(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        self.model: RDFServingModel | None = None

    def get_model(self) -> RDFServingModel | None:
        return self.model

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == "UP":
            model = self.model
            if model is None:
                return  # no model to interpret with yet
            update = json.loads(message)
            tree = int(update[0])
            node_id = str(update[1])
            if isinstance(model, PMMLForestServingModel):
                if model.forest.is_classification:
                    model.forest.update_classification_leaf(tree, node_id, update[2])
                else:
                    model.forest.update_regression_leaf(
                        tree, node_id, float(update[2]), int(update[3])
                    )
            elif model.rdf.forest.is_classification:
                model.rdf.update_classification_leaf(tree, node_id, update[2])
            else:
                model.rdf.update_regression_leaf(
                    tree, node_id, float(update[2]), int(update[3])
                )
        elif key in ("MODEL", "MODEL-REF"):
            art = read_artifact_from_update(key, message)
            if art.app == "rdf-pmml":
                from oryx_tpu_torch.common.pmml import PredicateForest

                forest = PredicateForest.from_artifact(art)
                self.model = PMMLForestServingModel(forest, self.schema)
                log.info("imported PMML model loaded: %d trees", len(forest.trees))
            else:
                self.model = RDFServingModel(
                    artifact_to_model(art, self.schema, device=self.device))
                log.info(
                    "new model loaded: %d trees",
                    self.model.rdf.forest.num_trees,
                )
        else:
            raise ValueError(f"bad key: {key}")
