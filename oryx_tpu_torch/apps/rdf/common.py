"""Shared RDF app pieces: config, artifact codec, the model (the port of
oryx_tpu/apps/rdf/common.py).

The reference spreads this across app/oryx-app-common .../rdf/ (pointer
trees, decisions, predictions) and .../rdf/RDFPMMLUtils.java (PMML
round-trip). Here a model is the dense array `Forest` (ops/rdf.py)
plus the bin edges and categorical value encodings needed to take a raw
CSV datum to binned predictor space; mutation (speed-tier "UP" messages)
edits leaf count/stat rows in place — the CategoricalPrediction.update /
NumericPrediction.update semantics (app/oryx-app-common .../classreg/
predict/{Categorical,Numeric}Prediction.java) without per-node objects.

The model keeps the forest's structure (``feature``, ``split_left``) on the
card as well, and routes every batch of examples there
(``route_binned_device``); the leaf counts and stats stay on the host,
where UP messages mutate them, and predictions read them under the model's
lock. The artifact is the JAX package's: the port loads what its
``RDFUpdate`` publishes, and the other way round.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.common.artifact import ModelArtifact
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_input_line
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.rdf import (
    Forest,
    bin_column,
    class_probs_from_leaves,
    heap_to_node_id,
    node_id_to_heap,
    regression_from_leaves,
    route_binned_device,
)
from oryx_tpu_torch.apps.schema import CategoricalValueEncodings, InputSchema


@dataclass
class RDFConfig:
    num_trees: int
    max_split_candidates: object  # hyperparam range values
    max_depth: object
    impurity: object
    # featureSubsetStrategy (reference RDFUpdate.java:143-165): "auto",
    # "all", "sqrt", "log2", "onethird", or an explicit integer
    feature_subset: object

    @classmethod
    def from_config(cls, config: Config) -> "RDFConfig":
        g = lambda key, d=None: config.get(f"oryx.rdf.{key}", d)
        return cls(
            num_trees=int(g("num-trees", 20)),
            max_split_candidates=g("hyperparams.max-split-candidates", 100),
            max_depth=g("hyperparams.max-depth", 8),
            impurity=g("hyperparams.impurity", "entropy"),
            feature_subset=g("hyperparams.feature-subset", "auto"),
        )


# ---------------------------------------------------------------------------
# artifact codec
# ---------------------------------------------------------------------------

def forest_to_artifact(
    forest: Forest,
    edges: list[np.ndarray | None],
    n_bins: np.ndarray,
    encodings: CategoricalValueEncodings,
    schema: InputSchema,
    hyperparams: dict,
) -> ModelArtifact:
    """Forest + binning + encodings -> self-describing artifact (plays the
    role of the PMML MiningModel RDFUpdate.java:167-175 emits)."""
    p = len(n_bins)
    max_edges = max((len(e) for e in edges if e is not None), default=0)
    edge_mat = np.full((p, max_edges), np.nan, dtype=np.float32)
    for j, e in enumerate(edges):
        if e is not None and len(e):
            edge_mat[j, : len(e)] = e
    tensors = {
        "feature": forest.feature,
        "split_left": forest.split_left.astype(np.uint8),
        "edges": edge_mat,
        "n_bins": np.asarray(n_bins, dtype=np.int32),
    }
    if forest.is_classification:
        tensors["class_counts"] = forest.class_counts
    else:
        tensors["leaf_stats"] = forest.leaf_stats
    art = ModelArtifact(
        "rdf",
        extensions={k: str(v) for k, v in hyperparams.items()},
        tensors=tensors,
    )
    art.content["maxDepth"] = int(forest.max_depth)
    art.content["numTrees"] = int(forest.num_trees)
    art.content["categorical"] = [
        bool(schema.is_categorical(schema.predictor_to_feature_index(j)))
        for j in range(p)
    ]
    art.content["encodings"] = encodings.to_content()
    art.content["featureNames"] = schema.feature_names
    art.content["importances"] = [float(v) for v in forest.feature_importances]
    return art


def artifact_to_model(
    art: ModelArtifact, schema: InputSchema, device=None
) -> "RDFModel":
    feature = np.asarray(art.tensors["feature"])
    split_left = np.asarray(art.tensors["split_left"]).astype(bool)
    n_bins = np.asarray(art.tensors["n_bins"])
    edge_mat = np.asarray(art.tensors["edges"])
    categorical = art.content["categorical"]
    edges: list[np.ndarray | None] = []
    for j in range(len(n_bins)):
        if categorical[j]:
            edges.append(None)
        else:
            e = edge_mat[j][: int(n_bins[j]) - 1] if edge_mat.size else np.empty(0)
            edges.append(np.asarray(e, dtype=np.float32))
    class_counts = art.tensors.get("class_counts")
    leaf_stats = art.tensors.get("leaf_stats")
    forest = Forest(
        feature=feature,
        split_left=split_left,
        class_counts=None if class_counts is None else np.asarray(class_counts),
        leaf_stats=None if leaf_stats is None else np.asarray(leaf_stats),
        feature_importances=np.asarray(art.content.get("importances", [])),
        max_depth=int(art.content["maxDepth"]),
    )
    encodings = CategoricalValueEncodings.from_content(art.content["encodings"])
    return RDFModel(forest, edges, n_bins, encodings, schema, device=device)


# ---------------------------------------------------------------------------
# host model
# ---------------------------------------------------------------------------

class RDFModel:
    """Forest + binning + encodings; thread-safe leaf mutation for the
    speed/serving consume path; routing on ``device`` (the card unless the
    caller names the CPU)."""

    def __init__(
        self,
        forest: Forest,
        edges: list[np.ndarray | None],
        n_bins: np.ndarray,
        encodings: CategoricalValueEncodings,
        schema: InputSchema,
        device=None,
    ):
        self.forest = forest
        self.edges = edges
        self.n_bins = np.asarray(n_bins)
        self.encodings = encodings
        self.schema = schema
        self._lock = threading.Lock()
        self.device = resolve_device(device)
        # the structure is fixed for the model's life (UPs touch leaf
        # stats only), so one device copy serves every request
        self._feature_d = torch.from_numpy(
            np.ascontiguousarray(forest.feature, dtype=np.int32)).to(self.device)
        self._split_d = torch.from_numpy(
            np.ascontiguousarray(forest.split_left, dtype=bool)).to(self.device)

    # -- vectorization -----------------------------------------------------

    def rows_to_matrix(self, rows: list[list[str]]) -> tuple[np.ndarray, np.ndarray]:
        """Parsed rows -> (predictors [N,P] f32 with NaN missing, target)."""
        from oryx_tpu_torch.apps.schema import encode_matrix

        return encode_matrix(self.schema, self.encodings, rows)

    def bin_matrix(self, x: np.ndarray) -> np.ndarray:
        binned = np.empty_like(x, dtype=np.int32)
        for j in range(x.shape[1]):
            binned[:, j] = bin_column(x[:, j], self.edges[j], int(self.n_bins[j]))
        return binned

    def datum_to_binned(self, datum: str) -> np.ndarray:
        # rows shorter than the schema (e.g. no target column) are fine:
        # encode_matrix NaN-fills any cell the row does not cover
        x, _ = self.rows_to_matrix([parse_input_line(datum)])
        return self.bin_matrix(x)

    # -- prediction --------------------------------------------------------

    def predict_datum(self, datum: str):
        """-> (predicted value/category string, probability dist or None)."""
        leaves = self.terminal_nodes(self.datum_to_binned(datum))
        with self._lock:
            if self.forest.is_classification:
                probs = class_probs_from_leaves(self.forest, leaves)[0]
                code = int(np.argmax(probs))
                value = self.encodings.decode(self.schema.target_index, code)
                return value, probs
            value = float(regression_from_leaves(self.forest, leaves)[0])
            return value, None

    def terminal_nodes(self, binned: np.ndarray) -> np.ndarray:
        """[T, N] terminal heap slots, routed on the device."""
        x = torch.from_numpy(np.ascontiguousarray(binned, dtype=np.int32))
        return route_binned_device(
            self._feature_d, self._split_d, x.to(self.device),
            self.forest.max_depth,
        ).cpu().numpy()

    # -- speed/serving mutation (UP messages) ------------------------------

    def update_classification_leaf(
        self, tree: int, node_id: str, counts: dict[str, int]
    ) -> None:
        """Add per-class-encoding counts to a terminal node
        (CategoricalPrediction.update via RDFServingModelManager.java:69-76)."""
        slot = node_id_to_heap(node_id)
        with self._lock:
            for enc, count in counts.items():
                self.forest.class_counts[tree, slot, int(enc)] += int(count)

    def update_regression_leaf(
        self, tree: int, node_id: str, mean: float, count: int
    ) -> None:
        """Fold a (mean, count) summary into a terminal node's running mean
        (NumericPrediction.update via RDFServingModelManager.java:77-82)."""
        slot = node_id_to_heap(node_id)
        with self._lock:
            stats = self.forest.leaf_stats[tree, slot]
            stats[0] += count
            stats[1] += mean * count

    def feature_importance(self) -> list[float]:
        return [float(v) for v in self.forest.feature_importances]


def tokens_to_features(schema: InputSchema, tokens: list[str]) -> tuple[dict, str | None]:
    """CSV tokens -> ({feature name: raw token}, target token or None) for
    predicate-tree evaluation of imported PMML forests. Inactive/target/
    empty fields are omitted from the feature dict."""
    names = schema.feature_names
    features: dict = {}
    target: str | None = None
    for i, tok in enumerate(tokens):
        if i >= len(names):
            break
        if schema.is_target(i):
            target = tok if tok != "" else None
        elif schema.is_active(i) and tok != "":
            features[names[i]] = tok
    return features, target


def node_id(slot: int) -> str:
    return heap_to_node_id(slot)
