"""PMML import: read models published by the reference into artifacts
(the port's copy of oryx_tpu/common/pmml.py).

The reference publishes every model as PMML 4.3 (PMMLUtils, framework/
oryx-common .../pmml/PMMLUtils.java:45-135): ALS as a skeleton whose
Extensions carry hyperparams + factor-file paths (ALSUpdate.java:429-472),
k-means as a ClusteringModel with per-cluster center arrays and sizes
(KMeansUpdate.java:178-215), and random forests as a MiningModel holding a
Segmentation of TreeModels whose nodes use SimplePredicate GREATER_THAN /
SimpleSetPredicate IS_NOT_IN splits with per-node scores, record counts and
score distributions (RDFUpdate.java:379-538). This module parses those
documents so a deployment can migrate to this framework without
retraining: k-means imports into the native artifact (tensors.centers +
content.counts), ALS into an extensions-only skeleton, and forests into a
host-side PredicateForest evaluator (prediction parity; new training runs
produce the native vectorized forest instead).
"""

from __future__ import annotations

import threading
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from oryx_tpu_torch.common.artifact import ModelArtifact


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _children(el, name: str):
    return [c for c in el if _local(c.tag) == name]


def _find(el, name: str):
    for c in el:
        if _local(c.tag) == name:
            return c
    return None


def _iter_all(el, name: str):
    for c in el.iter():
        if _local(c.tag) == name:
            yield c


def pmml_to_artifact(xml: str) -> ModelArtifact:
    """Parse a reference-published PMML document into a ModelArtifact.
    Raises ValueError for documents with no recognizable model."""
    root = ET.fromstring(xml)
    if _local(root.tag) != "PMML":
        raise ValueError(f"not a PMML document: root <{_local(root.tag)}>")

    extensions: dict = {}
    for ext in _children(root, "Extension"):
        name = ext.get("name")
        if name is None:
            continue
        value = ext.get("value")
        if value is not None:
            extensions[name] = value
        else:
            # the reference stores id lists as whitespace-separated content
            extensions[name] = (ext.text or "").split()

    clustering = _find(root, "ClusteringModel")
    if clustering is not None:
        return _clustering_to_artifact(clustering, extensions)

    mining = _find(root, "MiningModel")
    if mining is None:
        tree = _find(root, "TreeModel")
        if tree is not None:
            trees, weights = [_tree_to_dict(tree)], [1.0]
            fn = tree.get("functionName", "classification")
            return _forest_artifact(trees, weights, fn, extensions)
        if extensions:
            # ALS publishes a model-less skeleton: extensions carry
            # everything (factor paths, hyperparams, id lists)
            return ModelArtifact("als", extensions=extensions)
        raise ValueError("PMML document contains no supported model")
    return _mining_to_artifact(mining, extensions)


def _clustering_to_artifact(el, extensions) -> ModelArtifact:
    centers, counts, ids = [], [], []
    for cl in _children(el, "Cluster"):
        arr = _find(cl, "Array")
        if arr is None:
            continue
        centers.append([float(v) for v in (arr.text or "").split()])
        counts.append(int(float(cl.get("size", 0) or 0)))
        ids.append(cl.get("id", str(len(ids))))
    if not centers:
        raise ValueError("ClusteringModel has no clusters")
    art = ModelArtifact(
        "kmeans",
        extensions=extensions,
        tensors={"centers": np.asarray(centers, dtype=np.float32)},
    )
    art.content["counts"] = counts
    art.content["clusterIDs"] = ids
    return art


def _predicate_to_dict(el) -> dict | None:
    name = _local(el.tag)
    if name == "True":
        return {"op": "true"}
    if name == "False":
        return {"op": "false"}
    if name == "SimplePredicate":
        return {
            "op": el.get("operator"),
            "field": el.get("field"),
            "value": el.get("value"),
        }
    if name == "SimpleSetPredicate":
        arr = _find(el, "Array")
        values = _parse_string_array(arr)
        return {
            "op": el.get("booleanOperator"),
            "field": el.get("field"),
            "values": values,
        }
    return None


def _parse_string_array(arr) -> list[str]:
    """PMML string arrays quote values containing spaces; the reference's
    categorical sets are plain tokens, so token-split with quote stripping
    covers both."""
    if arr is None or not arr.text:
        return []
    import re

    return [
        t[1:-1] if t.startswith('"') and t.endswith('"') else t
        for t in re.findall(r'"[^"]*"|\S+', arr.text)
    ]


def _tree_to_dict(tree_el) -> dict:
    root = _find(tree_el, "Node")
    if root is None:
        raise ValueError("TreeModel has no root Node")
    return _node_to_dict(root)


def _node_to_dict(el) -> dict:
    node: dict = {"id": el.get("id")}
    if el.get("score") is not None:
        node["score"] = el.get("score")
    if el.get("recordCount") is not None:
        node["recordCount"] = float(el.get("recordCount"))
    dist = [
        {"value": sd.get("value"), "recordCount": float(sd.get("recordCount", 0))}
        for sd in _children(el, "ScoreDistribution")
    ]
    if dist:
        node["distribution"] = dist
    children = []
    for child in _children(el, "Node"):
        pred = None
        for c in child:
            tag = _local(c.tag)
            if tag in ("ScoreDistribution", "Node", "Extension"):
                continue
            pred = _predicate_to_dict(c)
            if pred is None:
                # fabricating an always-true split here would silently
                # misroute every datum — fail the import instead
                raise ValueError(f"unsupported PMML predicate element: <{tag}>")
            break
        if pred is None:
            raise ValueError(f"PMML Node {child.get('id')!r} has no predicate")
        children.append({"predicate": pred, "node": _node_to_dict(child)})
    if children:
        node["children"] = children
    return node


def _mining_to_artifact(el, extensions) -> ModelArtifact:
    seg = _find(el, "Segmentation")
    if seg is None:
        raise ValueError("MiningModel has no Segmentation")
    trees, weights = [], []
    for s in _children(seg, "Segment"):
        tm = _find(s, "TreeModel")
        if tm is None:
            continue
        trees.append(_tree_to_dict(tm))
        weights.append(float(s.get("weight", 1.0)))
    if not trees:
        raise ValueError("Segmentation has no TreeModels")
    return _forest_artifact(trees, weights, el.get("functionName", "classification"), extensions)


def _forest_artifact(trees, weights, function_name, extensions) -> ModelArtifact:
    art = ModelArtifact("rdf-pmml", extensions=extensions)
    art.content["trees"] = trees
    art.content["weights"] = weights
    art.content["functionName"] = function_name
    return art


# ---------------------------------------------------------------------------
# host evaluator for imported predicate forests
# ---------------------------------------------------------------------------


@dataclass
class PredicateForest:
    """Evaluates an imported reference forest on host: per datum walk each
    tree by predicate (the reference's DecisionTree.findTerminal,
    app/oryx-app-common .../rdf/tree/DecisionTree.java:38-63), then combine
    votes weighted by tree weight (DecisionForest.predict semantics:
    weighted majority vote for classification, weighted average for
    regression)."""

    trees: list[dict]
    weights: list[float]
    is_classification: bool = True
    # guards node-dict mutation (UP folding from the bus listener thread)
    # against concurrent predict traversals from HTTP request threads —
    # the native RDFModel keeps the same discipline with its own lock
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @classmethod
    def from_artifact(cls, art: ModelArtifact) -> "PredicateForest":
        if art.app != "rdf-pmml":
            raise ValueError(f"not an imported PMML forest: app={art.app}")
        return cls(
            trees=art.content["trees"],
            weights=[float(w) for w in art.content["weights"]],
            is_classification=art.content.get("functionName") != "regression",
        )

    def _matches(self, pred: dict, features: dict) -> bool:
        op = pred.get("op")
        if op == "true":
            return True
        if op == "false":
            return False
        value = features.get(pred.get("field"))
        if value is None:
            return False
        if op == "greaterThan":
            return float(value) > float(pred["value"])
        if op == "greaterOrEqual":
            return float(value) >= float(pred["value"])
        if op == "lessThan":
            return float(value) < float(pred["value"])
        if op == "lessOrEqual":
            return float(value) <= float(pred["value"])
        if op == "equal":
            return str(value) == pred["value"]
        if op == "isIn":
            return str(value) in pred["values"]
        if op == "isNotIn":
            return str(value) not in pred["values"]
        raise ValueError(f"unsupported PMML predicate operator: {op}")

    def _terminal(self, tree: dict, features: dict) -> dict:
        node = tree
        while "children" in node:
            for child in node["children"]:
                if self._matches(child["predicate"], features):
                    node = child["node"]
                    break
            else:
                # nothing matched (e.g. a missing feature fails both the
                # positive predicate and its complement): descend into the
                # last child — the reference's negative/default branch
                # (RDFUpdate.java writes positive first, negative second) —
                # so every datum still reaches a leaf
                node = node["children"][-1]["node"]
        return node

    def terminal_ids(self, features: dict) -> list[str]:
        """Terminal node id per tree — the speed tier's routing pass
        (RDFSpeedModelManager groups micro-batch targets by (tree, node))."""
        with self._lock:
            return [self._terminal(t, features).get("id") for t in self.trees]

    def _find_node(self, tree_idx: int, node_id: str) -> dict | None:
        stack = [self.trees[tree_idx]]
        while stack:
            node = stack.pop()
            if node.get("id") == node_id:
                return node
            for child in node.get("children", ()):
                stack.append(child["node"])
        return None

    def update_classification_leaf(self, tree_idx: int, node_id: str, counts: dict) -> None:
        """Fold speed-layer [treeID, nodeID, counts] updates into the node's
        score distribution (RDFServingModelManager.java:57-84 — PMML node
        ids are the reference's own +/- path strings, so live updates keep
        working against an imported forest)."""
        with self._lock:
            node = self._find_node(tree_idx, node_id)
            if node is None:
                return
            dist = node.setdefault("distribution", [])
            by_value = {d["value"]: d for d in dist}
            for value, count in counts.items():
                entry = by_value.get(str(value))
                if entry is None:
                    dist.append({"value": str(value), "recordCount": float(count)})
                else:
                    entry["recordCount"] += float(count)

    def update_regression_leaf(self, tree_idx: int, node_id: str, mean: float, count: int) -> None:
        """Running-mean fold of a (mean, count) summary into the node score
        (NumericPrediction.update semantics)."""
        with self._lock:
            node = self._find_node(tree_idx, node_id)
            if node is None:
                return
            old_count = float(node.get("recordCount", 0.0))
            old_score = float(node.get("score", 0.0) or 0.0)
            total = old_count + count
            if total <= 0:
                return
            node["score"] = str((old_score * old_count + mean * count) / total)
            node["recordCount"] = total

    def predict(self, features: dict):
        """Classification: (label, distribution dict). Regression: float."""
        with self._lock:
            return self._predict_locked(features)

    def _predict_locked(self, features: dict):
        if self.is_classification:
            votes: dict[str, float] = {}
            for tree, w in zip(self.trees, self.weights):
                leaf = self._terminal(tree, features)
                dist = leaf.get("distribution")
                if dist:
                    total = sum(d["recordCount"] for d in dist) or 1.0
                    for d in dist:
                        votes[d["value"]] = votes.get(d["value"], 0.0) + w * (
                            d["recordCount"] / total
                        )
                elif leaf.get("score") is not None:
                    votes[leaf["score"]] = votes.get(leaf["score"], 0.0) + w
            if not votes:
                raise ValueError("no tree produced a prediction")
            total = sum(votes.values())
            dist = {k: v / total for k, v in votes.items()}
            return max(dist.items(), key=lambda kv: kv[1])[0], dist
        num = den = 0.0
        for tree, w in zip(self.trees, self.weights):
            leaf = self._terminal(tree, features)
            if leaf.get("score") is not None:
                num += w * float(leaf["score"])
                den += w
        if den == 0.0:
            raise ValueError("no tree produced a prediction")
        return num / den
