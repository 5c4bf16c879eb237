"""RDF speed tier: per-micro-batch terminal-node statistics (the port of
oryx_tpu/apps/rdf/speed.py).

Mirrors RDFSpeedModelManager (app/oryx-app .../speed/rdf/
RDFSpeedModelManager.java:68-148): "UP" is ignored (hearing our own
updates), MODEL(-REF) replaces the local forest, and build_updates routes
every example down every tree — one [T,N] routing pass on the card
(``RDFModel.terminal_nodes``) instead of the reference's per-example
flatMap — groups targets by (tree,
terminal node), and emits ("UP", message) pairs whose JSON payloads are
byte-compatible with the reference wire format:
  classification: [treeID, nodeID, {targetEncoding: count}]
  regression:     [treeID, nodeID, mean, count]
(imported PMML forests emit label-keyed counts instead — the key space
their serving counterpart folds by).
"""

from __future__ import annotations

import json
import logging

import numpy as np

from oryx_tpu_torch.api import AbstractSpeedModelManager
from oryx_tpu_torch.common.artifact import read_artifact_from_update
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_input_line
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.rdf import heap_to_node_id
from oryx_tpu_torch.apps.rdf.common import RDFModel, artifact_to_model
from oryx_tpu_torch.apps.schema import InputSchema

log = logging.getLogger(__name__)


class RDFSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config: Config, device=None):
        self.config = config
        self.schema = InputSchema(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        self.model: RDFModel | None = None
        self.pmml_forest = None  # imported reference forest (common/pmml.py)

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == "UP":
            return  # hearing our own updates
        if key in ("MODEL", "MODEL-REF"):
            art = read_artifact_from_update(key, message)
            if art.app == "rdf-pmml":
                from oryx_tpu_torch.common.pmml import PredicateForest

                self.pmml_forest = PredicateForest.from_artifact(art)
                self.model = None
                log.info(
                    "imported PMML model loaded: %d trees", len(self.pmml_forest.trees)
                )
            else:
                self.model = artifact_to_model(art, self.schema, device=self.device)
                self.pmml_forest = None
                log.info(
                    "new model loaded: %d trees, depth %d",
                    self.model.forest.num_trees,
                    self.model.forest.max_depth,
                )
        else:
            raise ValueError(f"bad key: {key}")

    def _build_updates_pmml(self, forest, new_data):
        """Route each example through the imported predicate forest and emit
        label-keyed per-(tree, node) stats — the key space its serving-side
        counterpart (PMMLForestServingModel) folds by."""
        from oryx_tpu_torch.apps.rdf.common import tokens_to_features

        stats: dict[tuple[int, str], list] = {}
        for km in new_data:
            try:
                tokens = parse_input_line(km.message)
            except ValueError:
                continue
            features, target = tokens_to_features(self.schema, tokens)
            if target is None:
                continue
            for t, nid in enumerate(forest.terminal_ids(features)):
                if nid is not None:
                    stats.setdefault((t, nid), []).append(target)
        out = []
        for (t, nid), targets in sorted(stats.items()):
            if forest.is_classification:
                counts: dict[str, int] = {}
                for v in targets:
                    counts[v] = counts.get(v, 0) + 1
                out.append(("UP", json.dumps([t, nid, counts])))
            else:
                # tolerate unparseable targets like the native path's
                # NaN-drop (keep = ~np.isnan(y)) — one bad record must not
                # poison the micro-batch retry loop
                values = []
                for v in targets:
                    try:
                        values.append(float(v))
                    except ValueError:
                        continue
                if values:
                    out.append(
                        ("UP", json.dumps([t, nid, float(np.mean(values)), len(values)]))
                    )
        return out

    def build_updates(self, new_data):
        # snapshot both models once: the update-listener thread swaps them
        pmml_forest = self.pmml_forest
        if pmml_forest is not None:
            return self._build_updates_pmml(pmml_forest, new_data)
        model = self.model
        if model is None:
            return []
        rows = []
        for km in new_data:
            try:
                rows.append(parse_input_line(km.message))
            except ValueError:
                continue
        if not rows:
            return []
        x, y = model.rows_to_matrix(rows)
        keep = ~np.isnan(y)
        x, y = x[keep], y[keep]
        if len(y) == 0:
            return []
        binned = model.bin_matrix(x)
        leaves = model.terminal_nodes(binned)  # [T, N]
        classification = model.forest.is_classification

        out = []
        for t in range(leaves.shape[0]):
            for slot in np.unique(leaves[t]):
                targets = y[leaves[t] == slot]
                nid = heap_to_node_id(int(slot))
                if classification:
                    codes, counts = np.unique(targets.astype(np.int64), return_counts=True)
                    payload = {str(int(c)): int(n) for c, n in zip(codes, counts)}
                    out.append(("UP", json.dumps([t, nid, payload])))
                else:
                    out.append(
                        (
                            "UP",
                            json.dumps(
                                [t, nid, float(np.mean(targets)), int(len(targets))]
                            ),
                        )
                    )
        return out
