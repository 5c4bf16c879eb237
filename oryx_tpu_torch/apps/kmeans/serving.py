"""k-means serving tier: in-memory cluster model + manager (the port of
oryx_tpu/apps/kmeans/serving.py).

Mirrors KMeansServingModel / KMeansServingModelManager (app/
oryx-app-serving .../kmeans/model/): nearest-cluster assignment for
/assign and /distanceToNearest, live centroid replacement from speed-tier
UP `[clusterID, center, count]` messages, fraction_loaded = 1 once any
model is present.

The model keeps an f32 copy of the centers on the card beside the f64 host
master; every request scores against the card copy. A MODEL/MODEL-REF
builds both, and each UP replaces the copy (copy-on-write, under the
model's lock), so a request scores against one consistent set of centers.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from oryx_tpu_torch.api import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common.artifact import read_artifact_from_update
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_input_line
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.kmeans import assign_clusters
from oryx_tpu_torch.apps.kmeans.common import parse_cluster_update
from oryx_tpu_torch.apps.schema import InputSchema

log = logging.getLogger(__name__)


class KMeansServingModel(ServingModel):
    def __init__(
        self, centers: np.ndarray, counts: np.ndarray, schema: InputSchema,
        device=None,
    ):
        self._lock = threading.Lock()
        self.centers = np.array(centers, dtype=np.float64)
        self.counts = np.array(counts, dtype=np.int64)
        self.schema = schema
        self.device = resolve_device(device)
        self._centers_d = torch.from_numpy(
            self.centers.astype(np.float32)).to(self.device)

    def fraction_loaded(self) -> float:
        return 1.0

    @property
    def num_clusters(self) -> int:
        return len(self.centers)

    def vectorize(self, datum: str) -> np.ndarray:
        tok = parse_input_line(datum)
        if len(tok) != self.schema.num_features:
            raise ValueError(
                f"expected {self.schema.num_features} features, got {len(tok)}"
            )
        vec = np.empty(self.schema.num_predictors, dtype=np.float32)
        for j in range(self.schema.num_predictors):
            vec[j] = float(tok[self.schema.predictor_to_feature_index(j)])
        return vec

    def closest_cluster(self, vector: np.ndarray) -> tuple[int, float]:
        with self._lock:
            centers = self._centers_d
        ids, dist = assign_clusters(
            np.asarray(vector, dtype=np.float32)[None, :], centers,
            device=self.device,
        )
        return int(ids[0]), float(dist[0])

    def update(self, cluster_id: int, center: np.ndarray, count: int) -> None:
        with self._lock:
            if 0 <= cluster_id < len(self.centers):
                self.centers[cluster_id] = center
                self.counts[cluster_id] = count
                row = torch.from_numpy(
                    np.asarray(center, dtype=np.float32)).to(self.device)
                centers = self._centers_d.clone()
                centers[cluster_id] = row
                self._centers_d = centers


class KMeansServingModelManager(AbstractServingModelManager):
    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.schema = InputSchema(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        self.model: KMeansServingModel | None = None

    def get_model(self) -> KMeansServingModel | None:
        return self.model

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == "UP":
            if self.model is None:
                return  # no model to interpret with yet
            cid, center, count = parse_cluster_update(message)
            self.model.update(cid, center, count)
        elif key in ("MODEL", "MODEL-REF"):
            art = read_artifact_from_update(key, message)
            centers = np.asarray(art.tensors["centers"])
            counts = np.asarray(
                art.content.get("counts", [1] * len(centers)), dtype=np.int64
            )
            self.model = KMeansServingModel(
                centers, counts, self.schema, device=self.device)
            log.info("new model loaded: %d clusters", len(centers))
        else:
            raise ValueError(f"bad key: {key}")
