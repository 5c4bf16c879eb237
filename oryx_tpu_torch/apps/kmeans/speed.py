"""k-means speed tier: per-micro-batch centroid shifts (the port of
oryx_tpu/apps/kmeans/speed.py).

Mirrors KMeansSpeedModelManager (app/oryx-app .../speed/kmeans/
KMeansSpeedModelManager.java:55-125): "UP" messages are ignored (hearing
our own updates — the serving tier applies them); MODEL(-REF) replaces the
local model; build_updates assigns each datum to its closest cluster, one
batched device call for the whole window, reduces per-cluster (mean, count),
applies ClusterInfo.update to the local copy, and emits
[clusterID, newCenter, newCount] messages. The window's assignment runs on
the card (``assign_clusters``); the per-cluster means and the update are
the JAX package's numpy, so the messages match it.
"""

from __future__ import annotations

import logging

import numpy as np

from oryx_tpu_torch.api import AbstractSpeedModelManager
from oryx_tpu_torch.common.artifact import read_artifact_from_update
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.kmeans import assign_clusters, online_update
from oryx_tpu_torch.apps.kmeans.common import cluster_update_message, vectorize_rows
from oryx_tpu_torch.apps.schema import InputSchema

log = logging.getLogger(__name__)


class KMeansSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config: Config, device=None):
        self.config = config
        self.schema = InputSchema(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        # (centers [K,D] f64, counts [K] i64) published as ONE attribute so
        # a reader can never pair new centers with old counts
        self._model: tuple[np.ndarray, np.ndarray] | None = None

    @property
    def centers(self) -> np.ndarray | None:
        return self._model[0] if self._model else None

    @property
    def counts(self) -> np.ndarray | None:
        return self._model[1] if self._model else None

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == "UP":
            return  # hearing our own updates
        if key in ("MODEL", "MODEL-REF"):
            art = read_artifact_from_update(key, message)
            centers = np.asarray(art.tensors["centers"], dtype=np.float64)
            counts = art.content.get("counts")
            self._model = (
                centers,
                np.asarray(counts, dtype=np.int64)
                if counts is not None
                else np.ones(len(centers), dtype=np.int64),
            )
            log.info("new model loaded: %d clusters", len(centers))
        else:
            raise ValueError(f"bad key: {key}")

    def build_updates(self, new_data):
        # snapshot: the listener thread may swap in a new model (possibly a
        # different k) mid-batch; compute the whole window against one model
        model = self._model
        if model is None:
            return []
        centers, counts = model
        points = vectorize_rows(self.schema, (km.message for km in new_data))
        if len(points) == 0:
            return []
        ids, _ = assign_clusters(
            points, centers.astype(np.float32), device=self.device
        )
        ids = ids.cpu().numpy()
        out = []
        for c in np.unique(ids):
            members = points[ids == c]
            new_center, new_total = online_update(
                centers[c], int(counts[c]), members.mean(axis=0), len(members)
            )
            centers[c] = new_center
            counts[c] = new_total
            out.append(cluster_update_message(int(c), new_center, new_total))
        return out
