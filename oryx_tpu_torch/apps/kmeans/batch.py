"""k-means batch tier: full model rebuild per generation (the port of
oryx_tpu/apps/kmeans/batch.py).

Replaces KMeansUpdate (app/oryx-app-mllib .../kmeans/KMeansUpdate.java):
vectorize via InputSchema, train on the card (ops/kmeans.py Lloyd's with
k-means|| init; on a mesh when one is given or configured,
``oryx.compute.mesh.*``), publish an artifact holding the centers tensor + cluster
sizes, and evaluate with the configured strategy over train+test
(KMeansUpdate.java:135-173; DB and SSE negated so higher = better).
"""

from __future__ import annotations

from typing import Any, Sequence

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.artifact import ModelArtifact
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ml.update import MLUpdate
from oryx_tpu_torch.ops.kmeans import (
    davies_bouldin_index,
    dunn_index,
    silhouette_coefficient,
    sum_squared_error,
    train_kmeans,
)
from oryx_tpu_torch.apps.kmeans.common import KMeansConfig, vectorize_rows
from oryx_tpu_torch.apps.schema import InputSchema

class KMeansUpdate(MLUpdate):
    def __init__(self, config: Config, device=None, mesh=None):
        super().__init__(config)
        self.kmeans = KMeansConfig.from_config(config)
        self.schema = InputSchema(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        if mesh is None:
            from oryx_tpu_torch.parallel.distributed import mesh_from_config

            # None on one device with no oryx.compute.mesh.* shape
            mesh = mesh_from_config(config, device=self.device)
        self.mesh = mesh

    def hyperparam_ranges(self) -> dict[str, Any]:
        return {"k": self.kmeans.k}

    def build_model(
        self, train: Sequence[KeyMessage], hyperparams: dict[str, Any]
    ) -> ModelArtifact:
        points = vectorize_rows(self.schema, (km.message for km in train))
        if len(points) == 0:
            raise ValueError("no parseable points")
        m = train_kmeans(
            points,
            k=int(hyperparams["k"]),
            iterations=self.kmeans.iterations,
            init=self.kmeans.init_strategy,
            mesh=self._build_mesh(),
            runs=self.kmeans.runs,
            device=self.device,
        )
        art = ModelArtifact(
            "kmeans",
            extensions={"k": str(len(m.centers))},
            tensors={"centers": m.centers},
        )
        art.content["counts"] = [int(c) for c in m.counts]
        art.content["featureNames"] = self.schema.feature_names
        return art

    def evaluate(self, model: ModelArtifact, train, test) -> float:
        points = vectorize_rows(
            self.schema,
            (km.message for part in (train, test) for km in part),
        )
        if len(points) == 0:
            return float("nan")
        centers = model.tensors["centers"]
        strategy = self.kmeans.eval_strategy
        dev = self.device
        if strategy == "DAVIES_BOULDIN":
            return -davies_bouldin_index(points, centers, device=dev)
        if strategy == "DUNN":
            return dunn_index(points, centers, device=dev)
        if strategy == "SILHOUETTE":
            return silhouette_coefficient(points, centers, device=dev)
        if strategy == "SSE":
            return -sum_squared_error(points, centers, device=dev)
        raise ValueError(f"unknown evaluation strategy: {strategy}")
