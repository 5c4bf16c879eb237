"""Shared k-means app pieces: config, datum vectorization, update codec
(the port's copy of oryx_tpu/apps/kmeans/common.py).

Parity notes: vectorization mirrors KMeansUtils.featuresFromTokens
(app/oryx-app-common .../kmeans/KMeansUtils.java) — active schema features
parsed as doubles into predictor order; the UP message is the
`[clusterID, center, count]` JSON of KMeansSpeedModelManager.java:78-120.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_input_line
from oryx_tpu_torch.apps.schema import InputSchema


@dataclass
class KMeansConfig:
    init_strategy: str
    eval_strategy: str
    iterations: int
    runs: int
    k: object  # hyperparam range value

    @classmethod
    def from_config(cls, config: Config) -> "KMeansConfig":
        g = lambda key, d=None: config.get(f"oryx.kmeans.{key}", d)
        return cls(
            init_strategy=str(g("initialization-strategy", "k-means||")),
            eval_strategy=str(g("evaluation-strategy", "SILHOUETTE")).upper(),
            iterations=int(g("iterations", 30)),
            runs=int(g("runs", 1)),
            k=g("hyperparams.k", 10),
        )


def vectorize_rows(schema: InputSchema, lines) -> np.ndarray:
    """CSV/JSON lines -> [N,P] float32 predictor matrix; rows with
    unparseable or missing numeric values are dropped (the reference throws
    per-datum and the Spark lambda filters nulls)."""
    out = []
    p = schema.num_predictors
    for line in lines:
        try:
            tok = parse_input_line(line)
        except ValueError:
            continue
        if len(tok) < schema.num_features:
            continue
        row = np.empty(p, dtype=np.float32)
        ok = True
        for j in range(p):
            fi = schema.predictor_to_feature_index(j)
            try:
                row[j] = float(tok[fi])
            except (ValueError, IndexError):
                ok = False
                break
        if ok and not np.isnan(row).any():
            out.append(row)
    return np.stack(out) if out else np.zeros((0, p), dtype=np.float32)


def cluster_update_message(cluster_id: int, center: np.ndarray, count: int) -> tuple[str, str]:
    return "UP", json.dumps(
        [int(cluster_id), [float(v) for v in np.asarray(center)], int(count)]
    )


def parse_cluster_update(message: str) -> tuple[int, np.ndarray, int]:
    arr = json.loads(message)
    return int(arr[0]), np.asarray(arr[1], dtype=np.float64), int(arr[2])
