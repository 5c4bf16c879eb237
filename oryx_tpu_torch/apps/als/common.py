"""Shared ALS app plumbing for the serving slice: the config view and the
update-payload parser (the port's copy of the parts of
oryx_tpu/apps/als/common.py that serving reads; event parsing belongs to the
batch/speed slice).

Update-topic payloads are JSON arrays: ["X", id, [vector], [knownItems]] and
["Y", id, [vector]] (reference ALSUpdate.publishAdditionalModelData /
ALSSpeedModelManager.buildUpdates payload shapes).
"""

from __future__ import annotations

from dataclasses import dataclass

from oryx_tpu_torch.apps.updates import parse_update_message  # noqa: F401 - re-exported API
from oryx_tpu_torch.common.config import Config


@dataclass
class ALSConfig:
    implicit: bool
    log_strength: bool
    epsilon: float
    decay_factor: float
    zero_threshold: float
    no_known_items: bool
    features: object
    lam: object
    alpha: object
    iterations: int
    sample_rate: float
    approx_recall: float
    compute_dtype: str
    checkpoint_interval: int
    candidate_partitions: int
    lsh_max_bits_differing: int | None

    @staticmethod
    def from_config(config: Config) -> "ALSConfig":
        g = lambda k, d=None: config.get(f"oryx.als.{k}", d)
        return ALSConfig(
            implicit=bool(g("implicit", True)),
            log_strength=bool(g("logStrength", False)),
            epsilon=float(g("epsilon", 1.0)),
            decay_factor=float(g("decay.factor", 1.0)),
            zero_threshold=float(g("decay.zero-threshold", 0.0)),
            no_known_items=bool(g("no-known-items", False)),
            features=g("hyperparams.features", 10),
            lam=g("hyperparams.lambda", 0.001),
            alpha=g("hyperparams.alpha", 1.0),
            iterations=int(g("hyperparams.iterations", 10)),
            sample_rate=float(g("sample-rate", 1.0)),
            approx_recall=_valid_recall(float(g("approx-recall", 1.0))),
            compute_dtype=_valid_compute_dtype(str(g("compute-dtype", "float32"))),
            checkpoint_interval=int(g("checkpoint-interval", 0)),
            candidate_partitions=_valid_nonneg(
                "candidate-partitions", int(g("candidate-partitions", 0))
            ),
            lsh_max_bits_differing=_valid_lsh_bits(g("lsh-max-bits-differing", None)),
        )


def _valid_nonneg(key: str, value: int) -> int:
    """Fail at config load, not on the first /recommend request."""
    if value < 0:
        raise ValueError(f"oryx.als.{key} must be >= 0, got {value}")
    return value


def _valid_lsh_bits(raw) -> int | None:
    if raw is None:
        return None
    return _valid_nonneg("lsh-max-bits-differing", int(raw))


def _valid_recall(value: float) -> float:
    """Fail at config load, not on the first /recommend request."""
    if not (0.0 < value <= 1.0):
        raise ValueError(
            f"oryx.als.approx-recall must be in (0, 1], got {value!r}"
        )
    return value


def _valid_compute_dtype(value: str) -> str:
    if value not in ("float32", "bfloat16"):
        raise ValueError(
            f"oryx.als.compute-dtype must be 'float32' or 'bfloat16', got {value!r}"
        )
    return value
