"""Batch ML harness: hyperparameter search + candidate build/eval loop.

The port's copy of oryx_tpu/ml (the counterpart of framework/oryx-ml,
MLUpdate.java + ml/param/*): per generation, choose hyperparameter combos,
build and evaluate each candidate, publish the winner atomically, stream it
to the update topic.
"""

from oryx_tpu_torch.ml.hyperparams import (
    ContinuousAround,
    ContinuousRange,
    DiscreteAround,
    DiscreteRange,
    HyperParamRange,
    Unordered,
    choose_combos,
    from_config_value,
    grid_search,
    random_search,
)
from oryx_tpu_torch.ml.update import MLUpdate
