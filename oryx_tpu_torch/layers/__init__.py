"""Layer runtimes: the batch and speed halves of the lambda architecture
(the port's copy of oryx_tpu/layers).

The batch layer re-trains a full model from all history on a long cadence;
the speed layer folds micro-batches into incremental update messages on a
short cadence; both read the input topic and write the update topic,
persisting stream positions so restarts resume (the ZK-offset pattern of
UpdateOffsetsFn.java). The heavy compute happens in the app's torch ops on
the card, not in the carrier runtime.
"""

from oryx_tpu_torch.layers.batch import BatchLayer
from oryx_tpu_torch.layers.speed import SpeedLayer
from oryx_tpu_torch.layers.datastore import load_all_data, save_generation
