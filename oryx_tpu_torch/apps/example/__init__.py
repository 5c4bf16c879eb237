"""Tutorial "wordcount" application — the minimal custom app showing the
three-tier SPI without any ML, mirroring app/example in the reference
(the port's copy of oryx_tpu/apps/example; host code only)."""

from oryx_tpu_torch.apps.example.batch import ExampleBatchLayerUpdate
from oryx_tpu_torch.apps.example.serving import ExampleServingModelManager
from oryx_tpu_torch.apps.example.speed import ExampleSpeedModelManager

__all__ = [
    "ExampleBatchLayerUpdate",
    "ExampleServingModelManager",
    "ExampleSpeedModelManager",
]
