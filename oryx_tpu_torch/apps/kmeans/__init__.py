from oryx_tpu_torch.apps.kmeans.batch import KMeansUpdate
from oryx_tpu_torch.apps.kmeans.speed import KMeansSpeedModelManager
from oryx_tpu_torch.apps.kmeans.serving import KMeansServingModel, KMeansServingModelManager

__all__ = [
    "KMeansUpdate",
    "KMeansSpeedModelManager",
    "KMeansServingModel",
    "KMeansServingModelManager",
]
