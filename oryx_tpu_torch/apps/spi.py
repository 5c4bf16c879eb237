"""The packaged-app SPI registry (the port's copy of oryx_tpu/apps/spi.py).

An app is three config-named classes plus its serving resource modules —
the contract the framework layers load reflectively:

  - batch:   a BatchLayerUpdate named by ``oryx.batch.update-class``
  - speed:   a SpeedModelManager named by ``oryx.speed.model-manager-class``
  - serving: a ServingModelManager named by
             ``oryx.serving.model-manager-class``, plus route modules in
             ``oryx.serving.application-resources``

``--app <name>`` on the CLI overlays all four keys from the app's AppSpec.
Specs are plain dotted strings naming the port's own classes — importing
this module loads NO app code. The JAX package's example (wordcount) app
is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class AppSpec:
    """One packaged app's wiring, as the config keys would spell it."""

    name: str
    batch_update: str | None             # oryx.batch.update-class
    speed_manager: str | None            # oryx.speed.model-manager-class
    serving_manager: str                 # oryx.serving.model-manager-class
    serving_resources: tuple[str, ...]   # oryx.serving.application-resources
    description: str = ""
    # Minimal config overlay that makes the classes constructible (the
    # schema-driven apps need an input schema before __init__ succeeds)
    example_overlay: dict = field(default_factory=dict)


_REGISTRY: dict[str, AppSpec] = {}


def register_app(spec: AppSpec) -> AppSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"app {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_app(name: str) -> AppSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown app {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def all_apps() -> dict[str, AppSpec]:
    return dict(_REGISTRY)


def app_overlay(name: str) -> dict:
    """The config overlay that wires an app's three classes + resources —
    what ``--app <name>`` applies underneath any explicit ``--set``s."""
    spec = get_app(name)
    return {
        "oryx.batch.update-class": spec.batch_update,
        "oryx.speed.model-manager-class": spec.speed_manager,
        "oryx.serving.model-manager-class": spec.serving_manager,
        "oryx.serving.application-resources": list(spec.serving_resources),
    }


# ---- the packaged apps -----------------------------------------------------

register_app(AppSpec(
    name="als",
    batch_update="oryx_tpu_torch.apps.als.batch.ALSUpdate",
    speed_manager="oryx_tpu_torch.apps.als.speed.ALSSpeedModelManager",
    serving_manager="oryx_tpu_torch.apps.als.serving.ALSServingModelManager",
    serving_resources=(
        "oryx_tpu_torch.serving.resources.common",
        "oryx_tpu_torch.serving.resources.als",
    ),
    description="implicit/explicit-feedback matrix-factorization recommender",
))

register_app(AppSpec(
    name="kmeans",
    batch_update="oryx_tpu_torch.apps.kmeans.batch.KMeansUpdate",
    speed_manager="oryx_tpu_torch.apps.kmeans.speed.KMeansSpeedModelManager",
    serving_manager="oryx_tpu_torch.apps.kmeans.serving.KMeansServingModelManager",
    serving_resources=(
        "oryx_tpu_torch.serving.resources.common",
        "oryx_tpu_torch.serving.resources.clustering",
    ),
    description="k-means|| clustering",
    example_overlay={
        "oryx.input-schema.num-features": 2,
        "oryx.input-schema.numeric-features": ["0", "1"],
    },
))

register_app(AppSpec(
    name="rdf",
    batch_update="oryx_tpu_torch.apps.rdf.batch.RDFUpdate",
    speed_manager="oryx_tpu_torch.apps.rdf.speed.RDFSpeedModelManager",
    serving_manager="oryx_tpu_torch.apps.rdf.serving.RDFServingModelManager",
    serving_resources=(
        "oryx_tpu_torch.serving.resources.common",
        "oryx_tpu_torch.serving.resources.classreg",
    ),
    description="random-decision-forest classification/regression",
    example_overlay={
        "oryx.input-schema.feature-names": ["a", "b", "label"],
        "oryx.input-schema.numeric-features": ["a", "b"],
        "oryx.input-schema.categorical-features": ["label"],
        "oryx.input-schema.target-feature": "label",
    },
))

register_app(AppSpec(
    name="seq",
    batch_update="oryx_tpu_torch.apps.seq.batch.SeqUpdate",
    speed_manager="oryx_tpu_torch.apps.seq.speed.SeqSpeedModelManager",
    serving_manager="oryx_tpu_torch.apps.seq.serving.SeqServingModelManager",
    serving_resources=(
        "oryx_tpu_torch.serving.resources.common",
        "oryx_tpu_torch.serving.resources.seq",
    ),
    description="streaming session next-item recommender (GRU)",
))
