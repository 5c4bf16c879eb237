"""Config-driven input schema + categorical value dictionaries (the
port's copy of oryx_tpu/apps/schema.py).

Parity with the reference's app-common schema tier (app/oryx-app-common
.../schema/InputSchema.java:37-278 and CategoricalValueEncodings.java):
the schema names each CSV column and designates id / ignored / categorical /
numeric / target roles; predictors are the active non-target features, with
bidirectional feature-index <-> predictor-index maps. Encodings assign each
categorical feature a stable value <-> int dictionary so datums become
dense numeric rows — the form every device op consumes.

Vectorized: `encode_matrix` vectorizes whole datasets to float32
numpy (NaN for missing), the host-side step before device placement;
the reference encodes row-at-a-time into LabeledPoint/Example objects.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from oryx_tpu_torch.common.config import Config


class InputSchema:
    def __init__(self, config: Config):
        names = list(config.get_list("oryx.input-schema.feature-names", []) or [])
        if not names:
            n = config.get_int("oryx.input-schema.num-features", 0)
            if n <= 0:
                raise ValueError("neither feature-names nor num-features is set")
            names = [str(i) for i in range(n)]
        if len(set(names)) != len(names):
            raise ValueError(f"feature names must be unique: {names}")
        self.feature_names: list[str] = names

        def name_set(key) -> set[str]:
            vals = set(map(str, config.get_list(key, []) or []))
            unknown = vals - set(names)
            if unknown:
                raise ValueError(f"{key} names unknown features: {sorted(unknown)}")
            return vals

        self.id_features = name_set("oryx.input-schema.id-features")
        ignored = name_set("oryx.input-schema.ignored-features")
        active = [n for n in names if n not in self.id_features and n not in ignored]
        self.active_features = set(active)

        # raw get(): a `null` in config must stay None (unset) — get_list
        # would coerce it to [], which is a *set but empty* designation
        numeric = config.get("oryx.input-schema.numeric-features", None)
        categorical = config.get("oryx.input-schema.categorical-features", None)
        if numeric is None and categorical is None:
            raise ValueError("neither numeric-features nor categorical-features set")
        if numeric is not None:
            self.numeric_features = set(map(str, numeric))
            if not self.numeric_features <= self.active_features:
                raise ValueError("numeric-features must be active features")
            self.categorical_features = self.active_features - self.numeric_features
        else:
            self.categorical_features = set(map(str, categorical))
            if not self.categorical_features <= self.active_features:
                raise ValueError("categorical-features must be active features")
            self.numeric_features = self.active_features - self.categorical_features

        target = config.get_string("oryx.input-schema.target-feature", None)
        if target is not None and target not in self.active_features:
            raise ValueError(f"target feature not active: {target}")
        self.target_feature = target
        self.target_index = names.index(target) if target else -1

        # feature index <-> predictor index (active, non-target)
        self._all_to_predictor: dict[int, int] = {}
        self._predictor_to_all: dict[int, int] = {}
        p = 0
        for i, n in enumerate(names):
            if n in self.active_features and i != self.target_index:
                self._all_to_predictor[i] = p
                self._predictor_to_all[p] = i
                p += 1

    # -- introspection (InputSchema.java accessors) -------------------------

    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    @property
    def num_predictors(self) -> int:
        return len(self._all_to_predictor)

    def has_target(self) -> bool:
        return self.target_feature is not None

    def is_id(self, f: int | str) -> bool:
        return self._name(f) in self.id_features

    def is_active(self, f: int | str) -> bool:
        return self._name(f) in self.active_features

    def is_numeric(self, f: int | str) -> bool:
        return self._name(f) in self.numeric_features

    def is_categorical(self, f: int | str) -> bool:
        return self._name(f) in self.categorical_features

    def is_target(self, f: int | str) -> bool:
        return self.has_target() and self._name(f) == self.target_feature

    def is_classification(self) -> bool:
        return self.has_target() and self.is_categorical(self.target_feature)

    def feature_to_predictor_index(self, i: int) -> int:
        return self._all_to_predictor[i]

    def predictor_to_feature_index(self, p: int) -> int:
        return self._predictor_to_all[p]

    def _name(self, f: int | str) -> str:
        return self.feature_names[f] if isinstance(f, int) else f


class CategoricalValueEncodings:
    """Per-categorical-feature value <-> int dictionaries, built from data
    in sorted order for determinism (CategoricalValueEncodings.java)."""

    def __init__(self, distinct_values: dict[int, Iterable[str]]):
        self._value_to_code: dict[int, dict[str, int]] = {}
        self._code_to_value: dict[int, list[str]] = {}
        for fi, vals in distinct_values.items():
            ordered = sorted(set(map(str, vals)))
            self._value_to_code[fi] = {v: c for c, v in enumerate(ordered)}
            self._code_to_value[fi] = ordered

    @classmethod
    def from_data(
        cls, schema: InputSchema, rows: Sequence[Sequence[str]]
    ) -> "CategoricalValueEncodings":
        distinct: dict[int, set[str]] = {
            i: set()
            for i, n in enumerate(schema.feature_names)
            if schema.is_categorical(n)
        }
        for row in rows:
            for i in distinct:
                if i < len(row) and row[i] != "":
                    distinct[i].add(str(row[i]))
        return cls(distinct)

    def encode(self, feature_index: int, value: str) -> int:
        return self._value_to_code[feature_index][str(value)]

    def decode(self, feature_index: int, code: int) -> str:
        return self._code_to_value[feature_index][code]

    def get_value_count(self, feature_index: int) -> int:
        return len(self._code_to_value.get(feature_index, ()))

    def get_encoding_map(self, feature_index: int) -> dict[str, int]:
        return dict(self._value_to_code[feature_index])

    def get_values(self, feature_index: int) -> list[str]:
        return list(self._code_to_value[feature_index])

    def to_content(self) -> dict:
        """JSON-safe form for model-artifact embedding."""
        return {str(i): vals for i, vals in self._code_to_value.items()}

    @classmethod
    def from_content(cls, content: dict) -> "CategoricalValueEncodings":
        return cls({int(i): vals for i, vals in content.items()})


def encode_matrix(
    schema: InputSchema,
    encodings: CategoricalValueEncodings | None,
    rows: Sequence[Sequence[str]],
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorize parsed CSV rows -> (predictors [N,P] f32, target [N] f32).

    Categorical predictors/targets become their integer codes; missing or
    unknown values become NaN. Target is NaN-filled when the schema has
    none. This is the host-side analogue of RDFUpdate's LabeledPoint
    encoding (app/oryx-app-mllib .../rdf/RDFUpdate.java:228-262), done
    column-wise for the whole dataset.
    """
    n = len(rows)
    x = np.full((n, schema.num_predictors), np.nan, dtype=np.float32)
    t = np.full(n, np.nan, dtype=np.float32)
    for p in range(schema.num_predictors):
        fi = schema.predictor_to_feature_index(p)
        cat = schema.is_categorical(fi)
        for r, row in enumerate(rows):
            if fi >= len(row) or row[fi] == "":
                continue
            if cat:
                if encodings is None:
                    continue  # no dictionaries: categorical stays NaN
                try:
                    x[r, p] = encodings.encode(fi, row[fi])
                except KeyError:
                    pass
            else:
                try:
                    x[r, p] = float(row[fi])
                except ValueError:
                    pass
    if schema.has_target():
        ti = schema.target_index
        cat = schema.is_categorical(ti)
        for r, row in enumerate(rows):
            if ti >= len(row) or row[ti] == "":
                continue
            if cat:
                if encodings is None:
                    continue
                try:
                    t[r] = encodings.encode(ti, row[ti])
                except KeyError:
                    pass
            else:
                try:
                    t[r] = float(row[ti])
                except ValueError:
                    pass
    return x, t
