"""Typed hyperparameter ranges + grid/random search (the port's copy of
oryx_tpu/ml/hyperparams.py).

Mirrors framework/oryx-ml's param package (HyperParams.java:67-115,
GridSearch.java:30-70, RandomSearch.java:36-57): ranges come from config
values (scalar = fixed, list = categorical, {min,max} object = range),
grid search enumerates a capped cross-product with a per-parameter value
budget, random search samples combos through the ranges.
"""

from __future__ import annotations

import itertools
import math
from abc import ABC, abstractmethod
from typing import Any, Mapping, Sequence

import numpy as np

from oryx_tpu_torch.common.rng import RandomManager

MAX_COMBOS = 65536


class HyperParamRange(ABC):
    @abstractmethod
    def trial_values(self, n: int) -> list:
        """Up to n representative values spanning the range (grid search)."""

    @abstractmethod
    def random_value(self, rng: np.random.Generator): ...


class Unordered(HyperParamRange):
    """Categorical set; also represents a fixed single value."""

    def __init__(self, values: Sequence):
        if not values:
            raise ValueError("empty value set")
        self.values = list(values)

    def trial_values(self, n: int) -> list:
        return self.values[: max(1, n)]

    def random_value(self, rng):
        return self.values[int(rng.integers(len(self.values)))]


class DiscreteRange(HyperParamRange):
    def __init__(self, lo: int, hi: int):
        if hi < lo:
            raise ValueError(f"bad range [{lo},{hi}]")
        self.lo, self.hi = int(lo), int(hi)

    def trial_values(self, n: int) -> list:
        if self.lo == self.hi or n <= 1:
            return [self.lo]
        span = self.hi - self.lo
        k = min(n, span + 1)
        return sorted({self.lo + round(i * span / (k - 1)) for i in range(k)})

    def random_value(self, rng):
        return int(rng.integers(self.lo, self.hi + 1))


class ContinuousRange(HyperParamRange):
    """Uniform, or log-uniform when the range spans multiple decades (the
    useful behavior for regularization-type params)."""

    def __init__(self, lo: float, hi: float):
        if hi < lo:
            raise ValueError(f"bad range [{lo},{hi}]")
        self.lo, self.hi = float(lo), float(hi)
        self.log = lo > 0 and hi / max(lo, 1e-30) >= 100.0

    def trial_values(self, n: int) -> list:
        if self.lo == self.hi or n <= 1:
            return [self.lo]
        if self.log:
            return list(np.geomspace(self.lo, self.hi, n))
        return list(np.linspace(self.lo, self.hi, n))

    def random_value(self, rng):
        if self.log:
            return float(np.exp(rng.uniform(math.log(self.lo), math.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))


class DiscreteAround(HyperParamRange):
    def __init__(self, value: int, step: int):
        self.value, self.step = int(value), int(step)

    def trial_values(self, n: int) -> list:
        if n <= 1 or self.step == 0:
            # step 0 pins the value; without this guard the growing-set
            # loop below never terminates for n >= 2
            return [self.value]
        out = {self.value}
        i = 1
        while len(out) < n:
            out |= {self.value - i * self.step, self.value + i * self.step}
            i += 1
        return sorted(out)[:n]

    def random_value(self, rng):
        return self.value + int(rng.integers(-1, 2)) * self.step


class ContinuousAround(HyperParamRange):
    def __init__(self, value: float, step: float):
        self.value, self.step = float(value), float(step)

    def trial_values(self, n: int) -> list:
        if n <= 1 or self.step == 0.0:
            return [self.value]  # step 0 pins the value (no [v, v] dups)
        half = (n - 1) // 2
        return [self.value + i * self.step for i in range(-half, n - half)]

    def random_value(self, rng):
        return float(self.value + rng.uniform(-1, 1) * self.step)


def from_config_value(v: Any) -> HyperParamRange:
    """Config value -> range: scalar = fixed, list = categorical,
    {min,max} = numeric range, {value,step} = around."""
    if isinstance(v, HyperParamRange):
        return v
    if isinstance(v, Mapping):
        if "min" in v and "max" in v:
            lo, hi = v["min"], v["max"]
            if isinstance(lo, int) and isinstance(hi, int):
                return DiscreteRange(lo, hi)
            return ContinuousRange(lo, hi)
        if "value" in v and "step" in v:
            val, step = v["value"], v["step"]
            if isinstance(val, int) and isinstance(step, int):
                return DiscreteAround(val, step)
            return ContinuousAround(val, step)
        raise ValueError(f"bad hyperparam object: {v!r}")
    if isinstance(v, (list, tuple)):
        return Unordered(v)
    return Unordered([v])


def grid_search(ranges: Mapping[str, HyperParamRange], how_many: int) -> list[dict]:
    """Full cross-product, with a per-param value budget chosen so the
    total stays near how_many (and hard-capped at MAX_COMBOS)."""
    names = list(ranges)
    if not names:
        return [{}]
    how_many = min(max(1, how_many), MAX_COMBOS)
    # spread the budget across parameters that can actually VARY: a fixed
    # scalar contributes exactly one value regardless, and counting it
    # would starve the real search axes (e.g. one varying lambda among
    # fixed features/alpha got a budget of 1 and the "grid" collapsed to
    # a single combo). set() dedupes degenerate ranges that return
    # repeated values.
    vary = sum(1 for n in names if len(set(ranges[n].trial_values(2))) > 1)
    per_param = max(1, int(round(how_many ** (1.0 / max(1, vary)))))
    value_lists = [ranges[n].trial_values(per_param) for n in names]
    combos = [dict(zip(names, vals)) for vals in itertools.product(*value_lists)]
    return combos[:MAX_COMBOS]


def random_search(ranges: Mapping[str, HyperParamRange], how_many: int) -> list[dict]:
    rng = RandomManager.get_random()
    names = list(ranges)
    if not names:
        return [{}]
    return [
        {n: ranges[n].random_value(rng) for n in names}
        for _ in range(max(1, how_many))
    ]


def choose_combos(
    ranges: Mapping[str, Any], candidates: int, strategy: str = "random"
) -> list[dict]:
    """Dispatch grid vs random like HyperParams.chooseHyperParameterCombos;
    1 candidate always means 'the default point' (first trial value)."""
    typed = {k: from_config_value(v) for k, v in ranges.items()}
    if candidates <= 1:
        return [{k: r.trial_values(1)[0] for k, r in typed.items()}]
    if strategy == "grid":
        return grid_search(typed, candidates)
    if strategy == "random":
        return random_search(typed, candidates)
    raise ValueError(f"unknown search strategy: {strategy!r}")
