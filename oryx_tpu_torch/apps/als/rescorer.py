"""Rescorer SPI: app-level plugin for serving-time result filtering/boosting
(the port's copy of oryx_tpu/apps/als/rescorer.py).

Mirrors app/oryx-app-api's Rescorer/RescorerProvider contract with
MultiRescorer composition (app/oryx-app-api .../app/als/*.java), loaded by
class name from oryx.als.rescorer-provider-class.
"""

from __future__ import annotations

from abc import ABC
from typing import Sequence


class Rescorer(ABC):
    def is_filtered(self, ident: str) -> bool:
        return False

    def rescore(self, ident: str, score: float) -> float | None:
        """New score, or None to drop the candidate."""
        return score


class RescorerProvider(ABC):
    """Per-query rescorer factories; any may return None (no rescoring)."""

    def get_recommend_rescorer(self, user_ids: Sequence[str], model, *args) -> Rescorer | None:
        return None

    def get_recommend_to_anonymous_rescorer(self, item_ids: Sequence[str], model, *args) -> Rescorer | None:
        return None

    def get_most_popular_items_rescorer(self, model, *args) -> Rescorer | None:
        return None

    def get_most_similar_items_rescorer(self, model, *args) -> Rescorer | None:
        return None


class MultiRescorer(Rescorer):
    def __init__(self, rescorers: Sequence[Rescorer]):
        self.rescorers = [r for r in rescorers if r is not None]

    def is_filtered(self, ident: str) -> bool:
        return any(r.is_filtered(ident) for r in self.rescorers)

    def rescore(self, ident: str, score: float) -> float | None:
        for r in self.rescorers:
            score = r.rescore(ident, score)
            if score is None:
                return None
        return score


class MultiRescorerProvider(RescorerProvider):
    def __init__(self, providers: Sequence[RescorerProvider]):
        self.providers = list(providers)

    def _combine(self, method: str, *args) -> Rescorer | None:
        rs = [getattr(p, method)(*args) for p in self.providers]
        rs = [r for r in rs if r is not None]
        if not rs:
            return None
        return rs[0] if len(rs) == 1 else MultiRescorer(rs)

    def get_recommend_rescorer(self, user_ids, model, *args):
        return self._combine("get_recommend_rescorer", user_ids, model, *args)

    def get_recommend_to_anonymous_rescorer(self, item_ids, model, *args):
        return self._combine("get_recommend_to_anonymous_rescorer", item_ids, model, *args)

    def get_most_popular_items_rescorer(self, model, *args):
        return self._combine("get_most_popular_items_rescorer", model, *args)

    def get_most_similar_items_rescorer(self, model, *args):
        return self._combine("get_most_similar_items_rescorer", model, *args)
