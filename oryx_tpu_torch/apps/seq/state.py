"""In-memory seq model state shared by the speed and serving tiers (the
port's copy of oryx_tpu/apps/seq/state.py).

Item embeddings live in the SAME FactorStore the ALS tiers use
(apps/als/state.py): a growing arena whose device copy resyncs by
dirty-row delta (ops/transfer.py scatter_rows), so the speed tier's
per-item UP writes reach the serving matrix as row scatters, never a
re-upload. The small recurrent weights (Wx/Wh/b) ride inline on the
MODEL message and swap atomically with the announced item-id set.
"""

from __future__ import annotations

import threading

import numpy as np

from oryx_tpu_torch.apps.als.state import FactorStore, _adopt_quality_profile
from oryx_tpu_torch.apps.updates import parse_update_message
from oryx_tpu_torch.common.artifact import read_artifact_from_update
from oryx_tpu_torch.ops.seq import GRU_PARAM_NAMES


class SeqState:
    """Embeddings + GRU weights + expected-id readiness bookkeeping."""

    def __init__(self, dim: int, window: int):
        self.dim = dim
        self.window = window
        self.items = FactorStore(dim)
        self.params: dict[str, np.ndarray] | None = None
        self.expected_items: set[str] | None = None
        self._have = 0
        self._frac_lock = threading.Lock()

    # -- writes (keep the readiness counter true) --------------------------

    def set_item(self, ident: str, vector: np.ndarray) -> None:
        present_before = ident in self.items
        self.items.set(ident, vector)
        if self.expected_items is not None:
            with self._frac_lock:
                if ident not in self.expected_items:
                    self.expected_items.add(ident)
                    self._have += 1
                elif not present_before:
                    self._have += 1

    def recount(self) -> None:
        with self._frac_lock:
            ex = self.expected_items
            self._have = len(ex & set(self.items.ids())) if ex is not None else 0

    def set_expected(self, item_ids) -> None:
        self.expected_items = set(item_ids)
        self.recount()

    def fraction_loaded(self) -> float:
        if self.expected_items is None or self.params is None:
            return 0.0
        total = len(self.expected_items)
        if total == 0:
            return 1.0
        with self._frac_lock:
            return self._have / total


def apply_seq_update(
    state: SeqState | None, key: str | None, message: str
) -> SeqState | None:
    """Apply one update-topic message — the single implementation behind
    both the speed and serving managers (the ALS apply_update_message
    pattern):

    MODEL / MODEL-REF -> a fresh state when the embedding width or the
    context window changed, else retain only the announced item ids;
    recurrent weights (inline tensors) swap in either way. The embedding
    matrix itself arrives as the UP row flood that follows, or inline as an
    "E" tensor when the publisher chose to ship it whole.
    UP ["E", id, vec] -> set one item row (width-mismatched stale
    updates from an older-rank model are dropped).
    """
    if key in ("MODEL", "MODEL-REF"):
        art = read_artifact_from_update(key, message)
        dim = int(art.get_extension("dim"))
        window = int(art.get_extension("window", 8))
        params = {
            name: np.asarray(art.tensors[name], dtype=np.float32)
            for name in GRU_PARAM_NAMES
            if art.tensors and name in art.tensors
        }
        if len(params) != len(GRU_PARAM_NAMES):
            raise ValueError("seq MODEL message lacks recurrent weight tensors")
        if np.shape(params["Wh"]) != (dim, 3 * dim):
            raise ValueError(
                f"seq recurrent weights shaped {np.shape(params['Wh'])} "
                f"inconsistent with dim={dim}"
            )
        item_ids = art.get_extension_list("ItemIDs")
        if state is None or state.dim != dim:
            state = SeqState(dim, window)
        else:
            state.window = window
        state.params = params
        if item_ids:
            state.set_expected(item_ids)
            state.items.retain(set(item_ids))
            state.recount()
        else:
            state.set_expected(state.items.ids())
        _adopt_quality_profile(art, item_ids)
        e = art.tensors.get("E") if art.tensors else None
        if e is not None and item_ids and len(e) == len(item_ids):
            state.items.bulk_set(item_ids, np.asarray(e, dtype=np.float32))
            state.recount()
    elif key == "UP":
        if state is None:
            return None  # updates before any model: nothing to apply to
        kind, ident, vec, _known = parse_update_message(message)
        if kind != "E" or len(vec) != state.dim:
            return state
        state.set_item(ident, vec)
    return state
