"""ALS speed tier: micro-batch fold-in deltas (the port's copy of
oryx_tpu/apps/als/speed.py).

Mirrors ALSSpeedModelManager (app/oryx-app .../speed/als/
ALSSpeedModelManager.java:68-221): consume MODEL/MODEL-REF (new or retained
state keyed on the features hyperparam) and UP X/Y vector writes; per
micro-batch, aggregate interactions with the batch tier's dup semantics and
compute fold-in deltas for BOTH the user and item vectors of every
interaction against the cached X^T.X / Y^T.Y solvers — emitted as UP
messages. Skips everything until the model is min-model-load-fraction
loaded. The fold-in solves run as one batch of triangular solves on the card
(ops/als.py ``fold_in_batch``) rather than a parallelStream over
interactions: the Cholesky factors, the strengths and the gathered vectors
go up once per micro-batch, the new vectors come back for the messages.
The JAX package's live input sketch (common/qualitystats.py) is the quality
plane of ROADMAP queue 1 item 4 and is not fed here.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from oryx_tpu_torch.api import AbstractSpeedModelManager
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.locks import RateLimitCheck
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.als import aggregate_interactions, fold_in_batch
from oryx_tpu_torch.apps.als.common import (
    ALSConfig,
    batch_update_messages,
    parse_events,
    valid_event_line,
    valid_event_lines,
)
from oryx_tpu_torch.apps.als.state import ALSState, apply_update_message

log = logging.getLogger(__name__)


class ALSSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config: Config, device=None):
        self.config = config
        self.als = ALSConfig.from_config(config)
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        self.min_fraction = config.get_float("oryx.speed.min-model-load-fraction", 0.8)
        self.state: ALSState | None = None
        self._not_ready_log = RateLimitCheck(60.0)

    # -- update-topic consumption ------------------------------------------

    def consume_key_message(self, key: str | None, message: str) -> None:
        self.state = apply_update_message(
            self.state, key, message, with_known_items=False
        )

    def validate_record(self, km) -> bool:
        """Deserialize check for the speed layer's quarantine sweep:
        malformed lines are diverted to the dead-letter store (and
        counted) instead of being silently skipped by parse_events."""
        return valid_event_line(km.message)

    def validate_records(self, records):
        """Batch sweep: one native parse per window (see
        valid_event_lines) instead of a Python parse per record."""
        return valid_event_lines(km.message for km in records)

    # -- micro-batch -> updates --------------------------------------------

    def build_updates(self, new_data):
        st = self.state
        if st is None or st.fraction_loaded() < self.min_fraction:
            if self._not_ready_log.test():
                log.info("speed model not yet loaded; skipping micro-batch")
            return []
        users, items, vals, tss = parse_events(new_data)
        if len(vals) == 0:
            return []
        # same strength transform the batch model was trained with — folding
        # raw strengths into a log1p-trained model would overweight them
        agg = aggregate_interactions(
            users, items, vals, tss,
            implicit=st.implicit,
            zero_threshold=self.als.zero_threshold,
            log_strength=self.als.log_strength,
            epsilon=self.als.epsilon,
        )
        if len(agg.values) == 0:
            return []

        # gather current vectors under ONE read lock per store; zeros mark
        # absent (new) entities
        uids = [agg.user_ids[u] for u in agg.users]
        iids = [agg.item_ids[i] for i in agg.items]
        xu, have_x = st.x.get_many(uids)
        yi, have_y = st.y.get_many(iids)

        out: list[tuple[str, str]] = []
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        vals_d, xu_d, yi_d = up(agg.values.astype(np.float32)), up(xu), up(yi)

        def fold(chol, cur, other):
            return fold_in_batch(
                up(chol), vals_d, cur, other, implicit=st.implicit
            ).cpu().numpy()

        # user-side deltas need Y'Y; item-side need X'X — both one batched
        # solve over the whole micro-batch; message building is likewise
        # batched (vectorized float formatting dominates at 100k-event
        # rates)
        chol_y = st.yty.get()
        if chol_y is not None and have_y.any():
            new_xu = fold(chol_y, xu_d, yi_d)
            emit = have_y & np.isfinite(new_xu).all(axis=1)
            rows = np.nonzero(emit)[0]
            out.extend(batch_update_messages(
                "X", [uids[j] for j in rows], new_xu[rows],
                known_lists=[[iids[j]] for j in rows],
            ))
        chol_x = st.xtx.get()
        if chol_x is not None and have_x.any():
            new_yi = fold(chol_x, yi_d, xu_d)
            emit = have_x & np.isfinite(new_yi).all(axis=1)
            rows = np.nonzero(emit)[0]
            out.extend(batch_update_messages(
                "Y", [iids[j] for j in rows], new_yi[rows],
                # the reference's Y fold-in message carries the interacting
                # user as element 4 (["Y",item,vec,[user]],
                # ALSSpeedModelManager.java:198-220) — kept for wire parity
                # with reference consumers; ours ignore it for Y
                known_lists=[[uids[j]] for j in rows],
            ))
        return out
