"""Seq speed tier: fold new/extended sessions into the serving state (the
port's copy of oryx_tpu/apps/seq/speed.py; the GRU encode runs on the
manager's device).

Per micro-batch: group the window's events into sessions, stitch each
onto the bounded per-session tail this manager remembers, run the GRU
over every (context -> next item) transition, and nudge the TARGET
item's embedding toward the context's hidden state — one bounded blend
step ``e <- (1-eta) e + eta h``. Each touched item becomes ONE UP
["E", id, [vec]] message, so the published update is sized by the dirty
rows (the delta contract: serving applies them as row scatters, never a
model re-upload). Items never seen by the batch model enter the store
at the context's hidden state — a brand-new item becomes recommendable
one micro-batch after its first click, the seq analogue of ALS folding
in a brand-new user.

Like ALS, build_updates only READS the model state: the emitted UP
messages loop back through the update topic into every consumer
(including this one), which is what keeps N serving replicas and this
manager bit-identical. The one manager-local piece — the bounded
session-tail memory — advances only AFTER every fallible step, because
the speed layer replays failed windows (rewind, then bisection): tails
mutated before a raise would stitch bogus contexts into the replay.
"""

from __future__ import annotations

import logging

import numpy as np

from oryx_tpu_torch.api import AbstractSpeedModelManager
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.locks import RateLimitCheck
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.qualitystats import configure_qualitystats, get_qualitystats
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.seq import encode_sessions
from oryx_tpu_torch.apps.seq.common import (
    SeqConfig,
    parse_session_events,
    sessionize,
    valid_session_line,
    valid_session_lines,
)
from oryx_tpu_torch.apps.seq.state import SeqState, apply_seq_update
from oryx_tpu_torch.apps.updates import batch_update_messages

log = logging.getLogger(__name__)


class SeqSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config: Config, device=None):
        self.config = config
        # the card, unless the caller names the CPU (the tests do)
        self.device = resolve_device(device)
        self.seq = SeqConfig.from_config(config)
        self.min_fraction = config.get_float("oryx.speed.min-model-load-fraction", 0.8)
        self.state: SeqState | None = None
        self._not_ready_log = RateLimitCheck(60.0)
        # bounded session-tail memory: session key -> (recent item list,
        # newest folded (ts, item) pairs); insertion-ordered dict as
        # LRU, live sessions re-insert
        self._tails: dict[str, tuple[list[str], list]] = {}
        self._m_folded = get_registry().counter(
            "oryx_seq_sessions_folded_total",
            "Sessions (new or extended) the seq speed tier folded into "
            "the serving state as item-embedding row deltas",
        )
        # the speed tier sees the raw event stream: it feeds the live
        # input sketch the drift gauges compare against the served
        # generation's training profile (common/qualitystats.py)
        configure_qualitystats(config)

    # -- update-topic consumption ------------------------------------------

    def consume_key_message(self, key: str | None, message: str) -> None:
        self.state = apply_seq_update(self.state, key, message)

    def validate_record(self, km) -> bool:
        return valid_session_line(km.message)

    def validate_records(self, records):
        return valid_session_lines(km.message for km in records)

    # -- micro-batch -> updates --------------------------------------------

    def build_updates(self, new_data):
        st = self.state
        if st is None or st.fraction_loaded() < self.min_fraction:
            if self._not_ready_log.test():
                log.info("seq speed model not yet loaded; skipping micro-batch")
            return []
        users, sess, items, tss = parse_session_events(new_data)
        if len(tss) == 0:
            return []
        # input drift: fold this micro-batch's item events into the live
        # windowed sketch (one hash per event, micro-batch granularity)
        get_qualitystats().note_input_events(items, tss)
        window = self.seq.window
        # transitions: (context item lists, target item), context = the
        # remembered tail + this window's not-yet-folded items. The tails
        # are only READ here — they advance at the very end, after all
        # fallible work — and each tail remembers the newest folded
        # (ts, item) pairs, so a window replayed by the layer
        # (rewind/bisection inside the build, or a publish/divert failure
        # after it) re-derives zero transitions instead of stitching
        # itself onto a tail that already contains it. The pair memory is
        # bounded (pair_cap per session): a replay of a single session
        # window larger than it would re-blend its oldest events —
        # bounded over-weighting, the same honest-degraded spirit as the
        # layer's bisection mode.
        sessions_ts = sessionize(
            users, sess, items, tss, max_events=self.seq.max_session_events
        )
        pair_cap = max(4 * window, 32)
        contexts: list[list[str]] = []
        targets: list[str] = []
        ctx_keys: list[str] = []  # owning session of each transition
        new_tails: dict[str, tuple[list[str], list[tuple[int, str]]]] = {}
        for key, evs in sessions_ts.items():
            tail, seen_pairs = self._tails.get(key, ([], []))
            seen = set(seen_pairs)
            new_evs = [e for e in evs if e not in seen]
            if not new_evs:
                continue
            full = tail + [i for _, i in new_evs]
            for j in range(len(tail), len(full)):
                ctx = full[max(0, j - window) : j]
                if ctx:
                    contexts.append(ctx)
                    targets.append(full[j])
                    ctx_keys.append(key)
            new_tails[key] = (
                full[-window:], (seen_pairs + new_evs)[-pair_cap:]
            )
        if not contexts:
            self._advance_tails(new_tails)
            return []

        # gather context embeddings under one read lock per batch; items
        # absent from the store contribute zero rows (masked anyway when
        # the whole context is unknown — those transitions are skipped)
        flat: list[str] = [i for c in contexts for i in c]
        vecs, have = st.items.get_many(flat)
        # L is always the configured window (left padding, masked)
        mat = np.zeros((len(contexts), window, st.dim), dtype=np.float32)
        mask = np.zeros((len(contexts), window), dtype=np.float32)
        pos = 0
        known_ctx = np.zeros(len(contexts), dtype=bool)
        for r, c in enumerate(contexts):
            n = len(c)
            mat[r, window - n:] = vecs[pos : pos + n]
            mask[r, window - n:] = have[pos : pos + n].astype(np.float32)
            known_ctx[r] = bool(have[pos : pos + n].any())
            pos += n
        rows = np.nonzero(known_ctx)[0]
        if rows.size == 0:
            self._advance_tails(new_tails)
            return []
        h = encode_sessions(st.params, mat[rows], mask[rows], device=self.device)

        # Reference magnitude: hidden states are tanh-bounded while
        # trained embedding rows carry the softmax's learned scale, so a
        # raw h would enter the catalog scoring ~an order of magnitude
        # low. Fold DIRECTIONS from h and magnitude from the trained
        # rows: the mean norm of the known context embeddings in this
        # batch stands in for "a trained row's scale".
        known_norms = np.linalg.norm(vecs[have], axis=1) if have.any() else None
        ref_norm = float(known_norms.mean()) if known_norms is not None and known_norms.size else 1.0
        if not np.isfinite(ref_norm) or ref_norm <= 0:
            ref_norm = 1.0

        # one blended row per touched item (the last write wins within a
        # micro-batch, matching per-event application order); the current
        # target rows gather in ONE get_many (one read lock per batch,
        # never one per touched item)
        eta = self.seq.fold_rate
        touched = sorted({targets[int(r)] for r in rows})
        cur_vecs, cur_have = st.items.get_many(touched)
        current = {
            t: (cur_vecs[j] if cur_have[j] else None)
            for j, t in enumerate(touched)
        }
        new_rows: dict[str, np.ndarray] = {}
        for hr, r in zip(h, rows):
            target = targets[int(r)]
            hn = float(np.linalg.norm(hr))
            step = hr * (ref_norm / hn) if hn > 1e-12 else hr
            cur = new_rows.get(target)
            if cur is None:
                stored = current[target]
                cur = stored if stored is not None else step
            new_rows[target] = (1.0 - eta) * cur + eta * step
        ids = sorted(new_rows)
        block = np.stack([new_rows[i] for i in ids])
        finite = np.isfinite(block).all(axis=1)
        if not finite.all():
            keep = np.nonzero(finite)[0]
            ids = [ids[int(j)] for j in keep]
            block = block[keep]
        if not ids:
            self._advance_tails(new_tails)
            return []
        out = batch_update_messages("E", ids, block)
        # everything fallible inside this call is done: NOW the session
        # tails (and their folded-pair memories) advance. The counter
        # counts sessions that actually CONTRIBUTED an embedding delta
        # (known-context transitions), matching its documented meaning —
        # first-click and unknown-context sessions advance tails only.
        self._advance_tails(new_tails)
        self._m_folded.inc(len({ctx_keys[int(r)] for r in rows}))
        return out

    def _advance_tails(
        self, new_tails: dict[str, tuple[list[str], list]]
    ) -> None:
        """Adopt the micro-batch's session tails (pop + reinsert keeps
        the dict's insertion order working as the LRU) and trim to the
        configured bound. Each entry is (recent items, newest folded
        (ts, item) pairs) — the pair memory makes a REPLAYED window
        (publish failure after this call, layer rewind) fold nothing a
        second time."""
        for key, tail in new_tails.items():
            self._tails.pop(key, None)
            self._tails[key] = tail
        while len(self._tails) > self.seq.max_sessions:
            self._tails.pop(next(iter(self._tails)))
