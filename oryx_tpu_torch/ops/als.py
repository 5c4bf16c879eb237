"""ALS training, incremental fold-in and scoring (the port's counterpart of
oryx_tpu/ops/als.py).

- Batch training replaces org.apache.spark.mllib.recommendation.ALS (invoked
  at app/oryx-app-mllib .../als/ALSUpdate.java:140-151) with alternating
  normal-equation solves: interactions become *padded per-entity lists*,
  grouped into width buckets, and each half-iteration is a gather, two
  batched products and a batched Cholesky solve per block of rows. The JAX
  package runs that as one XLA program; here it is a Python loop of
  library calls (``torch.bmm``, ``torch.linalg.cholesky_ex``,
  ``torch.linalg.solve_triangular``, indexing) on the card, since the JAX
  package reaches no Pallas kernel on this path. Implicit feedback follows
  Hu-Koren-Volinsky confidence weighting (c = 1 + alpha.r), explicit uses
  ALS-WR lambda.n_u regularization to match MLlib behavior. Single device
  only: the mesh, row-sharded and tensor-parallel trainers are ROADMAP
  queue 1 item 11.
- Input preprocessing mirrors ALSUpdate semantics (…/als/ALSUpdate.java:
  348-422): per-day exponential decay of old interactions, zero-threshold
  drop, NaN-as-delete aggregation for implicit (NaN-propagating sum),
  last-wins for explicit, optional log1p(r/epsilon) strength transform.
  This host code is numpy, copied from the JAX package, and bit-identical
  to it.
- Fold-in mirrors ALSUtils.computeTargetQui / computeUpdatedXu
  (app/oryx-app-common .../als/ALSUtils.java:37-106): interpolate the
  predicted strength toward 1/0 by the interaction strength, then solve
  (Y^T.Y) dXu = dQui.Yi against the cached Cholesky factor -- batched
  triangular solves over a whole micro-batch.
- Scoring: ``topk_dot_batch`` routes exact and quantized requests with
  k <= 128 to the fused kernel (ops/topk.py) -- on a CUDA tensor it
  launches the hand-written kernel or raises, never anything else. k > 128
  and approx mode go through one plain large product and a stable sort, as
  the JAX package leaves them to XLA.
"""

from __future__ import annotations

import logging
import math
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.flops import als_halfstep_flops
from oryx_tpu_torch.ops.solver import batched_spd_solve_ex
from oryx_tpu_torch.ops.topk import (
    _row_chunks,
    _scores,
    _stable_topk,
    quantize_queries,
    topk_dot_batch_cuda,
)
from oryx_tpu_torch.ops.transfer import QuantizedMatrix
from oryx_tpu_torch.ops.vector import full_f32, gram

log = logging.getLogger(__name__)

# Largest k dispatched to the fused kernel. The serving micro-batcher
# derives a k bucket from this so default /recommend overfetch (k=18) stays
# on the fused path -- keep them coupled (serving/batcher.py K_BUCKETS).
PALLAS_TOPK_MAX_K = 128


# ---------------------------------------------------------------------------
# host-side input preparation
# ---------------------------------------------------------------------------

@dataclass
class InteractionData:
    """Aggregated COO interactions with contiguous int ids."""

    user_ids: list[str]
    item_ids: list[str]
    users: np.ndarray  # [nnz] int32 indices into user_ids
    items: np.ndarray  # [nnz] int32 indices into item_ids
    values: np.ndarray  # [nnz] float32

    @property
    def n_users(self) -> int:
        return len(self.user_ids)

    @property
    def n_items(self) -> int:
        return len(self.item_ids)


def aggregate_interactions(
    users: np.ndarray,
    items: np.ndarray,
    values: np.ndarray,
    timestamps: np.ndarray | None = None,
    *,
    implicit: bool = True,
    decay_factor: float = 1.0,
    zero_threshold: float = 0.0,
    now_ms: int | None = None,
    log_strength: bool = False,
    epsilon: float = 1.0,
) -> InteractionData:
    """String-keyed raw events -> deduplicated COO with contiguous ids.

    Semantics parity with ALSUpdate: decay by factor^(days old), implicit
    NaN-propagating sum (NaN value = delete the pair), explicit last-wins by
    timestamp, drop aggregates <= zero-threshold (implicit), log-strength
    transform after aggregation. ID maps are sorted for determinism, like
    the reference's sorted zipWithIndex maps (ALSUpdate.java:180-189).
    """
    users = np.asarray(users)
    items = np.asarray(items)
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    ts = (
        np.asarray(timestamps, dtype=np.int64)
        if timestamps is not None
        else np.zeros(n, dtype=np.int64)
    )

    if decay_factor < 1.0 and now_ms is not None:
        # calendar-day ages (now's day-of-epoch minus the event's), not a
        # rolling 24h difference: an event's decay bucket is then a pure
        # function of ITS timestamp, so the incremental AggregateState can
        # store raw per-day sums and apply decay at view time — at any
        # later generation — and still match this from-scratch path
        # exactly. (The reference decays by whole days too.)
        days_old = np.maximum(0, now_ms // _DAY_MS - ts // _DAY_MS)
        values = values * np.power(decay_factor, days_old)

    uid_sorted, ui = _factorize_string_ids(users)
    iid_sorted, ii = _factorize_string_ids(items)
    pair = ui * len(iid_sorted) + ii

    if implicit:
        # NaN-propagating sum per pair: any NaN (delete marker) kills the pair
        uniq, inv = np.unique(pair, return_inverse=True)
        sums = np.zeros(len(uniq))
        np.add.at(sums, inv, values)  # NaN propagates into the bucket sum
        keep = ~np.isnan(sums) & (np.abs(sums) > zero_threshold) & (sums > 0)
        agg_pair, agg_val = uniq[keep], sums[keep]
    else:
        # last (by timestamp) wins; NaN final value = delete
        order = np.lexsort((ts, pair))
        pair_s, val_s = pair[order], values[order]
        last = np.r_[pair_s[1:] != pair_s[:-1], True]
        agg_pair, agg_val = pair_s[last], val_s[last]
        keep = ~np.isnan(agg_val)
        agg_pair, agg_val = agg_pair[keep], agg_val[keep]

    if log_strength:
        agg_val = np.log1p(np.maximum(agg_val, 0.0) / epsilon)

    au = (agg_pair // len(iid_sorted)).astype(np.int32)
    ai = (agg_pair % len(iid_sorted)).astype(np.int32)
    return InteractionData(uid_sorted, iid_sorted, au, ai, agg_val.astype(np.float32))


_DAY_MS = 86_400_000

_POW10 = 10 ** np.arange(1, 19, dtype=np.int64)


def _factorize_string_ids(arr: np.ndarray) -> tuple[list[str], np.ndarray]:
    """(lexicographically sorted distinct ids, index-per-row) — the
    vectorized form of the reference's sorted-distinct ID maps
    (ALSUpdate.java:180-189). np.unique on tens of millions of strings is
    a minutes-scale host bottleneck, so ids that are canonical decimal
    integers (the common case: MovieLens et al.) take an O(n) bincount
    factorization instead; anything else falls back to np.unique."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return [], np.zeros(0, dtype=np.int64)
    if arr.dtype.kind in "iu":
        # already integer ids (e.g. from the native data loader, which only
        # accepts canonical decimal tokens) — no string checks needed
        nums = arr.astype(np.int64)
        canonical = True
    else:
        if arr.dtype.kind != "U":
            arr = arr.astype(str)
        try:
            nums = arr.astype(np.int64)
        except (ValueError, OverflowError):
            nums = None
        canonical = False
        if nums is not None and np.abs(nums).max() < 10**17:
            # canonical form check by exact digit count: rejects "07", "+7",
            # " 7", "-0" — strings astype(int) accepts but str() won't emit
            a = np.abs(nums)
            canon_len = np.searchsorted(_POW10, a, side="right") + 1 + (nums < 0)
            canonical = bool((np.char.str_len(arr) == canon_len).all())
    if nums is not None and canonical:
        lo = int(nums.min())
        span = int(nums.max()) - lo + 1
        if span <= max(4 * len(nums), 1 << 28):
            present = np.zeros(span, dtype=bool)
            present[nums - lo] = True
            uniq = np.nonzero(present)[0] + lo
            rank = np.cumsum(present) - 1
            inv = rank[nums - lo]
        else:
            uniq, inv = np.unique(nums, return_inverse=True)
        # remap numeric order -> lexicographic, for parity with the
        # reference's sorted string ids (only the small unique array
        # pays the string sort)
        uniq_strs = uniq.astype(str)
        lex = np.argsort(uniq_strs)
        perm = np.empty_like(lex)
        perm[lex] = np.arange(len(lex))
        return uniq_strs[lex].tolist(), perm[inv.astype(np.int64)]
    ids, inv = np.unique(arr, return_inverse=True)
    return ids.tolist(), inv.astype(np.int64)


# ---------------------------------------------------------------------------
# incremental aggregate state: aggregate_interactions, made mergeable
# ---------------------------------------------------------------------------

AGG_STATE_SCHEMA = 1


def _group_sum(u, i, d, v, presorted: bool = False):
    """Group (user, item[, day]) keys and NaN-propagating-sum their
    values: the ONE grouping kernel behind AggregateState's from_window,
    merge, and materialize paths — the stable lexsort keeps earlier
    entries (history order) first within a group, so partial sums add in
    the order the equivalence property test pins. d=None groups by
    (user, item) only. Returns (u_sorted, i_sorted, d_sorted, first_idx,
    sums) with one sums entry per group, first_idx naming each group's
    first sorted row."""
    if d is None:
        d = np.zeros(len(u), dtype=np.int64)
    if not presorted:
        order = np.lexsort((d, i, u))
        u, i, d, v = u[order], i[order], d[order], v[order]
    new = np.r_[
        True, (u[1:] != u[:-1]) | (i[1:] != i[:-1]) | (d[1:] != d[:-1])
    ]
    grp = np.cumsum(new) - 1
    sums = np.zeros(int(grp[-1]) + 1)
    np.add.at(sums, grp, v)  # NaN (delete marker) propagates into its group
    return u, i, d, np.nonzero(new)[0], sums


def agg_state_fingerprint(*, implicit: bool, with_days: bool) -> str:
    """Schema fingerprint a persisted snapshot must match to be loadable.
    zero-threshold / log-strength / the decay FACTOR are view-time
    parameters (materialize()) and deliberately absent: changing them must
    not force a full history re-read. Turning decay on/off changes the
    stored granularity (day buckets) and does."""
    return f"agg-v{AGG_STATE_SCHEMA}:implicit={implicit}:days={with_days}"


@dataclass
class AggregateState:
    """Persistent, mergeable form of ``aggregate_interactions``.

    Invariant: ``merge`` over any windowing of a history, then
    ``materialize``, equals ``aggregate_interactions`` over the
    concatenated history (bit-identical under exact float arithmetic;
    within rounding otherwise — the merge reorders sums only).

    - implicit: one entry per (user, item, day bucket) holding the raw
      NaN-propagating strength sum of that bucket. NaN (the delete
      marker) is KEPT in the state: any later strength added to a dead
      pair stays NaN, exactly like the full-history NaN-propagating sum.
      Decay is day-of-epoch (see aggregate_interactions), so a bucket's
      weight at any generation is ``sum * decay^(now_day - day)`` — decay
      never re-ages the stored sums. With decay off the day axis
      collapses to one bucket.
    - explicit: one entry per (user, item) holding (last_ts, raw last
      value); merges keep the newer timestamp, ties going to the newer
      window — the same winner the from-scratch stable lexsort picks.
      NaN value = delete, kept for the same resurrection-proofing.

    zero-threshold / positivity / log-strength are applied by
    ``materialize`` only: a pair below threshold this generation can come
    back above it later, exactly as a from-scratch re-aggregation would
    see it. Entries stay sorted by (user, item, day).
    """

    implicit: bool
    with_days: bool
    user_ids: np.ndarray  # [U] unicode, lexicographically sorted
    item_ids: np.ndarray  # [I] unicode, lexicographically sorted
    users: np.ndarray     # [M] int64 index into user_ids
    items: np.ndarray     # [M] int64 index into item_ids
    days: np.ndarray      # [M] int64 day-of-epoch bucket (0 when unused)
    vals: np.ndarray      # [M] float64 sums (implicit) / last value (explicit)
    last_ts: np.ndarray   # [M] int64 (explicit last-wins key; 0 when implicit)

    @property
    def entries(self) -> int:
        return len(self.vals)

    @property
    def fingerprint(self) -> str:
        return agg_state_fingerprint(
            implicit=self.implicit, with_days=self.with_days
        )

    @staticmethod
    def empty(*, implicit: bool, with_days: bool) -> "AggregateState":
        z = np.zeros(0, dtype=np.int64)
        return AggregateState(
            implicit, with_days,
            np.zeros(0, dtype="<U1"), np.zeros(0, dtype="<U1"),
            z.copy(), z.copy(), z.copy(), np.zeros(0, dtype=np.float64),
            z.copy(),
        )

    # -- construction --------------------------------------------------

    @staticmethod
    def from_window(
        users: np.ndarray,
        items: np.ndarray,
        values: np.ndarray,
        timestamps: np.ndarray | None = None,
        *,
        implicit: bool = True,
        with_days: bool = False,
    ) -> "AggregateState":
        """Aggregate ONE window of raw events into state form (the same
        id factorization and within-window combine rules as
        aggregate_interactions, minus the view-time transforms)."""
        users = np.asarray(users)
        items = np.asarray(items)
        values = np.asarray(values, dtype=np.float64)
        n = len(values)
        ts = (
            np.asarray(timestamps, dtype=np.int64)
            if timestamps is not None
            else np.zeros(n, dtype=np.int64)
        )
        if n == 0:
            return AggregateState.empty(implicit=implicit, with_days=with_days)
        uid_sorted, ui = _factorize_string_ids(users)
        iid_sorted, ii = _factorize_string_ids(items)
        uid_arr = np.asarray(uid_sorted, dtype=str)
        iid_arr = np.asarray(iid_sorted, dtype=str)
        ui = ui.astype(np.int64)
        ii = ii.astype(np.int64)
        day = (ts // _DAY_MS) if (implicit and with_days) else np.zeros(n, np.int64)
        if implicit:
            u_s, i_s, d_s, first, sums = _group_sum(ui, ii, day, values)
            return AggregateState(
                implicit, with_days, uid_arr, iid_arr,
                u_s[first], i_s[first], d_s[first], sums,
                np.zeros(len(first), dtype=np.int64),
            )
        # explicit: last (by timestamp) wins; stable sort breaks ties by
        # position in the window, like the from-scratch lexsort
        order = np.lexsort((ts, ii, ui))
        u_s, i_s, t_s, v_s = ui[order], ii[order], ts[order], values[order]
        last = np.r_[(u_s[1:] != u_s[:-1]) | (i_s[1:] != i_s[:-1]), True]
        keep = np.nonzero(last)[0]
        return AggregateState(
            implicit, with_days, uid_arr, iid_arr,
            u_s[keep], i_s[keep], np.zeros(len(keep), dtype=np.int64),
            v_s[keep], t_s[keep],
        )

    # -- merge -----------------------------------------------------------

    def merge(self, window: "AggregateState") -> "AggregateState":
        """Fold a newer window's state into this one: O(state + window),
        never O(history). ``window`` must be the NEWER side (explicit
        timestamp ties resolve toward it)."""
        if (self.implicit, self.with_days) != (window.implicit, window.with_days):
            raise ValueError("aggregate state schema mismatch")
        if window.entries == 0 and len(window.user_ids) == 0:
            return self
        if self.entries == 0 and len(self.user_ids) == 0:
            return window
        uids = np.union1d(self.user_ids, window.user_ids)
        iids = np.union1d(self.item_ids, window.item_ids)
        su = np.searchsorted(uids, self.user_ids)[self.users]
        si = np.searchsorted(iids, self.item_ids)[self.items]
        wu = np.searchsorted(uids, window.user_ids)[window.users]
        wi = np.searchsorted(iids, window.item_ids)[window.items]
        u = np.concatenate([su, wu])
        i = np.concatenate([si, wi])
        d = np.concatenate([self.days, window.days])
        v = np.concatenate([self.vals, window.vals])
        t = np.concatenate([self.last_ts, window.last_ts])
        if self.implicit:
            u_s, i_s, d_s, first, sums = _group_sum(u, i, d, v)
            return AggregateState(
                self.implicit, self.with_days, uids, iids,
                u_s[first], i_s[first], d_s[first], sums,
                np.zeros(len(first), dtype=np.int64),
            )
        # explicit: newest timestamp per pair wins; stable sort puts the
        # window's entry after the state's on equal ts, so ties go to it
        order = np.lexsort((t, i, u))
        u, i, v, t = u[order], i[order], v[order], t[order]
        last = np.r_[(u[1:] != u[:-1]) | (i[1:] != i[:-1]), True]
        keep = np.nonzero(last)[0]
        return AggregateState(
            self.implicit, self.with_days, uids, iids,
            u[keep], i[keep], np.zeros(len(keep), dtype=np.int64),
            v[keep], t[keep],
        )

    # -- view ------------------------------------------------------------

    def materialize(
        self,
        *,
        decay_factor: float = 1.0,
        zero_threshold: float = 0.0,
        now_ms: int | None = None,
        log_strength: bool = False,
        epsilon: float = 1.0,
    ) -> InteractionData:
        """The view-time half of aggregate_interactions: decay, delete/
        threshold filters and the log transform, over the merged state."""
        uid_list = self.user_ids.tolist()
        iid_list = self.item_ids.tolist()
        if self.implicit:
            w = self.vals
            if self.with_days and decay_factor < 1.0 and now_ms is not None:
                ages = np.maximum(0, now_ms // _DAY_MS - self.days)
                w = w * np.power(decay_factor, ages)
            if self.entries:
                # entries are already (user, item, day)-sorted: collapsing
                # the day axis groups by (user, item) in place
                u_s, i_s, _, first, sums = _group_sum(
                    self.users, self.items, None, w, presorted=True
                )
                pu, pi = u_s[first], i_s[first]
            else:
                sums = np.zeros(0)
                pu = pi = np.zeros(0, dtype=np.int64)
            keep = ~np.isnan(sums) & (np.abs(sums) > zero_threshold) & (sums > 0)
            agg_val = sums[keep]
            pu, pi = pu[keep], pi[keep]
        else:
            vals = self.vals
            if decay_factor < 1.0 and now_ms is not None:
                ages = np.maximum(0, now_ms // _DAY_MS - self.last_ts // _DAY_MS)
                vals = vals * np.power(decay_factor, ages)
            keep = ~np.isnan(vals)
            agg_val = vals[keep]
            pu, pi = self.users[keep], self.items[keep]
        if log_strength:
            agg_val = np.log1p(np.maximum(agg_val, 0.0) / epsilon)
        return InteractionData(
            uid_list, iid_list,
            pu.astype(np.int32), pi.astype(np.int32),
            agg_val.astype(np.float32),
        )

    # -- (de)serialization -------------------------------------------------

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Compact columnar form for npz persistence (datastore snapshot)."""
        return {
            "user_ids": self.user_ids if self.user_ids.size else np.zeros(0, "<U1"),
            "item_ids": self.item_ids if self.item_ids.size else np.zeros(0, "<U1"),
            "users": self.users.astype(np.int64),
            "items": self.items.astype(np.int64),
            "days": self.days.astype(np.int64),
            "vals": self.vals.astype(np.float64),
            "last_ts": self.last_ts.astype(np.int64),
            "flags": np.asarray([int(self.implicit), int(self.with_days)], np.int64),
        }

    @staticmethod
    def from_arrays(arrays) -> "AggregateState":
        flags = np.asarray(arrays["flags"]).astype(np.int64)
        return AggregateState(
            bool(flags[0]), bool(flags[1]),
            np.asarray(arrays["user_ids"], dtype=str),
            np.asarray(arrays["item_ids"], dtype=str),
            np.asarray(arrays["users"], dtype=np.int64),
            np.asarray(arrays["items"], dtype=np.int64),
            np.asarray(arrays["days"], dtype=np.int64),
            np.asarray(arrays["vals"], dtype=np.float64),
            np.asarray(arrays["last_ts"], dtype=np.int64),
        )


def align_factors(
    prev_ids, prev_mat: np.ndarray | None, new_ids, features: int,
    seed_key=None,
) -> np.ndarray | None:
    """Map a previous generation's factor rows onto a new id table: ids
    retained across generations keep their learned rows, new ids get the
    cold random init (same scale as the trainers', drawn on the CPU from
    ``seed_key``, a ``torch.Generator``). Returns None when there is
    nothing usable to resume from (no previous factors, or the feature
    width changed — a hyperparameter move cold-starts)."""
    if prev_mat is None or len(np.shape(prev_mat)) != 2:
        return None
    prev_mat = np.asarray(prev_mat, dtype=np.float32)
    if prev_mat.shape[1] != features or prev_mat.shape[0] == 0:
        return None
    prev_ids = np.asarray(prev_ids, dtype=str)
    new_ids = np.asarray(new_ids, dtype=str)
    order = np.argsort(prev_ids, kind="stable")
    prev_sorted, prev_rows = prev_ids[order], prev_mat[order]
    g = seed_key if seed_key is not None else RandomManager.get_generator()
    out = (
        torch.randn((len(new_ids), features), generator=g, device=g.device)
        * 0.1
        + 1.0 / math.sqrt(features)
    ).cpu().numpy()
    pos = np.searchsorted(prev_sorted, new_ids)
    pos_c = np.clip(pos, 0, len(prev_sorted) - 1)
    hit = prev_sorted[pos_c] == new_ids
    out[hit] = prev_rows[pos_c[hit]]
    return out


def build_padded_lists(
    entity: np.ndarray,
    other: np.ndarray,
    values: np.ndarray,
    n_entities: int,
    cap: int = 1024,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group COO by `entity` into static-shape padded lists.

    Returns (idx [N,P] int32, val [N,P] f32, mask [N,P] f32) with
    P = min(max row length, cap), power-of-2-padded (the JAX package's
    static shapes; the port keeps them so both build the same lists).
    Rows longer than P keep their largest-|value| interactions (the most
    informative ones) — the static-shape answer to Spark's ragged rows.
    """
    order = np.lexsort((-np.abs(values), entity))
    e, o, v = entity[order], other[order], values[order]
    counts = np.bincount(e, minlength=n_entities)
    max_c = int(counts.max()) if counts.size else 1
    p = 1 << max(0, (min(max_c, cap) - 1)).bit_length()
    p = max(p, 1)
    rank = np.arange(len(e)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    keep = rank < p
    e, o, v, rank = e[keep], o[keep], v[keep], rank[keep]
    idx = np.zeros((n_entities, p), dtype=np.int32)
    val = np.zeros((n_entities, p), dtype=np.float32)
    mask = np.zeros((n_entities, p), dtype=np.float32)
    idx[e, rank] = o
    val[e, rank] = v
    mask[e, rank] = 1.0
    return idx, val, mask


# ---------------------------------------------------------------------------
# the trainer: library ops on the card, one Python loop over row blocks
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _compute_dtype(compute_dtype) -> torch.dtype:
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    try:
        return _DTYPES[str(compute_dtype)]
    except KeyError:
        raise ValueError(
            f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}"
        ) from None


def _weighted_gram(yu, wt, acc=torch.float32):
    """``einsum("bpk,bp,bpl->bkl", yu, wt, yu)`` with ``acc`` (f32)
    accumulation, in the JAX package's pairwise order: the product
    ``wt * yu`` first, carried in f32 (exact, both factors being values of
    the compute type), then the contraction over p in one f32 product
    (TF32 off: ``full_f32``). bf16 values go up to f32 first, exactly."""
    y = yu.to(acc)
    return torch.bmm(y.mT, y * wt.to(acc)[:, :, None])


def _weighted_sum(yu, v, acc=torch.float32):
    """``einsum("bpk,bp->bk", yu, v)`` with ``acc`` (f32) accumulation."""
    return torch.bmm(v.to(acc)[:, None, :], yu.to(acc))[:, 0]


def _normal_equations(
    fc, gram_f, bidx, bval, bmask, lam, alpha, implicit, acc=torch.float32
):
    """A [B,K,K] and b [B,K] of one block of rows (the JAX package's
    ``one_block``): fc is the fixed side's factor table in the compute
    type, bidx/bval/bmask the rows' padded lists, ``acc`` the type the
    products, the sums and ``gram_f`` are carried in (f32; f64 for the
    rows that f32 cannot factor)."""
    k = fc.shape[1]
    cdt = fc.dtype
    eye = torch.eye(k, dtype=acc, device=fc.device)
    yu = fc[bidx].to(acc)  # [B,P,K] gather; bf16 values are exact in f32
    if implicit:
        # Hu et al.: A = Y'Y + Yu' diag(alpha.r) Yu + lam.I
        #            b = Yu' ((1 + alpha.r) . p),  p = 1 for observed
        w = alpha * bval * bmask
        a = gram_f[None] + _weighted_gram(yu, w.to(cdt), acc) + lam * eye[None]
        pref = (bval > 0).float() * bmask
        b = _weighted_sum(yu, ((1.0 + w) * pref).to(cdt), acc)
    else:
        # ALS-WR: A = Yu'Yu + lam.n_u.I ; b = Yu' r
        a = _weighted_gram(yu, bmask.to(cdt), acc)
        n_u = bmask.sum(dim=1).to(acc)
        a = a + (lam * torch.clamp(n_u, min=1.0))[:, None, None] * eye[None]
        b = _weighted_sum(yu, (bval * bmask).to(cdt), acc)
    return a, b


def _half_step(
    factors, gram_f, idx, val, mask, lam, alpha, implicit: bool, block: int,
    compute_dtype=torch.float32,
):
    """One ALS half-iteration: solve every row's normal equations.

    factors: [M,K] fixed side; idx/val/mask: [N,P] padded lists over the
    solving side. Rows go in ``block``-sized chunks, as the JAX package's
    lax.map walks them, so the [B,P,K] gather never materializes for the
    whole axis at once.

    compute_dtype=bfloat16 rounds the gathered factors and the weights to
    bf16, as the JAX package feeds its einsums; the products, their sums,
    the [K,K] systems and the Cholesky solves are f32 either way. The
    caller keeps TF32 off (``full_f32``).

    f32-assembled normal equations can round a marginal system
    indefinite: with lam = 0.01, the fixed side's gram grows past the
    point where f32 resolves lam (an f32 ulp of a 1e8 entry is 8). Rows
    whose factorization fails are assembled again and solved in f64, as
    the reference's Solver.java solves in double (the JAX package, f32
    only on the TPU, jitters them at once). What f64 cannot factor either
    takes trace-scaled jitter (the JAX package's guard, the ALS analogue
    of the reference solver's singularity check, ops/solver.py), and
    whatever still fails is zeroed: a zero row re-enters the next
    half-sweep cleanly. Jittering every f32 failure instead shrinks those
    rows, the other side grows to make up for them, and more rows fail in
    the next half-step: at the 25M shape some random inits end in tens of
    thousands of jittered rows and a held-out AUC near 0.8 (PERF.md §6).
    The failed rows are read back once per half-step, after every block
    is queued, and only they are assembled again — one host
    synchronisation, not one a block; and once more when some of them
    failed, to pick out what f64 could not factor.
    """
    n, _ = idx.shape
    k = factors.shape[1]
    cdt = _compute_dtype(compute_dtype)
    fc = factors.to(cdt)
    out = torch.empty((n, k), dtype=torch.float32, device=factors.device)
    ok = torch.empty(n, dtype=torch.bool, device=factors.device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        a, b = _normal_equations(
            fc, gram_f, idx[lo:hi], val[lo:hi], mask[lo:hi], lam, alpha, implicit
        )
        out[lo:hi], ok[lo:hi] = batched_spd_solve_ex(a, b)
    bad = torch.nonzero(~ok)[:, 0]
    if bad.numel():
        f64 = factors.double()
        gram64 = f64.T @ f64
        for lo in range(0, bad.numel(), block):
            rows = bad[lo : lo + block]
            a, b = _normal_equations(
                fc, gram64, idx[rows], val[rows], mask[rows], lam, alpha,
                implicit, acc=torch.float64,
            )
            x, ok[rows] = batched_spd_solve_ex(a, b)
            out[rows] = x.float()
        bad = torch.nonzero(~ok)[:, 0]
        eye = torch.eye(k, dtype=torch.float64, device=factors.device)
        for lo in range(0, bad.numel(), block):
            rows = bad[lo : lo + block]
            a, b = _normal_equations(
                fc, gram64, idx[rows], val[rows], mask[rows], lam, alpha,
                implicit, acc=torch.float64,
            )
            jitter = 0.02 * a.diagonal(dim1=-2, dim2=-1).sum(dim=-1) / k + 1e-6
            x, ok2 = batched_spd_solve_ex(a + jitter[:, None, None] * eye[None], b)
            out[rows] = torch.where(ok2[:, None], x, torch.zeros_like(x)).float()
    # rows with no interactions (all-pad) solve to ~0 already (b = 0)
    return torch.where(torch.isfinite(out).all(dim=1, keepdim=True), out, 0.0)


def _half_step_buckets(
    factors, gram_f, buckets, lam, alpha, implicit: bool, blocks, out,
    compute_dtype=torch.float32,
):
    """Bucketed half-iteration: solve each width class with its own padded
    shape and scatter the rows into ``out`` ([n_out, K], overwritten in
    place — the JAX package donates the buffer instead). ``buckets`` come
    from ``_upload_buckets``: their padding rows (id n_out, which the JAX
    package drops in its scatter) are already cut off."""
    out.zero_()
    for (rows, idx, val, mask), blk in zip(buckets, blocks):
        out[rows] = _half_step(
            factors, gram_f, idx, val, mask, lam, alpha, implicit, blk,
            compute_dtype=compute_dtype,
        )
    return out


def _upload_buckets(buckets, n_entities: int, device):
    """The bucketed lists on ``device``, each bucket cut to its real rows:
    ``build_bucketed_lists`` puts them first and pads after them with row
    id ``n_entities``, which would write out of range in a scatter."""
    out = []
    for rows, idx, val, mask in buckets:
        live = int(np.count_nonzero(rows < n_entities))
        out.append(tuple(
            torch.from_numpy(np.ascontiguousarray(a[:live])).to(device)
            for a in (rows, idx, val, mask)
        ))
    return out


def _als_train_bucketed(
    u_buckets, i_buckets, y0, lam, alpha,
    *, implicit: bool, iterations: int, blocks_u, blocks_i, n_u: int,
    compute_dtype: str = "float32", timings: dict | None = None,
):
    """Bucketed ALS training loop: a Python loop over sweeps (the JAX
    package's lax.scan), X and Y each one buffer rewritten in place.
    ``timings["tf32"]`` receives whether TF32 products were allowed while
    the sweeps ran."""
    cdt = _compute_dtype(compute_dtype)
    y = y0
    x = torch.zeros((n_u, y0.shape[1]), dtype=torch.float32, device=y0.device)
    with full_f32():
        for _ in range(iterations):
            _half_step_buckets(
                y, gram(y), u_buckets, lam, alpha, implicit, blocks_u, x,
                compute_dtype=cdt,
            )
            # the item half-step reads X only, so Y's buffer takes its output
            _half_step_buckets(
                x, gram(x), i_buckets, lam, alpha, implicit, blocks_i, y,
                compute_dtype=cdt,
            )
        if timings is not None:
            timings["tf32"] = torch.backends.cuda.matmul.allow_tf32
    return x, y


@dataclass
class ALSModelArrays:
    x: np.ndarray  # [n_users, K]
    y: np.ndarray  # [n_items, K]
    user_ids: list[str]
    item_ids: list[str]


def _finish_model(x, y, n_u: int, n_i: int, data) -> ALSModelArrays:
    """Trim padding and surface solver-guard diagnostics. An all-zero
    factor row is almost always the _half_step singularity guard zeroing an
    unsolvable system in the final sweep (explicit rows whose aggregated
    ratings are all exactly zero also land here) — worth a warning, never
    worth a NaN."""
    x = np.asarray(x)[:n_u]
    y = np.asarray(y)[:n_i]
    zeroed = int((~x.any(axis=1)).sum() + (~y.any(axis=1)).sum())
    if zeroed:
        log.warning(
            "ALS: %d all-zero factor rows (singularity guard, or all-zero "
            "explicit ratings) of %d users + %d items", zeroed, n_u, n_i,
        )
    return ALSModelArrays(x, y, data.user_ids, data.item_ids)


_NOT_PORTED_MESH = (
    "train_als: {} training is not ported to the PyTorch port yet "
    "(ROADMAP queue 1 item 11: multi-device)"
)


def train_als(
    data: InteractionData,
    features: int = 10,
    lam: float = 0.001,
    alpha: float = 1.0,
    iterations: int = 10,
    implicit: bool = True,
    mesh=None,
    cap: int = 1024,
    block: int = 1024,
    seed_key=None,
    compute_dtype: str = "float32",
    resume_y: np.ndarray | None = None,
    timings: dict | None = None,
    shard_mesh=None,
    device=None,
) -> ALSModelArrays:
    """Train ALS factor matrices on ``device`` (the card unless the caller
    names the CPU): the JAX package's single-device bucketed trainer.
    compute_dtype="bfloat16" feeds the normal-equation products
    bf16-rounded inputs with f32 products and sums (solves stay f32). resume_y replaces the
    random item-factor init with a [n_items, features] matrix (mid-build
    checkpoint resume: the per-sweep carry is fully determined by Y);
    seed_key is the ``torch.Generator`` the random init draws from.

    timings: pass a dict to receive {"lists_s", "compile_s", "train_s",
    "train_flops", "tf32"}; lists_s covers list building and upload, train_s the
    sweeps up to a synchronised end. Eager PyTorch compiles nothing, so
    compile_s is 0.0. Y is rewritten in place sweep by sweep (the JAX
    package's ``donate_y0`` has no counterpart).

    ``mesh`` and ``shard_mesh`` (data-parallel, tensor-parallel and
    row-sharded training) raise ValueError: multi-device training is
    ROADMAP queue 1 item 11. Each build records one ``train`` dispatch into
    common/perfstats.py (``_record_train_dispatch``).
    """
    if mesh is not None:
        raise ValueError(_NOT_PORTED_MESH.format("mesh"))
    if shard_mesh is not None:
        raise ValueError(_NOT_PORTED_MESH.format("shard_mesh"))
    dev = resolve_device(device)
    n_u, n_i = data.n_users, data.n_items
    if n_u == 0 or n_i == 0 or len(data.values) == 0:
        # covers both no-input and everything-deleted-by-NaN-markers
        raise ValueError("empty interaction data")

    t_mark = time.perf_counter()
    # bucketed lists: work scales with real row lengths instead of the
    # heaviest row's power-of-two padding (the JAX package's unit of 1024
    # rows is kept so buckets and blocks match its own)
    unit = 1024
    u_buckets, blocks_u = _cached_lists(
        "u_buckets", data, (cap, block, unit),
        lambda: build_bucketed_lists(
            data.users, data.items, data.values, n_u, cap,
            block=block, unit=unit,
        ),
    )
    i_buckets, blocks_i = _cached_lists(
        "i_buckets", data, (cap, block, unit),
        lambda: build_bucketed_lists(
            data.items, data.users, data.values, n_i, cap,
            block=block, unit=unit,
        ),
    )
    u_dev = _upload_buckets(u_buckets, n_u, dev)
    i_dev = _upload_buckets(i_buckets, n_i, dev)
    if resume_y is not None:
        y0 = torch.tensor(np.asarray(resume_y, dtype=np.float32), device=dev)
    else:
        g = seed_key if seed_key is not None else RandomManager.get_generator(dev)
        y0 = (
            torch.randn((n_i, features), generator=g, device=g.device)
            * 0.1
            + 1.0 / math.sqrt(features)
        ).to(dev)
    # analytic FLOPs of the whole build over the rows actually solved
    # (dominant product terms only — ops/flops.py)
    flops_half_u = sum(
        als_halfstep_flops(b[1].shape[0], b[1].shape[1], features, 0)
        for b in u_dev
    ) + 2.0 * n_i * features * features
    flops_half_i = sum(
        als_halfstep_flops(b[1].shape[0], b[1].shape[1], features, 0)
        for b in i_dev
    ) + 2.0 * n_u * features * features
    train_flops = iterations * (flops_half_u + flops_half_i)
    if timings is not None:
        _sync(dev)
        timings["lists_s"] = time.perf_counter() - t_mark
        timings["train_flops"] = train_flops
        timings["compile_s"] = 0.0
    t_exec = time.perf_counter()
    x, y = _als_train_bucketed(
        u_dev, i_dev, y0, float(lam), float(alpha),
        implicit=implicit, iterations=iterations,
        blocks_u=blocks_u, blocks_i=blocks_i, n_u=n_u,
        compute_dtype=compute_dtype, timings=timings,
    )
    _sync(dev)
    train_s = time.perf_counter() - t_exec
    if timings is not None:
        timings["train_s"] = train_s
    _record_train_dispatch(
        u_dev, i_dev, train_flops, train_s, n_u, n_i, features, dev
    )
    return _finish_model(x.cpu().numpy(), y.cpu().numpy(), n_u, n_i, data)


def _record_train_dispatch(
    u_dev, i_dev, train_flops, train_s, n_u, n_i, features, device
) -> None:
    """Report one build's sweeps (FLOPs, approximate bytes: the uploaded
    lists plus both factor tables, wall-clock) to the runtime perf
    accounting — the train-side twin of the serving batcher's records.
    The products run in f32 with TF32 off whatever ``compute_dtype``
    rounds the inputs to, so MFU reads against the f32 peak. Lists hold
    live rows only, so occupancy is 1. Never lets accounting break
    training."""
    try:
        from oryx_tpu_torch.common.perfstats import get_perfstats
        from oryx_tpu_torch.ops.flops import peak_flops_for_name

        ps = get_perfstats()
        if device.type == "cuda":
            ps.ensure_peak("train", lambda: peak_flops_for_name(
                torch.cuda.get_device_name(device), "float32"))
        bytes_moved = float(
            sum(t.nbytes for bucket in u_dev + i_dev for t in bucket)
            + (n_u + n_i) * features * 4
        )
        ps.record_dispatch(
            "train",
            flops=train_flops, bytes_moved=bytes_moved, wall_s=train_s,
            rows=n_u + n_i, padded_rows=n_u + n_i,
            valid_rows=n_u + n_i, capacity_rows=n_u + n_i,
        )
    except Exception:  # accounting must not break builds
        log.warning("train dispatch accounting failed", exc_info=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_als_checkpointed(
    data: InteractionData,
    checkpoint_dir,
    checkpoint_every: int,
    features: int = 10,
    lam: float = 0.001,
    alpha: float = 1.0,
    iterations: int = 10,
    implicit: bool = True,
    mesh=None,
    cap: int = 1024,
    block: int = 1024,
    seed_key=None,
    compute_dtype: str = "float32",
    shard_mesh=None,
    device=None,
) -> ALSModelArrays:
    """train_als with mid-build checkpoints every `checkpoint_every`
    sweeps: a preempted/killed build resumes from the last checkpoint
    instead of restarting, and the resumed run equals the uninterrupted
    one exactly (the per-sweep carry is fully determined by Y, which is
    what gets saved). The spirit of the reference's ALS
    checkpointInterval(5) (ALSUpdate.java:144 breaks RDD lineage every 5
    iterations), re-aimed at the failure mode long builds on the card
    actually have. Checkpoints are atomic (tmp + rename), fingerprinted
    against the exact training configuration, and removed on success.
    """
    import json as _json
    import os
    from pathlib import Path

    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    ck_dir = Path(checkpoint_dir)
    ck_dir.mkdir(parents=True, exist_ok=True)
    ck = ck_dir / "als-train.ckpt.npz"
    import zlib

    # sampled content hash: time-decayed re-aggregation after a crash can
    # produce the same SHAPES with different values; a stale checkpoint
    # must not be accepted against different data
    sample = slice(None, None, max(1, len(data.values) // 262_144))
    data_crc = zlib.crc32(np.ascontiguousarray(data.values[sample]).tobytes())
    data_crc = zlib.crc32(np.ascontiguousarray(data.users[sample]).tobytes(), data_crc)
    data_crc = zlib.crc32(np.ascontiguousarray(data.items[sample]).tobytes(), data_crc)
    fingerprint = _json.dumps(
        {
            "n_users": data.n_users,
            "n_items": data.n_items,
            "nnz": int(len(data.values)),
            "data_crc": data_crc,
            "features": features,
            "lam": float(lam),
            "alpha": float(alpha),
            "implicit": implicit,
            "compute_dtype": compute_dtype,
            "iterations": iterations,
        },
        sort_keys=True,
    )

    done = 0
    resume_y = None
    if ck.exists():
        try:
            with np.load(ck, allow_pickle=False) as z:
                if str(z["fingerprint"]) == fingerprint:
                    done = int(z["done"])
                    resume_y = z["y"]
                    log.info("resuming ALS build from checkpoint: %d/%d sweeps done",
                             done, iterations)
        except Exception:  # noqa: BLE001 - a torn checkpoint means restart
            log.warning("ignoring unreadable ALS checkpoint %s", ck)

    kwargs = dict(
        features=features, lam=lam, alpha=alpha, implicit=implicit,
        mesh=mesh, cap=cap, block=block, compute_dtype=compute_dtype,
        shard_mesh=shard_mesh, device=device,
    )
    # checkpoints are only written mid-build (done < iterations) and the
    # fingerprint pins `iterations`, so done < iterations always holds
    # here; clamp defensively anyway — X is derived from Y, so at least
    # one sweep must run
    done = min(done, iterations - 1)
    model = None
    while done < iterations:
        chunk = min(max(1, checkpoint_every), iterations - done)
        model = train_als(
            data, iterations=chunk, seed_key=seed_key,
            resume_y=resume_y, **kwargs,
        )
        done += chunk
        resume_y = model.y
        if done < iterations:
            tmp = str(ck) + ".tmp"
            np.savez(tmp, y=model.y, done=done, fingerprint=fingerprint)
            # np.savez appends .npz to names without it
            os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", ck)
    if ck.exists():
        ck.unlink()
    return model


def train_als_warm(
    data: InteractionData,
    features: int = 10,
    lam: float = 0.001,
    alpha: float = 1.0,
    iterations: int = 10,
    implicit: bool = True,
    mesh=None,
    cap: int = 1024,
    block: int = 1024,
    seed_key=None,
    compute_dtype: str = "float32",
    resume_y: np.ndarray | None = None,
    tol: float = 0.0,
    min_iterations: int = 1,
    check_every: int = 2,
    shard_mesh=None,
    device=None,
) -> tuple[ALSModelArrays, int]:
    """train_als with a convergence-based early stop for warm starts.

    Runs `check_every`-sweep chunks and stops once the model's
    PREDICTIONS stop moving: the relative change of x_u·y_i over a fixed
    deterministic sample of observed interactions drops below `tol`.
    Predictions, not factor norms — an ALS factor pair keeps drifting
    along near-degenerate directions (scale/rotation trades between X
    and Y) long after the scores it produces have settled, so a
    Frobenius-on-Y test either never fires or needs a uselessly loose
    threshold. Respects the `min_iterations` floor. A warm resume_y from
    the previous generation typically converges in a fraction of the
    cold iteration count.
    Returns (model, sweeps actually run).

    tol <= 0 disables the early stop (one full-length train_als call).
    """
    if tol <= 0 or iterations <= max(1, check_every):
        m = train_als(
            data, features=features, lam=lam, alpha=alpha,
            iterations=iterations, implicit=implicit, mesh=mesh, cap=cap,
            block=block, seed_key=seed_key, compute_dtype=compute_dtype,
            resume_y=resume_y, shard_mesh=shard_mesh, device=device,
        )
        return m, iterations
    check_every = max(1, check_every)
    # deterministic stride sample of observed pairs (same idiom as the
    # checkpoint fingerprint): cheap, stable across chunks, and scored
    # where the model is actually used
    nnz = len(data.values)
    samp = slice(None, None, max(1, nnz // 4096))
    su, si = data.users[samp], data.items[samp]
    done = 0
    prev_y = resume_y
    prev_pred = None
    model = None
    while done < iterations:
        chunk = min(check_every, iterations - done)
        model = train_als(
            data, features=features, lam=lam, alpha=alpha,
            iterations=chunk, implicit=implicit, mesh=mesh, cap=cap,
            block=block, seed_key=seed_key, compute_dtype=compute_dtype,
            resume_y=prev_y, shard_mesh=shard_mesh, device=device,
        )
        done += chunk
        pred = (model.x[su] * model.y[si]).sum(axis=1)
        if prev_pred is not None:
            denom = float(np.linalg.norm(prev_pred)) or 1.0
            rel = float(np.linalg.norm(pred - prev_pred)) / denom
            if done >= min_iterations and rel < tol:
                log.info(
                    "ALS early stop at sweep %d/%d (relative prediction "
                    "change %.2e < tol %.2e)", done, iterations, rel, tol,
                )
                break
        prev_y, prev_pred = model.y, pred
    return model, done


def _row_pad(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


# ---------------------------------------------------------------------------
# bucketed lists: rows grouped by interaction count so light rows don't pay
# the heaviest row's padding
# ---------------------------------------------------------------------------

_prepared_lists_cache: dict = {}

# Distinct (data object, list kind, params) entries kept at once. Eviction
# normally rides weakref.finalize when the data object dies; the cap is
# the backstop for non-weakrefable data objects (finalize refuses those)
# and for long-lived processes cycling many live datasets — without it a
# hyperparameter sweep over fresh InteractionData objects grows the cache
# (and the multi-GB padded lists inside it) without bound.
_PREPARED_LISTS_CAP = 16


def _cached_lists(tag: str, data, params: tuple, build):
    """Memoize padded/bucketed list construction per InteractionData object
    (and scalar build parameters). The checkpointed trainer re-enters
    train_als once per chunk with the SAME data object; rebuilding the
    lists each chunk would repeat minutes of host work on large builds.
    Entries die with the data object via weakref.finalize, or with the
    oldest-entry cap for objects finalize can't track."""
    key = (id(data), tag, params)
    hit = _prepared_lists_cache.get(key)
    if hit is not None:
        return hit[0]
    out = build()
    try:
        weakref.ref(data)
        # weakref-able: one finalizer per data object purges all its
        # entries the moment it is collected
        if not any(k[0] == id(data) for k in _prepared_lists_cache):
            weakref.finalize(data, _purge_prepared, id(data))
        pin = None
    except TypeError:
        # data isn't weakref-able (e.g. a slotted/plain-tuple stand-in in
        # tests): cache anyway — but PIN the object in EVERY entry.
        # Untracked, id(data) could be reused by a new object at the same
        # address after this one dies, silently serving another dataset's
        # lists; per-entry pins survive cap eviction of a sibling entry,
        # and the cap bounds what the pins can keep alive.
        pin = data
    while len(_prepared_lists_cache) >= _PREPARED_LISTS_CAP:
        _prepared_lists_cache.pop(next(iter(_prepared_lists_cache)))
    _prepared_lists_cache[key] = (out, pin)
    return out


def _purge_prepared(obj_id: int) -> None:
    for k in [k for k in _prepared_lists_cache if k[0] == obj_id]:
        _prepared_lists_cache.pop(k, None)


def build_bucketed_lists(
    entity: np.ndarray,
    other: np.ndarray,
    values: np.ndarray,
    n_entities: int,
    cap: int = 1024,
    edges: tuple[int, ...] = (128, 512, 1024),
    min_rows: int = 4096,
    block: int = 1024,
    unit: int = 1024,
) -> tuple[list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]], list[int]]:
    """Like build_padded_lists, but rows are grouped into width buckets.

    One global P pads every row to the heaviest row's next power of two —
    at MovieLens-25M shape the mean row is ~150 interactions against
    P=1024, so >6x of the gather traffic and normal-equation FLOPs are
    padding. Here each row lands in the smallest bucket width that holds
    it (capped like before; largest-|value| kept on truncation), so the
    einsum work is proportional to the data, not to the tail.

    Returns (buckets, blocks): per bucket (rows [S] int32 into the entity
    axis, idx [S,P], val [S,P], mask [S,P]) with S padded to a multiple of
    its block AND of `unit` (the JAX package's jit cache keys on rounded
    sizes; padding rows carry id n_entities, and the port's
    _upload_buckets cuts them off); blocks holds the per-bucket block size,
    capped at the caller's `block` working-set bound. Buckets with fewer
    than min_rows rows merge upward to bound compile variants, and each
    bucket's width clips to its own max row length so merged-up small
    datasets never pad past their data.
    """
    edges_arr = [e for e in edges if e < cap] + [cap]
    counts = np.bincount(entity, minlength=n_entities)
    cape = np.minimum(counts, cap)
    b_of = np.searchsorted(edges_arr, cape)  # smallest edge >= cape
    sizes = np.bincount(b_of, minlength=len(edges_arr))
    for j in range(len(edges_arr) - 1):  # merge small buckets upward
        if 0 < sizes[j] < min_rows:
            sizes[j + 1] += sizes[j]
            sizes[j] = 0
            b_of[b_of == j] = j + 1

    # rank interactions within each row, largest |value| first (truncation
    # keeps the most informative entries — same policy as the flat builder)
    order = np.lexsort((-np.abs(values), entity))
    e, o, v = entity[order], other[order], np.asarray(values)[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(e)) - np.repeat(starts, counts)
    pe = np.asarray(edges_arr)[b_of]
    keep = rank < pe[e]
    e, o, v, rank = e[keep], o[keep], v[keep], rank[keep]

    buckets = []
    blocks = []
    for j, p_edge in enumerate(edges_arr):
        rows = np.nonzero(b_of == j)[0]
        if rows.size == 0:
            continue
        # clip the width to this bucket's real max row length: an upward
        # merge of a small dataset must not pad everyone to the cap edge
        p_need = int(cape[rows].max()) if rows.size else 1
        p = 1 << max(0, min(int(p_edge), max(p_need, 1)) - 1).bit_length()
        blk = min(block, max(64, (1 << 20) // p))
        blk = 1 << (blk.bit_length() - 1)  # pow2 so it divides the unit
        u = max(blk, unit)  # pow2 >= blk -> multiples of u divide by blk
        s = -(-rows.size // u) * u
        blk = min(blk, s)
        pos_of = np.full(n_entities, -1, dtype=np.int64)
        pos_of[rows] = np.arange(rows.size)
        m = b_of[e] == j
        idx = np.zeros((s, p), dtype=np.int32)
        val = np.zeros((s, p), dtype=np.float32)
        mask = np.zeros((s, p), dtype=np.float32)
        idx[pos_of[e[m]], rank[m]] = o[m]
        val[pos_of[e[m]], rank[m]] = v[m]
        mask[pos_of[e[m]], rank[m]] = 1.0
        rows_padded = np.full(s, n_entities, dtype=np.int32)
        rows_padded[: rows.size] = rows
        buckets.append((rows_padded, idx, val, mask))
        blocks.append(blk)
    return buckets, blocks


# ---------------------------------------------------------------------------
# incremental fold-in (speed layer + anonymous serving estimates)
# ---------------------------------------------------------------------------

def compute_target_qui(value, current, *, implicit: bool):
    """Target predicted-strength after an interaction of ``value``.

    Implicit: interpolate from the current prediction toward 1 (positive
    value) or 0 (negative), fraction value/(1+value); NaN means "no change
    needed" (already out of range). Explicit: the value itself.
    Parity: ALSUtils.computeTargetQui (…/als/ALSUtils.java:37-60).
    """
    if not implicit:
        return value
    pos = (value > 0.0) & (current < 1.0)
    neg = (value < 0.0) & (current > 0.0)
    up = current + (value / (1.0 + value)) * (1.0 - torch.clamp(current, min=0.0))
    dn = current + (value / (value - 1.0)) * (-torch.clamp(current, max=1.0))
    nan = torch.full_like(current, float("nan"))
    return torch.where(pos, up, torch.where(neg, dn, nan))


def fold_in_batch(chol, values, xus, yis, *, implicit: bool = True):
    """Fold one interaction per row into user vectors: [N] values, [N, K]
    current vectors (all-zero = new user, whose current prediction counts
    as 0.5) and [N, K] item vectors against one [K, K] lower Cholesky
    factor of Y'Y. Returns the [N, K] updated vectors; a NaN target leaves
    its row unchanged. Parity: ALSUtils.computeUpdatedXu
    (…/als/ALSUtils.java:74-106), and the JAX package's vmapped
    ``fold_in_batch`` / ``fold_in_batch_explicit``."""
    had_xu = (xus != 0.0).any(dim=1)
    qui = torch.where(had_xu, (xus * yis).sum(dim=1), torch.zeros_like(values))
    current = torch.where(had_xu, qui, torch.full_like(qui, 0.5))
    target = compute_target_qui(values, current, implicit=implicit)
    dqui = torch.where(torch.isnan(target), torch.zeros_like(target), target - qui)
    rhs = (dqui[:, None] * yis)[:, :, None]
    lower = chol.expand(xus.shape[0], -1, -1)
    z = torch.linalg.solve_triangular(lower, rhs, upper=False)
    dxu = torch.linalg.solve_triangular(lower.transpose(-1, -2), z, upper=True)
    return xus + dxu[:, :, 0]


def compute_updated_xu(chol, value, xu, yi, *, implicit: bool):
    """``fold_in_batch`` for one interaction: [K] vector in, [K] out."""
    value = torch.as_tensor(value, dtype=xu.dtype, device=xu.device)
    return fold_in_batch(
        chol, value.reshape(1), xu[None, :], yi[None, :], implicit=implicit
    )[0]


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _plain_topk(xs, y, k: int, scales=None, sx=None):
    vals, idx = [], []
    for lo, hi in _row_chunks(xs.shape[0], y.shape[0]):
        s = _scores(xs[lo:hi], y, scales)
        if sx is not None:
            s = s * sx[lo:hi, None]
        v, i = _stable_topk(s, k)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def topk_dot_batch_xla(xs, y, *, k: int):
    """Batched plain top-k: one [B, I] product in f32 and a stable sort, in
    (value desc, index asc) order -- the counterpart of the JAX package's
    XLA form (matmul + lax.top_k)."""
    return _plain_topk(xs, y, k)


def topk_dot_batch_approx(xs, y, *, k: int, recall: float):
    """Approximate top-k at a recall target. ``jax.lax.approx_max_k``
    computes exactly off the TPU, and so does this: the exact plain form
    (recall is accepted for signature parity)."""
    del recall
    return _plain_topk(xs, y, k)


def topk_dot_batch_quant_xla(xs, q, scale, *, k: int, recall: float = 1.0):
    """Batched top-k over an int8 item matrix (q [I,F] int8, scale [I] f32):
    queries quantize per row as the kernel's do, the dot of the quantized
    values is exact in f32 (each sum stays below 2^24), and scores are
    (dot * scale) * sx, selected after both scales as in the JAX form.
    recall < 1 computes exactly (see topk_dot_batch_approx)."""
    del recall
    xq, sx = quantize_queries(xs)
    return _plain_topk(xq, q, k, scales=scale, sx=sx)


def topk_dot_batch(xs, y, *, k: int, recall: float = 1.0):
    """Batched top-k scoring. Exact requests with k <= PALLAS_TOPK_MAX_K go
    to the fused kernel wrapper (ops/topk.py), for both a bf16/f32 item
    matrix and a QuantizedMatrix: on a CUDA tensor that is always the
    hand-written kernel, and a failure raises -- there is no silent
    fallback. k > 128 and recall < 1 take the plain large product."""
    if isinstance(y, QuantizedMatrix):
        if recall >= 1.0 and k <= PALLAS_TOPK_MAX_K:
            return topk_dot_batch_cuda(xs, y.q, k=k, scales=y.scale)
        return topk_dot_batch_quant_xla(xs, y.q, y.scale, k=k, recall=recall)
    if xs.dtype != y.dtype:
        # mixed-precision queries score in the matrix's dtype (the bf16
        # serving view); accumulation is f32 either way
        xs = xs.to(y.dtype)
    if recall < 1.0:
        return topk_dot_batch_approx(xs, y, k=k, recall=float(recall))
    if k <= PALLAS_TOPK_MAX_K:
        return topk_dot_batch_cuda(xs, y, k=k)
    return topk_dot_batch_xla(xs, y, k=k)
