"""Cross-shard top-k: per-shard partial lists, merged exactly (the port's
counterpart of oryx_tpu/ops/shard_topk.py).

A row-sharded item view (``ops/transfer.ShardedMatrix``) is scored shard by
shard with the hand-written partial kernel (``topk_dot_partial``, in the
shard's type: bf16, or int8 with the shard's row scales), each on the
shard's own device. Every shard's split lists, their indices rebased to
global rows by the shard's ``plan.lo(s)``, are stacked along the split
axis and merged by ONE launch of the ported ``topk_merge`` kernel -- the
counterpart of the TPU kernel's ``_merge_top`` one level up. A dispatch
over S non-empty shards launches S partial kernels and one merge. The
(value desc, index asc) order that makes the in-kernel merge match
``jax.lax.top_k`` makes the cross-shard merge match scoring the unsharded
view: a row's score does not depend on the shard that holds it, and ties
go to the lower global index.

``merge_topk_partials`` merges lists of uneven widths: each is padded to
one width with (-inf, INT32_MAX), which loses every comparison with a real
candidate, and the stack [S, B, width] goes through ``topk_merge``.

On the CPU both functions run the kernels' plain versions. On the card
every merge is the kernel: a list wider than its 128 slots raises, as
``topk_merge`` does. A recall target below 1 scores each shard as the
unsharded path does (``ops/als.topk_dot_batch``) and merges through the
kernel. No kernel takes k > 128, on either view: the unsharded view answers
it with the library product and a stable sort, and the sharded view does
the same, each shard's library top-k then one stable sort of their union
(``_library_topk``).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from oryx_tpu_torch.ops.topk import (
    MAX_K,
    _lex_sort_desc,
    _next_pow2,
    _scores,
    _stable_topk,
    launch_plan,
    quantize_queries,
    topk_dot_partial,
    topk_merge,
)
from oryx_tpu_torch.ops.transfer import QuantizedMatrix

# index carried by merge padding slots: loses every (value desc, index
# asc) comparison against any real candidate at equal value
_PAD_IDX = np.iinfo(np.int32).max

_MERGE_METRICS = None
_MERGE_METRICS_LOCK = threading.Lock()


def _merge_metrics():
    """(merge-seconds histogram,): process-wide, registered on first use
    so importing this module never touches the registry."""
    global _MERGE_METRICS
    if _MERGE_METRICS is None:
        with _MERGE_METRICS_LOCK:
            if _MERGE_METRICS is None:
                from oryx_tpu_torch.common.metrics import (
                    MICROBATCH_BUCKETS, get_registry,
                )

                _MERGE_METRICS = (
                    get_registry().histogram(
                        "oryx_shard_merge_seconds",
                        "host seconds of one cross-shard top-k merge (the "
                        "stack of the shards' partial lists and the merge "
                        "launch; the per-shard scans it concludes ride "
                        "oryx_device_dispatch_seconds)",
                        buckets=MICROBATCH_BUCKETS,
                    ),
                )
    return _MERGE_METRICS


def _pad_tail(a: torch.Tensor, width: int, value) -> torch.Tensor:
    pad = width - a.shape[-1]
    if pad <= 0:
        return a
    return torch.cat([a, a.new_full((*a.shape[:-1], pad), value)], dim=-1)


def merge_topk_partials(partials, k: int):
    """Exact top-k of the union of per-shard top-k lists.

    partials: [(vals [B, k_s], idx [B, k_s])] per shard, each row sorted
    by (value desc, index asc) with GLOBAL indices. Returns ([B, k] f32,
    [B, k] int32) in that order, on the first list's device. Padding
    slots carry (-inf, INT32_MAX). The merge is ``topk_merge``: on the
    card a padded width over its 128 slots raises ValueError."""
    if not partials:
        raise ValueError("merge_topk_partials needs at least one partial")
    width = _next_pow2(max(k, max(int(v.shape[-1]) for v, _ in partials)))
    dev = torch.as_tensor(partials[0][0]).device
    vals = torch.stack([
        _pad_tail(torch.as_tensor(v).to(dev, torch.float32), width, float("-inf"))
        for v, _ in partials
    ])
    idx = torch.stack([
        _pad_tail(torch.as_tensor(i).to(dev, torch.int32), width, _PAD_IDX)
        for _, i in partials
    ])
    return topk_merge(vals, idx, k=k)


def _shard_partials(xq: torch.Tensor, shard, lo: int, kb: int):
    """[S_s, B, kb] partial lists of one shard, global indices: the
    partial kernel over the shard's own launch plan on the card, its plain
    version (one split) on the CPU."""
    quantized = isinstance(shard, QuantizedMatrix)
    y = shard.q if quantized else shard
    scales = shard.scale if quantized else None
    xs = xq.to(y.device).contiguous()
    if y.device.type == "cpu":
        s_all = _scores(xs, y, scales)
        v, i = _stable_topk(s_all, kb)
        pv, pi = v[None], i[None]
    else:
        n_splits, split_len = launch_plan(xs.shape[0], y, kb)
        pv, pi = topk_dot_partial(
            xs, y, kb=kb, n_splits=n_splits, split_len=split_len, scales=scales
        )
    return pv, torch.where(pi >= 0, pi + lo, pi)


def _library_topk(xs, sm, live, k: int):
    """k > 128, where no kernel applies on either view: each shard's
    top-k through ``ops/als.topk_dot_batch`` (the library product and
    stable sort, the unsharded view's route for such k, on a shard of more
    than 128 rows), then one stable sort of the shards' union by (value
    desc, index asc)."""
    from oryx_tpu_torch.ops.als import topk_dot_batch

    dev0 = sm.device
    vals, idx = [], []
    for s, shard in live:
        v, i = topk_dot_batch(
            xs.to(shard.device), shard, k=min(k, int(shard.shape[0])),
        )
        vals.append(v.to(dev0))
        idx.append((i + sm.plan.lo(s)).to(dev0))
    v, i = _lex_sort_desc(torch.cat(vals, dim=1), torch.cat(idx, dim=1))
    return v[:, :k].contiguous(), i[:, :k].contiguous()


def topk_dot_batch_sharded(xs, sm, *, k: int, recall: float = 1.0):
    """Batched top-k over a ShardedMatrix ``sm``: exact for any row
    partition. ``xs`` [B, F] queries (f32 or the view's type). Returns
    ([B, k] f32, [B, k] int32) in (value desc, index asc) order on the
    first shard's device.

    Exact requests with k <= 128 run the partial kernel on each non-empty
    shard (in its type) and one ``topk_merge`` over all shards' split
    lists. A recall target below 1 takes ``ops.als.topk_dot_batch`` on each
    shard at the same target, and ``merge_topk_partials`` merges the
    shards' lists; k > 128 takes ``_library_topk``. k above the view's
    rows raises ValueError, as the unsharded kernel's contract does."""
    total = sm.plan.total
    if k > total:
        raise ValueError(f"k={k} exceeds total rows {total}")
    quantized = isinstance(sm.shards[0], QuantizedMatrix)
    live = [(s, shard) for s, shard in enumerate(sm.shards)
            if int(shard.shape[0]) > 0]
    dev0 = sm.device
    if k > MAX_K:
        return _library_topk(xs, sm, live, k)
    if recall < 1.0:
        from oryx_tpu_torch.ops.als import topk_dot_batch

        partials = []
        for s, shard in live:
            v, i = topk_dot_batch(
                xs.to(shard.device), shard,
                k=min(k, int(shard.shape[0])), recall=recall,
            )
            partials.append((v.to(dev0), (i + sm.plan.lo(s)).to(dev0)))
        t0 = time.monotonic()
        out = merge_topk_partials(partials, k)
        _merge_metrics()[0].observe(time.monotonic() - t0)
        return out
    sx = None
    if quantized:
        xq, sx = quantize_queries(xs)
    else:
        xq = xs.to(sm.dtype)
    kb = _next_pow2(k)
    parts = [_shard_partials(xq, shard, sm.plan.lo(s), kb) for s, shard in live]
    t0 = time.monotonic()
    part_v = torch.cat([v.to(dev0) for v, _ in parts])
    part_i = torch.cat([i.to(dev0) for _, i in parts])
    vals, idx = topk_merge(part_v, part_i, k=k)
    _merge_metrics()[0].observe(time.monotonic() - t0)
    if sx is not None:
        vals = vals * sx.to(vals.device)[:, None]
    return vals, idx
