"""Shared device-view sync helpers (the port's copy of
oryx_tpu/serving/viewsync.py).

Any app serving a FactorStore-backed device matrix keeps it in step
with the live store by dirty-row delta (``FactorStore.delta_since`` +
``ops/transfer.scatter_rows``). The pieces that are identical across apps
live here — the dirty-delta id-list extension and the process-wide sync
metric families — so every serving model reports into ONE
``oryx_device_sync_*`` vocabulary. (The view-tuple state machines stay
per app.) A sharded view reports each shard's bytes under
``{shard="sN"}`` (``sharded_delta_bytes``) and each shard's live rows on
``oryx_shard_rows`` (``set_shard_rows``).
"""

from __future__ import annotations

import logging
import threading

from oryx_tpu_torch.common.metrics import MICROBATCH_BUCKETS, get_registry

log = logging.getLogger(__name__)

_SYNC_METRICS = None
_SYNC_METRICS_LOCK = threading.Lock()


def view_sync_metrics():
    """(bytes counter, seconds histogram, resync counter, lsh histogram,
    shard-rows gauge) — process-wide, lazily registered so importing this
    module never touches the registry."""
    global _SYNC_METRICS
    if _SYNC_METRICS is None:
        with _SYNC_METRICS_LOCK:
            if _SYNC_METRICS is None:
                reg = get_registry()
                _SYNC_METRICS = (
                    reg.counter(
                        "oryx_device_sync_bytes",
                        "host->device bytes moved keeping serving views in "
                        "sync (delta scatters move dirty rows; full "
                        "resyncs move the whole matrix). The unlabeled "
                        "series is the process total; on a sharded view "
                        "each {shard=\"sN\"} series carries the bytes that "
                        "landed on that shard's device — a dirty-row "
                        "delta touching one shard moves ~1/S of a "
                        "full-matrix sync",
                    ),
                    reg.histogram(
                        "oryx_device_sync_seconds",
                        "wall-clock per serving view resync (delta or full)",
                        buckets=MICROBATCH_BUCKETS,
                    ),
                    reg.counter(
                        "oryx_view_resync_total",
                        "serving view resyncs by kind (delta = dirty-row "
                        "scatter; full = snapshot rebuild, including the "
                        "initial load)",
                        labeled=True,
                    ),
                    reg.histogram(
                        "oryx_lsh_rebuild_seconds",
                        "wall-clock per full LSH partition-index rebuild "
                        "(delta reassignments ride oryx_device_sync_seconds)",
                        buckets=MICROBATCH_BUCKETS,
                    ),
                    reg.gauge(
                        "oryx_shard_rows",
                        "valid (non-padding) rows each shard of the "
                        "sharded serving view owns, by {shard=\"sN\"} — "
                        "absent on unsharded views",
                        labeled=True,
                    ),
                )
    return _SYNC_METRICS


def note_sync_bytes(m_bytes, total: int, by_shard: dict[int, int] | None) -> None:
    """Record one resync's host->device traffic: the unlabeled process
    total, plus — on a sharded view — a {shard="sN"} series per shard the
    delta actually landed on (each shard's scatter is its own
    bucket-padded transfer to that shard's device)."""
    m_bytes.inc(total)
    if by_shard:
        for s, n in by_shard.items():
            if n:
                m_bytes.inc(n, shard=f"s{s}")


def set_shard_rows(gauge, plan, n_valid: int) -> None:
    """Publish per-shard live-row ownership for a sharded view: shard s
    owns rows [bounds[s], bounds[s+1]), of which the rows below the store
    size n_valid are live (all of them: the port's views hold live rows
    only)."""
    for s in range(plan.n_shards):
        lo, hi = plan.bounds[s], plan.bounds[s + 1]
        gauge.set(float(max(0, min(n_valid, hi) - lo)), shard=f"s{s}")


def sharded_delta_bytes(plan, rows, bytes_of_d) -> tuple[int, dict[int, int]]:
    """(total, {shard: bytes}) one dirty-row delta moves into a sharded
    view: rows split by owning shard (parallel/shardspec), each shard's
    slice priced by ``bytes_of_d`` (its own scatter). A delta confined to
    one shard produces exactly one entry."""
    import numpy as np

    by_shard = {
        s: int(bytes_of_d(len(local)))
        for s, local, _ in plan.split(np.asarray(rows))
    }
    return sum(by_shard.values()), by_shard


def extend_view_ids(ids: list, delta) -> list | None:
    """Extend a view's id list with the delta's appended rows, in row
    order. Every index in [len(ids), delta.n) was dirty-logged by the
    write that created it, so the delta must carry its id; None (with a
    warning — the caller falls back to a full resync) if that invariant
    ever breaks."""
    if delta.n <= len(ids):
        return ids
    by_row = dict(zip((int(r) for r in delta.rows), delta.ids))
    try:
        return ids + [by_row[r] for r in range(len(ids), delta.n)]
    except KeyError:
        log.warning("delta missing ids for appended rows; full resync")
        return None
