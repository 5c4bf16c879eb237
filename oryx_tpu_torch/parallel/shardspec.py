"""Row-shard planning for factor matrices (the port's copy of
oryx_tpu/parallel/shardspec.py, with torch devices).

One logical factor matrix (the ALS item-factor table, the seq
item-embedding table) sharded by ROW: each shard owns a contiguous row
range, serves its own slice of the fused top-k scan, and receives ONLY its
own dirty rows on delta sync. The plan here is the single source of truth
for "which shard owns row r": the serving view build, the dirty-row
scatter split, the per-shard sync accounting and the cross-shard merge
(ops/shard_topk.py) all read the same bounds.

The partitioning contract is ``process_groups``'s (contiguous groups in
input order, sizes as equal as possible with the LARGER groups first, k
clamped to [1, n]), kept once, in parallel/submesh.py, as in the JAX
package.

The port's serving views hold live rows only, so a store that grows past
its plan appends the new rows to the LAST shard (``grown``): every row
keeps its owner, and a delta still touches only the shards that own its
rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.parallel.submesh import process_groups


@dataclass(frozen=True)
class RowShards:
    """A contiguous row partition of an [n, ...] matrix: shard s owns
    rows [bounds[s], bounds[s+1]). Immutable; ``plan`` builds one, and
    ``grown`` extends one."""

    bounds: tuple[int, ...]  # len n_shards + 1, monotone, bounds[0] == 0

    @staticmethod
    def plan(n_rows: int, n_shards: int) -> "RowShards":
        """Partition n_rows rows into min(n_shards, max(n_rows, 1))
        contiguous shards on the process_groups contract. n_rows == 0
        keeps the requested shard count with all-empty shards, so a
        shard-count-S view is S-sharded from its first build."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_rows < 0:
            raise ValueError(f"n_rows must be >= 0, got {n_rows}")
        if n_rows == 0:
            return RowShards(bounds=(0,) * (n_shards + 1))
        bounds = [0]
        for g in process_groups(list(range(n_rows)), n_shards):
            bounds.append(bounds[-1] + len(g))
        return RowShards(bounds=tuple(bounds))

    def grown(self, n_rows: int) -> "RowShards":
        """This plan with rows [total, n_rows) appended to the last
        shard: no row changes owner."""
        if n_rows < self.total:
            raise ValueError(f"cannot shrink {self.total} rows to {n_rows}")
        return RowShards(bounds=self.bounds[:-1] + (int(n_rows),))

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def total(self) -> int:
        return self.bounds[-1]

    def size(self, shard: int) -> int:
        return self.bounds[shard + 1] - self.bounds[shard]

    def lo(self, shard: int) -> int:
        return self.bounds[shard]

    def owner(self, row: int) -> int:
        """The shard owning global row index ``row``."""
        if not 0 <= row < self.total:
            raise IndexError(f"row {row} outside [0, {self.total})")
        # empty shards share a boundary value: side="right" - 1 lands on
        # the one that actually contains the row
        return int(np.searchsorted(np.asarray(self.bounds), row, side="right") - 1)

    def split(
        self, idx: np.ndarray, rows: np.ndarray | None = None
    ) -> list[tuple[int, np.ndarray, np.ndarray | None]]:
        """Split a dirty-row delta (global indices + row payloads) by
        owning shard: [(shard, local_idx, rows_slice)] for every shard
        that owns at least one dirty row. An empty delta splits to an
        empty list, and a delta touching one shard yields exactly one
        entry. Order within a shard keeps the caller's delta order."""
        idx = np.asarray(idx)
        if idx.size == 0:
            return []
        if (idx < 0).any() or (idx >= self.total).any():
            bad = idx[(idx < 0) | (idx >= self.total)]
            raise IndexError(
                f"delta rows {bad[:4].tolist()} outside [0, {self.total})"
            )
        owners = np.searchsorted(np.asarray(self.bounds), idx, side="right") - 1
        out: list[tuple[int, np.ndarray, np.ndarray | None]] = []
        for s in range(self.n_shards):
            sel = owners == s
            if not sel.any():
                continue
            local = idx[sel] - self.bounds[s]
            out.append((s, local, None if rows is None else np.asarray(rows)[sel]))
        return out

    def slices(self, mat):
        """The per-shard row slices of a matrix (views, not copies)."""
        return [mat[self.bounds[s]:self.bounds[s + 1]] for s in range(self.n_shards)]


def local_devices(platform=None) -> list[torch.device]:
    """This process's devices: every CUDA card (the default), or the one
    device ``platform`` names (``device="cpu"``, ``"cuda:1"``)."""
    from oryx_tpu_torch.device import resolve_device

    dev = resolve_device(platform)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def shard_devices(n_shards: int, devices=None) -> list[torch.device]:
    """One placement device per shard: the first n_shards devices when
    that many exist (each shard's scan then runs on its own card), else
    the devices cycled. On a one-card host every shard maps to the card,
    and the sharded path is the layout of a multi-card host on one card.
    ``devices`` defaults to ``local_devices()``."""
    devices = list(local_devices() if devices is None else devices)
    if not devices:
        raise ValueError("no devices to place shards on")
    return [torch.device(devices[s % len(devices)]) for s in range(n_shards)]
