"""Host->device transfers of the serving item matrix (the port's counterpart
of the parts of oryx_tpu/ops/transfer.py the single-card view needs).

- ``staged_device_put`` uploads in bounded row chunks into one preallocated
  device tensor, so peak device memory stays at one matrix plus one chunk.
- ``QuantizedMatrix`` is the int8 view (rows + per-row f32 scales) that
  ``score-mode=quantized`` scores: half the bytes of the bf16 view.
- ``scatter_rows`` applies a dirty-row delta to a device view: only the
  delta rows cross the host link (the TensorFlow pattern of device-resident
  state updated by sparse scatters, PAPERS: TensorFlow, 2016).

Item views are pitched: the rows of an ``[n, F]`` view sit at a pitch of
F x itemsize rounded up to 16 bytes (``pitched_empty``), as the narrow view
``buf[:, :F]`` of an ``[n, pitch]`` buffer whose padding columns hold
zeros. The top-k kernel loads item tiles with the Tensor Memory Accelerator,
whose row strides must be multiples of 16 bytes; a bf16 row at F=50 is 100
bytes and an int8 row 50. The logical shape stays ``[n, F]``, so plain
PyTorch code sees the same values as before.

- ``ShardedMatrix`` is a row-sharded view: shard s (a pitched tensor, or a
  QuantizedMatrix) holds the rows a ``parallel/shardspec.RowShards`` plan
  gives it, on its own device (one card per shard where the host has them,
  the card cycled otherwise). ``ops/shard_topk.py`` scores it shard by
  shard and merges the partial lists; ``scatter_rows`` routes a dirty-row
  delta into the owning shards only. Views hold live rows, so rows
  appended past the plan join the last shard (``RowShards.grown``).

A view larger than its device's memory raises (``_check_fits``, per shard
for a sharded view). The JAX package's chunked view exists for the TPU's
remote-compile limit; the port's kernel takes its sizes at run time and
has no such limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from oryx_tpu_torch.device import resolve_device

DEFAULT_CHUNK_BYTES = 64 * 1024 * 1024
PITCH_ALIGN_BYTES = 16  # TMA: global row strides and base address


def row_pitch(features: int, dtype: torch.dtype) -> int:
    """Row pitch in elements of a pitched item view: ``features`` x itemsize
    rounded up to PITCH_ALIGN_BYTES (F=50: 56 bf16 or 64 int8; F=250: 256
    in both)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    row = features * itemsize
    return -(-row // PITCH_ALIGN_BYTES) * PITCH_ALIGN_BYTES // itemsize


def pitched_empty(n: int, features: int, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """An ``[n, features]`` view of a new ``[n, row_pitch]`` buffer on
    ``device`` whose padding columns hold zeros (the rest is left for the
    caller to fill)."""
    buf = torch.empty((n, row_pitch(features, dtype)), dtype=dtype,
                      device=device)
    buf[:, features:].zero_()
    return buf[:, :features]


def is_pitched(t: torch.Tensor) -> bool:
    """True for a 2-D view with dense rows, a row stride that is a multiple
    of 16 bytes and a 16-byte aligned start: what the top-k kernel takes."""
    return (t.ndim == 2 and t.stride(1) == 1
            and (t.stride(0) * t.element_size()) % PITCH_ALIGN_BYTES == 0
            and t.data_ptr() % PITCH_ALIGN_BYTES == 0)


def to_pitched(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is pitched, else a pitched copy of the 2-D
    tensor ``t`` on its device."""
    if is_pitched(t):
        return t
    out = pitched_empty(t.shape[0], t.shape[1], t.dtype, t.device)
    out.copy_(t)
    return out


def _check_fits(n_bytes: int, device: torch.device) -> None:
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        if n_bytes > total:
            raise ValueError(
                f"a {n_bytes}-byte view does not fit the {total} bytes of "
                f"{device}; shard it across cards "
                "(oryx.serving.api.sync.shard-count)"
            )


def staged_device_put(
    a: np.ndarray,
    dtype: torch.dtype | None = None,
    device=None,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> torch.Tensor:
    """Upload ``a`` to ``device`` (default: the card) as ``dtype`` in row
    chunks of at most ``chunk_bytes`` of host data, written into one
    preallocated device tensor: a pitched view (``pitched_empty``) for a
    2-D matrix, a dense tensor otherwise. The copy is complete when this
    returns."""
    device = resolve_device(device)
    src = torch.from_numpy(np.ascontiguousarray(a))
    out_dtype = src.dtype if dtype is None else dtype
    itemsize = torch.empty((), dtype=out_dtype).element_size()
    if src.ndim == 2:
        n, f = src.shape
        _check_fits(n * row_pitch(f, out_dtype) * itemsize, device)
        out = pitched_empty(n, f, out_dtype, device)
    else:
        _check_fits(src.numel() * itemsize, device)
        out = torch.empty(src.shape, dtype=out_dtype, device=device)
    if src.ndim == 0 or src.shape[0] == 0:
        out.copy_(src)
        return out
    row_bytes = max(1, src[0].numel() * src.element_size())
    rows_per = max(1, chunk_bytes // row_bytes)
    for start in range(0, src.shape[0], rows_per):
        out[start:start + rows_per].copy_(src[start:start + rows_per])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def quantize_rows_int8(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: (q int8 [N,F], scale f32 [N])
    with row = q * scale to within scale/2 per element. All-zero rows get
    scale 1.0 so dequantization stays exact zeros (capacity padding rows
    ride through unharmed)."""
    a = np.asarray(mat, dtype=np.float32)
    m = np.max(np.abs(a), axis=1) if a.size else np.zeros(a.shape[0])
    scale = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(a / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


class QuantizedMatrix:
    """Device item matrix in int8 with per-row f32 scales. Quacks like a
    tensor where the serving batcher needs it (shape / dtype / device /
    nbytes); scoring dispatches through the int8 variant of the fused
    kernel, which multiplies the row scales in before selection."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        if q.shape[0] != scale.shape[0]:
            raise ValueError(
                f"quantized rows/scales mismatch: {q.shape[0]} vs {scale.shape[0]}"
            )
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes + self.scale.nbytes)

    def unit_scaled(self) -> "QuantizedMatrix":
        """The cosine (row-normalized) view, SHARING the int8 rows:
        unit(q·s) = q/||q||, so normalization is a new scale vector alone
        (1/||q_row||, zero rows stay zero) and costs no second item matrix
        on the card."""
        return QuantizedMatrix(self.q, _int8_unit_scales(self.q))


def _int8_unit_scales(q: torch.Tensor, rows_per: int = 1 << 20) -> torch.Tensor:
    """1/||q_row|| per row (0 for zero rows), converted to f32 a row block
    at a time so no full f32 copy of the matrix is ever resident."""
    out = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    for lo in range(0, q.shape[0], rows_per):
        qf = q[lo:lo + rows_per].float()
        norms = torch.sqrt((qf * qf).sum(dim=1))
        out[lo:lo + rows_per] = torch.where(
            norms > 0, 1.0 / torch.clamp(norms, min=1e-12),
            torch.zeros_like(norms),
        )
    return out


def quantized_device_put(a: np.ndarray, device=None) -> QuantizedMatrix:
    """Quantize a host f32 matrix per row and upload it (staged) as a
    QuantizedMatrix device view: pitched int8 rows, ``[n]`` f32 scales."""
    q, scale = quantize_rows_int8(a)
    return QuantizedMatrix(
        staged_device_put(q, device=device),
        staged_device_put(scale, device=device),
    )


def scatter_rows(buf, idx: np.ndarray, rows: np.ndarray,
                 n_rows: int | None = None):
    """A copy of device matrix ``buf`` with ``rows`` written at row indices
    ``idx``. Only the delta rows cross the host->device link. ``buf`` itself
    is left as it was: in-flight coalesced dispatches (serving/batcher.py)
    still score it, so the new view is a second buffer until the caller
    swaps it in and drops the old one.

    ``n_rows`` (at least ``buf``'s rows) grows the copy to that many rows,
    zero past ``buf``'s end: the store's appended rows, which the caller
    writes through ``idx``. The copy is a new buffer either way, so growth
    costs nothing more and the view never holds a row that is not live.
    The copy of a 2-D item view is pitched (``pitched_empty``).

    A QuantizedMatrix re-quantizes ONLY the dirty rows (each row's scale is
    independent), so an update storm never requantizes the whole matrix.
    A ShardedMatrix scatters into the shards that own the dirty rows and
    keeps every other shard (the same object); growth joins the last
    shard."""
    idx = np.asarray(idx, dtype=np.int64)
    n_old = buf.shape[0]
    n_rows = n_old if n_rows is None else int(n_rows)
    if n_rows < n_old:
        raise ValueError(f"cannot shrink {n_old} rows to {n_rows}")
    if idx.shape[0] == 0 and n_rows == n_old:
        return buf
    if isinstance(buf, ShardedMatrix):
        plan = buf.plan.grown(n_rows)
        shards = list(buf.shards)
        last = plan.n_shards - 1
        touched = {s: (local, sel) for s, local, sel in plan.split(
            idx, np.arange(idx.size, dtype=np.int64))}
        if n_rows > n_old:
            touched.setdefault(last, (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        rows = np.asarray(rows)
        for s, (local, sel) in touched.items():
            shards[s] = scatter_rows(
                shards[s], local, rows[sel], plan.size(s) if s == last else None
            )
        return ShardedMatrix(shards, plan)
    if isinstance(buf, QuantizedMatrix):
        q_rows, s_rows = quantize_rows_int8(np.asarray(rows, dtype=np.float32))
        return QuantizedMatrix(
            scatter_rows(buf.q, idx, q_rows, n_rows),
            scatter_rows(buf.scale, idx, s_rows, n_rows),
        )
    device = buf.device
    idx_t = torch.from_numpy(idx).to(device)
    rows_t = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    if buf.ndim == 2:
        # an item view: the copy is pitched (clone() of a narrow view would
        # come back dense and lose the pitch)
        out = pitched_empty(n_rows, buf.shape[1], buf.dtype, device)
        out[:n_old] = buf
        out[n_old:] = 0
    elif n_rows == n_old:
        out = buf.clone()
    else:
        out = buf.new_zeros((n_rows, *buf.shape[1:]))
        out[:n_old] = buf
    out.index_copy_(0, idx_t, rows_t.to(buf.dtype))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


class ShardedMatrix:
    """Row-sharded device matrix: shards[s] (a pitched tensor, or a
    QuantizedMatrix for score-mode=quantized) holds the rows
    [plan.bounds[s], plan.bounds[s+1]) of the logical matrix. Quacks like a
    tensor where the serving batcher needs it (shape / dtype / device /
    nbytes); scoring dispatches through ops.shard_topk.topk_dot_batch_sharded,
    and scatter_rows routes a dirty-row delta into the owning shards
    only."""

    __slots__ = ("shards", "plan")

    def __init__(self, shards, plan):
        self.shards = list(shards)
        self.plan = plan
        if len(self.shards) != plan.n_shards:
            raise ValueError(
                f"{len(self.shards)} shards for a {plan.n_shards}-shard plan"
            )
        for s, shard in enumerate(self.shards):
            if int(shard.shape[0]) != plan.size(s):
                raise ValueError(
                    f"shard {s} has {shard.shape[0]} rows, plan owns "
                    f"{plan.size(s)}"
                )

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shape(self):
        return (self.plan.total,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device: where the merge runs."""
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        return int(sum(s.nbytes for s in self.shards))

    def map(self, fn) -> "ShardedMatrix":
        """Per-shard row-local transform (e.g. row normalization for the
        cosine view); anything cross-shard belongs in the merge."""
        return ShardedMatrix([fn(s) for s in self.shards], self.plan)


def sharded_device_put(
    a: np.ndarray,
    n_shards: int,
    dtype: torch.dtype | None = None,
    quantize: bool = False,
    device=None,
    devices=None,
) -> ShardedMatrix:
    """Upload a host matrix as a ShardedMatrix: rows partitioned by
    ``RowShards.plan``, shard s staged onto its own placement device
    (``shard_devices``: ``devices``, else every card of ``device``'s kind,
    cycled). quantize=True builds per-shard QuantizedMatrix views; per-row
    scales are row-local, so a shard-local quantization is bit-identical to
    quantizing the whole matrix and slicing."""
    from oryx_tpu_torch.parallel.shardspec import RowShards, local_devices, shard_devices

    a = np.asarray(a)
    plan = RowShards.plan(a.shape[0], n_shards)
    devs = shard_devices(
        plan.n_shards, local_devices(device) if devices is None else devices
    )
    shards = []
    for s in range(plan.n_shards):
        block = a[plan.bounds[s]:plan.bounds[s + 1]]
        if quantize:
            shards.append(quantized_device_put(block, device=devs[s]))
        else:
            shards.append(staged_device_put(block, dtype=dtype, device=devs[s]))
    return ShardedMatrix(shards, plan)


def scatter_transfer_bytes(d: int, row_itemsize: int, features: int) -> int:
    """Host->device bytes one scatter_rows call moves for ``d`` dirty rows:
    the rows plus their int64 indices. (The JAX package pads deltas up a
    bucket ladder to bound its compile cache; eager PyTorch needs no
    padding, so the port moves exactly ``d`` rows.)"""
    if d == 0:
        return 0
    return d * (features * row_itemsize + 8)


def quantized_scatter_bytes(d: int, features: int) -> int:
    """scatter_transfer_bytes for a QuantizedMatrix delta: the int8 row
    scatter plus the per-row f32 scale scatter, each with its own int64
    index vector."""
    if d == 0:
        return 0
    return d * (features + 8) + d * (4 + 8)


def row_capacity(n: int, headroom: float) -> int:
    """Row capacity of the serving view's host mirror for an ``n``-row
    store: ``n`` grown by ``headroom`` then rounded up a ~N/8-granular
    bucket ladder, so speed-layer growth updates the mirror in place until
    a bucket boundary (the device view holds live rows only). Monotone in
    ``n``; buckets step geometrically instead of pure pow2 rounding, which
    would waste up to 2x device memory at 20M-row scale."""
    target = max(64, math.ceil(n * (1.0 + max(0.0, headroom))))
    unit = 1 << max(6, target.bit_length() - 3)
    return -(-target // unit) * unit
