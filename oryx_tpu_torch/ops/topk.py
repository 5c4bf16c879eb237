"""Fused score + top-k for the serving path: the counterpart of
oryx_tpu/ops/pallas_topk.py.

``topk_dot_batch_cuda`` returns, per query row, the exact top-k of
``xs @ y.T`` ordered by (value desc, index asc) -- the order of
``jax.lax.top_k`` and of the TPU kernel's bitonic network -- without
materializing the [B, I] score matrix. On a CUDA tensor it launches two
hand-written kernels (csrc/topk_dot.cu, whose header explains the design and
its bound): ``topk_dot_partial`` scores item splits in parallel and keeps a
sorted top-kb per (split, row); ``topk_merge`` merges the splits' lists. A
quantized item matrix (int8 rows + per-row f32 scales, ops/transfer.py)
scores int8 x int8 -> int32, times the item scale before selection; the
per-query scale multiplies the returned values afterwards (a positive
per-row factor never changes that row's order).

The partial kernel reads the item matrix through a TMA tensor map, so on
the card ``y`` must be a pitched view (ops/transfer.py): rows 16-byte
aligned at a stride that is a multiple of 16 bytes. The wrapper raises on
any other layout; it never copies Y per call.

Every wrapper takes its plain PyTorch version for a tensor on the CPU, and
only then: on a CUDA tensor it launches its kernel or raises. Each kernel
counts its launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import threading
import time

import torch

from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops.transfer import is_pitched, to_pitched

MAX_K = 128  # the running top-k is at most one 128-slot list per row

# block geometry of the partial kernel, every type; must match
# csrc/topk_dot.cu
ROWS_PER_BLOCK = 64   # one warpgroup (wgmma M = 64)
TILE_ITEMS = 64       # items per TMA tile (wgmma N = 64)

# launches per kernel since the last reset_launches(); bumped only where a
# kernel is launched
LAUNCHES = {"topk_dot_partial": 0, "topk_merge": 0}
# the partial kernel's launches split by the item matrix's type
PARTIAL_LAUNCHES_BY_TYPE = {"float32": 0, "bfloat16": 0, "int8": 0}

_PARTIAL_ENTRY = {
    torch.float32: "oryx_topk_dot_partial_f32",
    torch.bfloat16: "oryx_topk_dot_partial_bf16",
    torch.int8: "oryx_topk_dot_partial_i8",
}


def reset_launches() -> None:
    for counts in (LAUNCHES, PARTIAL_LAUNCHES_BY_TYPE):
        for name in counts:
            counts[name] = 0


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded topk_dot library (the
    checkout's, or a variant the kernel probe built); returns ``lib``."""
    if not getattr(lib, "_oryx_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for dtype, name in _PARTIAL_ENTRY.items():
            fn = getattr(lib, name)
            fn.argtypes = (
                [p, p] + ([p] if dtype == torch.int8 else []) + [p, p]
                + [i] * 8 + [p]
            )
            fn.restype = i
        lib.oryx_topk_merge.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.oryx_topk_merge.restype = i
        for name in ("oryx_topk_partial_smem_bytes",
                     "oryx_topk_partial_blocks_per_sm",
                     "oryx_topk_partial_streams_queries"):
            if hasattr(lib, name):  # a parent build may predate one
                getattr(lib, name).argtypes = [i, i, i]
                getattr(lib, name).restype = i
        lib.oryx_topk_max_features.argtypes = [i, i]
        lib.oryx_topk_max_features.restype = i
        lib._oryx_bound = True
    return lib


_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
# monotonic start of the library's first load while it runs, else None
_LOAD_STARTED: float | None = None


def library_loaded() -> bool:
    """Whether the kernel library is loaded in this process."""
    return _LIB is not None


def library_load_started() -> float | None:
    """Monotonic start of the kernel library's first load while that load
    is in flight (an nvcc build when the build directory is cold), else
    None. The serving batcher's wedge watchdog grants compile grace while
    it is set."""
    return _LOAD_STARTED


def _lib() -> ctypes.CDLL:
    """The kernel library, loaded (built first if need be) on first use.
    That first load is this package's one cold compile: it is recorded
    once as a serving compile and as a compile_stall idle gap
    (common/perfattr.py)."""
    global _LIB, _LOAD_STARTED
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                t0 = time.monotonic()
                _LOAD_STARTED = t0
                try:
                    lib = bind(_build.load("topk_dot"))
                finally:
                    _LOAD_STARTED = None
                _LIB = lib
                seconds = time.monotonic() - t0
                from oryx_tpu_torch.common.perfattr import get_perfattr

                pa = get_perfattr()
                pa.record_compile("serving", seconds)
                pa.record_idle_gap("compile_stall", seconds)
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------

def _lex_sort_desc(v: torch.Tensor, i: torch.Tensor):
    """Sort the last axis by (value desc, index asc): index-ascending
    first, then a stable value-descending sort keeps that order on ties."""
    o = torch.argsort(i, dim=-1, stable=True)
    v, i = v.gather(-1, o), i.gather(-1, o)
    o = torch.argsort(v, dim=-1, descending=True, stable=True)
    return v.gather(-1, o), i.gather(-1, o)


def _stable_topk(scores: torch.Tensor, k: int):
    """Top-k of each row by (value desc, index asc). ``torch.topk`` does not
    promise that order on ties; a stable descending sort does. Slots past
    the row length hold (-inf, -1)."""
    b, n = scores.shape
    kk = min(k, n)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :kk], idx[:, :kk].to(torch.int32)
    if kk < k:
        vals = torch.cat(
            [vals, vals.new_full((b, k - kk), float("-inf"))], dim=1
        )
        idx = torch.cat([idx, idx.new_full((b, k - kk), -1)], dim=1)
    return vals, idx


def _row_chunks(b: int, n_items: int):
    """Row ranges that keep a plain [rows, n_items] score block near 2^28
    elements, so the plain versions fit the card at catalog scale."""
    step = max(1, (1 << 28) // max(1, n_items))
    return [(lo, min(b, lo + step)) for lo in range(0, b, step)]


def _scores(xs: torch.Tensor, y: torch.Tensor, scales=None) -> torch.Tensor:
    """f32 scores of xs against y. Full f32 products: TF32 is off, as the
    JAX reference computes with Precision.HIGHEST. int8 inputs give exact
    integer sums (each stays below 2^24), times the item scale. The TF32
    switch is restored afterwards: other products in the process keep
    theirs."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = xs.float() @ y.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    if scales is not None:
        s = s * scales.float()[None, :]
    return s


def f32_tolerance(features: int) -> float:
    """How far an f32 score of ``features`` unit-variance products, from
    the kernel or the plain version, may lie from its exact (float64)
    value: 32 f32 unit roundoffs per feature. Full-f32 sums in any order
    drift by about one roundoff per feature; TF32 products (10-bit
    mantissas) drift by about 4e-4 sqrt(features), which this rejects.
    The checks of the f32 kernel on the card hold it to this."""
    return 32 * 2.0 ** -24 * features


def quantize_queries(xs: torch.Tensor):
    """Per-row symmetric int8 quantization of a query block: (q int8,
    scale f32 [B]), the twin of the JAX package's ``quantize_queries``
    (round half to even, clip to +-127). The scale is ``ax * f32(1/127)``,
    not ``ax / 127``: that is what XLA compiles the JAX division to, and
    the JAX function always runs compiled on the serving path."""
    xf = xs.float()
    ax = xf.abs().amax(dim=1)
    sx = torch.where(ax > 0, ax * (1.0 / 127.0), torch.ones_like(ax))
    q = torch.clamp(torch.round(xf / sx[:, None]), -127, 127).to(torch.int8)
    return q, sx


def topk_dot_batch_reference(xs, y, *, k: int, scales=None):
    """Plain version of ``topk_dot_batch_cuda``: the whole score block and a
    stable sort, row chunk by row chunk. Same inputs, same outputs, same
    order; slots past n_items hold (-inf, -1)."""
    sx = None
    if scales is not None:
        xs, sx = quantize_queries(xs)
    vals, idx = [], []
    for lo, hi in _row_chunks(xs.shape[0], y.shape[0]):
        v, i = _stable_topk(_scores(xs[lo:hi], y, scales), k)
        vals.append(v)
        idx.append(i)
    vals, idx = torch.cat(vals), torch.cat(idx)
    if sx is not None:
        vals = vals * sx[:, None]
    return vals, idx


def topk_dot_partial_reference(xs, y, *, kb: int, n_splits: int,
                               split_len: int, scales=None):
    """Plain version of the partial kernel: for each split s of the items
    [s * split_len, (s + 1) * split_len), the sorted top-kb of each row,
    as [S, B, kb] values and global indices ((-inf, -1) past the split's
    end). ``xs`` is already in the kernel's input type (int8 queries for a
    quantized ``y``)."""
    n = y.shape[0]
    b = xs.shape[0]
    out_v = torch.empty((n_splits, b, kb), dtype=torch.float32,
                        device=y.device)
    out_i = torch.empty((n_splits, b, kb), dtype=torch.int32,
                        device=y.device)
    for lo_r, hi_r in _row_chunks(b, n):
        s_all = _scores(xs[lo_r:hi_r], y, scales)
        for s in range(n_splits):
            lo, hi = s * split_len, min(n, (s + 1) * split_len)
            v, i = _stable_topk(s_all[:, lo:hi], kb)
            out_v[s, lo_r:hi_r] = v
            out_i[s, lo_r:hi_r] = torch.where(i >= 0, i + lo, i)
    return out_v, out_i


def topk_merge_reference(part_v, part_i, *, k: int):
    """Plain version of the merge kernel: the top-k of each row over its S
    sorted partial lists, by (value desc, index asc)."""
    s, b, kb = part_v.shape
    v = part_v.permute(1, 0, 2).reshape(b, s * kb)
    i = part_i.permute(1, 0, 2).reshape(b, s * kb)
    v, i = _lex_sort_desc(v, i)
    return v[:, :k].contiguous(), i[:, :k].contiguous()


def merge_top(av, ai, bv, bi):
    """Exact top-L of two sorted length-L lists along the last axis, in
    (value desc, index asc) order -- the counterpart of pallas_topk's
    ``_merge_top`` (there a bitonic split + merge)."""
    length = av.shape[-1]
    v, i = _lex_sort_desc(torch.cat([av, bv], -1), torch.cat([ai, bi], -1))
    return v[..., :length], i[..., :length]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def block_geometry(dtype: torch.dtype) -> tuple[int, int]:
    """(query rows per block, items per tile) of the partial kernel for an
    item matrix of ``dtype``: one geometry for every type it takes."""
    if dtype not in _PARTIAL_ENTRY:
        raise ValueError(f"no partial kernel for {dtype}")
    return ROWS_PER_BLOCK, TILE_ITEMS


def plan_splits(b: int, n_items: int, sm_count: int, blocks_per_sm: int = 4,
                rows_per_block: int = ROWS_PER_BLOCK,
                tile_items: int = TILE_ITEMS) -> tuple[int, int]:
    """(n_splits, split_len) for the partial kernel: as many item splits as
    let (row blocks x splits) run in one wave of ``blocks_per_sm`` resident
    blocks on every SM (at least one split), each split a whole number of
    ``tile_items``-item tiles and at least four of them."""
    row_blocks = -(-b // rows_per_block)
    tiles = -(-n_items // tile_items)
    splits = max(1, blocks_per_sm * sm_count // row_blocks)
    splits = min(splits, max(1, tiles // 4))
    split_len = -(-tiles // splits) * tile_items
    return -(-n_items // split_len), split_len


_BLOCKS_PER_SM: dict[tuple, int] = {}
_MAX_FEATURES: dict[tuple, int] = {}


def max_features(kb: int, dtype: torch.dtype,
                 lib: ctypes.CDLL | None = None) -> int:
    """The widest item rows (features) the partial kernel takes for a
    top-kb of an item matrix of ``dtype``: a bf16 or int8 block's shared
    memory holds the query block, whose size grows with the width; f32
    streams it past a width and takes up to 65,535 (asked of the kernel
    library once per kb and type)."""
    lib = _lib() if lib is None else bind(lib)
    itemsize = torch.empty((), dtype=dtype).element_size()
    key = (id(lib), kb, itemsize)
    if key not in _MAX_FEATURES:
        _MAX_FEATURES[key] = lib.oryx_topk_max_features(kb, itemsize)
    return _MAX_FEATURES[key]


def check_features(features: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel serves ``features``-wide item
    rows of ``dtype`` at every k up to MAX_K (bf16 up to 1,024 features,
    int8 up to 2,048, f32 up to 65,535). A model checks it when it is built
    on the card, so a too-wide one fails once, at load, instead of on every
    request."""
    widest = max_features(MAX_K, dtype)
    if features > widest:
        raise ValueError(
            f"{features} features: the top-k kernel takes at most {widest} "
            f"for a {dtype} item view"
        )


def launch_plan(b: int, y: torch.Tensor, kb: int) -> tuple[int, int]:
    """``plan_splits`` for ``b`` query rows against the item matrix ``y`` on
    its card, with the block geometry of ``y``'s type and as many resident
    blocks per SM as the partial kernel's shared memory and registers allow
    there (asked of the CUDA runtime once per shape)."""
    key = (y.device.index, y.shape[1], kb, y.element_size())
    per_sm = _BLOCKS_PER_SM.get(key)
    if per_sm is None:
        per_sm = _lib().oryx_topk_partial_blocks_per_sm(
            y.shape[1], kb, y.element_size())
        if per_sm < 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {-per_sm}")
        if per_sm == 0:
            raise ValueError(f"{y.shape[1]} features need more shared memory than a block has")
        _BLOCKS_PER_SM[key] = per_sm
    sm_count = torch.cuda.get_device_properties(y.device).multi_processor_count
    rows, tile = block_geometry(y.dtype)
    return plan_splits(b, y.shape[0], sm_count, per_sm, rows, tile)


def _check_tensors(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def check_item_view(y: torch.Tensor) -> None:
    """Raise ValueError unless ``y`` is a pitched item view: dense rows
    (stride 1 along features) whose row stride is a multiple of 16 bytes,
    starting at a 16-byte aligned address -- what the kernel's TMA tensor
    map needs. The 2-D views built by ops/transfer.py
    (``staged_device_put``, ``quantized_device_put``, ``scatter_rows``,
    ``to_pitched``) are; the kernel never copies Y per call."""
    if not is_pitched(y):
        raise ValueError(
            "the kernel takes a pitched item view (row stride a multiple of "
            f"16 bytes, 16-byte aligned); got strides {tuple(y.stride())} "
            f"of {y.element_size()}-byte elements at address "
            f"{y.data_ptr():#x}: build it with ops.transfer.to_pitched"
        )


def topk_dot_partial(xs, y, *, kb: int, n_splits: int, split_len: int,
                     scales=None, lib: ctypes.CDLL | None = None):
    """Launch ``topk_dot_partial``: [S, B, kb] sorted partial top-kb lists
    (f32 values, int32 global indices, (-inf, -1) in unfilled slots). ``y``
    is a pitched item view (``check_item_view``); f32 queries too wide for
    a resident query block are passed on pitched as well (a copy where
    ``xs`` is not), as the kernel then tiles them with TMA. ``lib`` launches a variant's build instead of the
    checkout's (the kernel probe's use). On the CPU:
    ``topk_dot_partial_reference``."""
    if y.device.type == "cpu":
        return topk_dot_partial_reference(
            xs, y, kb=kb, n_splits=n_splits, split_len=split_len,
            scales=scales,
        )
    b, n_feat = xs.shape
    n_items = y.shape[0]
    if y.dtype not in _PARTIAL_ENTRY or xs.dtype != y.dtype:
        raise ValueError(f"unsupported types xs {xs.dtype}, y {y.dtype}")
    if y.ndim != 2 or y.shape[1] != n_feat:
        raise ValueError(f"shapes xs {tuple(xs.shape)}, y {tuple(y.shape)}")
    if not 1 <= kb <= MAX_K:
        raise ValueError(f"kb must be in [1, {MAX_K}], got {kb}")
    quantized = y.dtype == torch.int8
    if quantized != (scales is not None):
        raise ValueError("scales go with an int8 item matrix, and only then")
    _check_tensors(xs, *([scales] if quantized else []))
    if y.device != xs.device:
        raise ValueError(f"tensors on {y.device} and {xs.device}")
    check_item_view(y)
    lib = _lib() if lib is None else bind(lib)
    if n_feat > max_features(kb, y.dtype, lib):
        raise ValueError(
            f"{n_feat} features: the kernel takes at most "
            f"{max_features(kb, y.dtype, lib)} at kb={kb} for {y.dtype}"
        )
    if quantized and scales.dtype != torch.float32:
        raise ValueError("item scales must be float32")
    if y.dtype == torch.float32 and lib.oryx_topk_partial_streams_queries(
            n_feat, kb, 4):
        xs = to_pitched(xs)
    part_v = torch.empty((n_splits, b, kb), dtype=torch.float32,
                         device=y.device)
    part_i = torch.empty((n_splits, b, kb), dtype=torch.int32,
                         device=y.device)
    ptrs = [xs.data_ptr(), y.data_ptr()] + (
        [scales.data_ptr()] if quantized else [])
    fn = getattr(lib, _PARTIAL_ENTRY[y.dtype])
    rc = fn(*ptrs, part_v.data_ptr(), part_i.data_ptr(), b, n_items, n_feat,
            y.stride(0), xs.stride(0), kb, n_splits, split_len,
            torch.cuda.current_stream(y.device).cuda_stream)
    _check(rc, "topk_dot_partial launch")
    LAUNCHES["topk_dot_partial"] += 1
    PARTIAL_LAUNCHES_BY_TYPE[str(y.dtype).removeprefix("torch.")] += 1
    return part_v, part_i


def topk_merge(part_v, part_i, *, k: int, lib: ctypes.CDLL | None = None):
    """Launch ``topk_merge``: the final [B, k] top-k over [S, B, kb]
    sorted partial lists (``lib`` as for ``topk_dot_partial``). On the CPU:
    ``topk_merge_reference``."""
    if part_v.device.type == "cpu":
        return topk_merge_reference(part_v, part_i, k=k)
    s, b, kb = part_v.shape
    if not 1 <= k <= kb <= MAX_K:
        raise ValueError(f"need 1 <= k <= kb <= {MAX_K}, got k={k} kb={kb}")
    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise ValueError("partials are float32 values and int32 indices")
    _check_tensors(part_v, part_i)
    out_v = torch.empty((b, k), dtype=torch.float32, device=part_v.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=part_v.device)
    lib = _lib() if lib is None else bind(lib)
    rc = lib.oryx_topk_merge(
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), b, s, kb, k,
        torch.cuda.current_stream(part_v.device).cuda_stream,
    )
    _check(rc, "topk_merge launch")
    LAUNCHES["topk_merge"] += 1
    return out_v, out_i


def topk_dot_batch_cuda(xs, y, *, k: int, scales=None):
    """Top-k of xs @ y.T per row without materializing the score matrix.

    xs: [B, F] queries in y's type (bf16 or f32), or f32/bf16 queries for an
    int8 ``y`` with per-row f32 ``scales`` (scores become
    (q(xs) @ y.T) * scale * sx). Returns ([B, k] f32 values, [B, k] int32
    indices) in (value desc, index asc) order; slots past n_items hold
    (-inf, -1). k <= 128. On the CPU: ``topk_dot_batch_reference``."""
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K}, got {k}")
    if y.device.type == "cpu":
        return topk_dot_batch_reference(xs, y, k=k, scales=scales)
    sx = None
    if scales is not None:
        xs, sx = quantize_queries(xs)
    kb = _next_pow2(k)
    n_splits, split_len = launch_plan(xs.shape[0], y, kb)
    part_v, part_i = topk_dot_partial(
        xs.contiguous(), y, kb=kb, n_splits=n_splits, split_len=split_len,
        scales=scales,
    )
    vals, idx = topk_merge(part_v, part_i, k=k)
    if sx is not None:
        vals = vals * sx[:, None]
    return vals, idx
