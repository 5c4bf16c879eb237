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

The split plan comes from a block table keyed by what a block's shared
memory depends on (``tuned_blocks``; the counterpart of pallas_topk's block
tuning): by default as many splits as fill one wave of the card, else a
split length set by the ``ORYX_TOPK_BLOCKS`` override or locked by
``autotune_blocks``, which times candidate plans on the card.

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
    theirs. On the CPU, bf16 inputs sum in float64 and round once: their
    products are exact there, so a score does not depend on how the host's
    BLAS blocks the product by the item count (a row scores the same in a
    shard of the view as in the whole view, as on the card)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if y.device.type == "cpu" and y.dtype == torch.bfloat16:
            s = (xs.double() @ y.double().T).float()
        else:
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
                tile_items: int = TILE_ITEMS,
                min_tiles: int = 4) -> tuple[int, int]:
    """(n_splits, split_len) for the partial kernel: as many item splits as
    let (row blocks x splits) run in one wave of ``blocks_per_sm`` resident
    blocks on every SM (at least one split), each split a whole number of
    ``tile_items``-item tiles and at least ``min_tiles`` of them."""
    row_blocks = -(-b // rows_per_block)
    tiles = -(-n_items // tile_items)
    splits = max(1, blocks_per_sm * sm_count // row_blocks)
    splits = min(splits, max(1, tiles // min_tiles))
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


# ---------------------------------------------------------------------------
# block tuning: a per-(feature chunks, itemsize, kb) table, autotunable on
# the card
# ---------------------------------------------------------------------------

# shared memory of the partial kernel's block; must match mma_plan in
# csrc/topk_dot.cu
_CHUNK_BYTES = 128                             # one swizzle span of features
_SWIZZLE_ALIGN = 1024                          # alignment slack
_TILE_CHUNK_BYTES = TILE_ITEMS * _CHUNK_BYTES  # an item chunk: a ring stage
_QUERY_CHUNK_BYTES = ROWS_PER_BLOCK * _CHUNK_BYTES
_MAX_STAGES = 8                                # ring stages
_TAIL = 24                                     # unsorted candidates a row holds
MAX_SMEM = 232_448                             # a block's limit (kMaxSmem)
_SM_SMEM = 233_472                             # an SM's shared memory
_BLOCK_RESERVED = 1024                         # the runtime's share per block

MIN_SPLIT = 4 * TILE_ITEMS  # plan_splits' shortest split: four tiles
MAX_SPLITS = 65_535         # the merge's bound on lists a row (topk_merge)
# The [S, B, kb] partial lists of a plan of more than one split may take
# at most this much card memory. Reading them once at the card's 3.35 TB/s
# takes 80 us, more than the bound of the whole serving call (B = 512,
# 1M x 50 bf16 items: 52 us), so a plan with more scratch has given up on
# the kernel's bound before it launches. One split is never refused: its
# lists are the least any plan needs.
PARTIAL_BUDGET_BYTES = 256 << 20

# block_key(...) -> (rows, items): the query rows of a block and the split
# length, or items None for plan_splits' wave on the caller's card. Filled
# lazily by the solver; overwritten by autotune_blocks' measured winners and
# by the ORYX_TOPK_BLOCKS override ("rows,items"). Every launch_plan without
# explicit blocks consults it, so one autotune pass retunes every later
# dispatch of that key. Its name is not the JAX package's
# ORYX_PALLAS_BLOCKS: those values are TPU VMEM blocks, and read as a
# Hopper plan they would mean something else.
_BLOCK_TABLE: dict[tuple[int, int, int], tuple[int, int | None]] = {}
BLOCKS_ENV = "ORYX_TOPK_BLOCKS"

# split lengths autotune_blocks measures, beside the wave-filling plan: from
# MIN_SPLIT up to the length that still gives the serving shape (1M items,
# 8 row blocks of B = 512) about one block per SM (16 splits x 8 = 128 of
# 132). Shared memory lets 1 to 4 partial blocks reside on an SM, so one
# wave is 132 to 528 blocks: at 1M items the range spans from under a
# quarter of a wave to about 30 waves. Shorter splits pay a block's start
# (its query block, its empty lists, where every score is a candidate) more
# often; longer ones leave SMs idle.
AUTOTUNE_BLOCK_I = tuple(1 << e for e in range(8, 17))  # 256 ... 65,536


def _pow2_floor(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def feature_chunks(features: int, itemsize: int) -> int:
    """The 128-byte chunks of a row of ``features`` items of ``itemsize``
    bytes: what a block's shared memory grows with."""
    return -(-features * itemsize // _CHUNK_BYTES)


def block_key(features: int, itemsize: int, kb: int) -> tuple[int, int, int]:
    """The block table's key: everything the partial kernel's shared memory
    depends on (``_working_set_bytes``)."""
    return feature_chunks(features, itemsize), int(itemsize), int(kb)


def _working_set_bytes(features: int, itemsize: int, kb: int) -> int:
    """A partial block's dynamic shared memory for a top-kb of rows of
    ``features`` items of ``itemsize`` bytes: the alignment slack, the
    query chunks, the ring's stages (as many, from 2 to 8, as keep the
    most blocks resident on an SM), a full and an empty mbarrier for each
    stage and the 64 rows' lists and tails. f32 rows too wide for a
    resident query block carry their query chunk in each stage instead.
    The Python twin of the kernel source's ``mma_plan``; the library's
    ``oryx_topk_partial_smem_bytes`` gives the same number."""
    lists = 8 * ROWS_PER_BLOCK * (kb + _TAIL + 1)
    fixed = (_SWIZZLE_ALIGN + feature_chunks(features, itemsize) * _QUERY_CHUNK_BYTES
             + 16 * _MAX_STAGES + lists)
    stage = _TILE_CHUNK_BYTES
    if itemsize == 4 and fixed + 2 * _TILE_CHUNK_BYTES > MAX_SMEM:
        fixed = _SWIZZLE_ALIGN + 16 * _MAX_STAGES + lists
        stage = _TILE_CHUNK_BYTES + _QUERY_CHUNK_BYTES
    stages, best = 2, 0
    for s in range(_MAX_STAGES, 1, -1):
        smem = fixed + s * stage
        blocks = 0 if smem > MAX_SMEM else _SM_SMEM // (smem + _BLOCK_RESERVED)
        if blocks > best:
            stages, best = s, blocks
    return fixed + stages * stage


def tuned_blocks(features: int, itemsize: int, kb: int) -> tuple[int, int | None]:
    """(rows, items) for a top-kb of rows of ``features`` items of
    ``itemsize`` bytes: the cached table entry if one exists (the override,
    an autotune winner or an earlier solve), else the ``ORYX_TOPK_BLOCKS``
    override ("rows,items", two positive integers; ValueError otherwise),
    else the solver's (ROWS_PER_BLOCK, None): the 64-row block and
    plan_splits' wave on the launching card. The solver raises ValueError
    where a block's shared memory cannot hold the rows."""
    import os

    key = block_key(features, itemsize, kb)
    hit = _BLOCK_TABLE.get(key)
    if hit is not None:
        return hit
    env = os.environ.get(BLOCKS_ENV)
    if env:
        try:
            rows, items = (int(t) for t in env.split(","))
        except ValueError:
            rows = items = 0
        if rows < 1 or items < 1:
            raise ValueError(
                f"{BLOCKS_ENV}={env!r}: want two positive integers, "
                f"'rows,items'")
        _BLOCK_TABLE[key] = (rows, items)
        return rows, items
    if _working_set_bytes(features, itemsize, kb) > MAX_SMEM:
        raise ValueError(
            f"{features} features: a top-{kb} block of {itemsize}-byte items "
            f"needs {_working_set_bytes(features, itemsize, kb)} bytes of "
            f"shared memory, more than a block's {MAX_SMEM}")
    _BLOCK_TABLE[key] = (ROWS_PER_BLOCK, None)
    return _BLOCK_TABLE[key]


def block_rows(block_b: int) -> int:
    """The query rows of a partial block for a requested ``block_b``: the
    kernel compiles 64-row blocks only (wgmma M), so 64 or more gives 64
    and fewer raises ValueError."""
    if block_b < ROWS_PER_BLOCK:
        raise ValueError(
            f"block_b={block_b}: the partial kernel's blocks hold "
            f"{ROWS_PER_BLOCK} query rows")
    return ROWS_PER_BLOCK


def split_length(block_i: int, n_items: int) -> int:
    """The split length (items one block walks) of an explicit ``block_i``:
    rounded DOWN to a power of two -- an operator shrinking the block gets
    at most what they asked for, never a larger one -- at least MIN_SPLIT
    and at most the power of two at or above ``n_items``. The JAX
    package's rule, with the port's minimum of four tiles in place of one
    lane tile."""
    if block_i < 1:
        raise ValueError(f"block_i must be positive, got {block_i}")
    return max(MIN_SPLIT, min(_pow2_floor(block_i), _next_pow2(n_items)))


def check_plan(b: int, kb: int, n_splits: int, split_len: int) -> None:
    """Raise ValueError for a plan the kernels cannot take: more splits
    than the merge takes (MAX_SPLITS), or, past one split, [S, B, kb]
    partial lists larger than PARTIAL_BUDGET_BYTES."""
    if n_splits > MAX_SPLITS:
        raise ValueError(
            f"{n_splits} splits of {split_len} items: the merge takes at "
            f"most {MAX_SPLITS}")
    need = 8 * n_splits * b * kb
    if n_splits > 1 and need > PARTIAL_BUDGET_BYTES:
        raise ValueError(
            f"{n_splits} splits of {split_len} items: {need} bytes of "
            f"partial lists for {b} rows at kb={kb}, past the budget of "
            f"{PARTIAL_BUDGET_BYTES}")


def _occupancy(y: torch.Tensor, kb: int,
               lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """(SMs, resident partial blocks per SM) of ``y``'s card for a top-kb
    of ``y``'s rows: as many blocks as the partial kernel's shared memory
    and registers allow there (asked of the CUDA runtime once per shape
    and library). Only a card has one."""
    if y.device.type != "cuda":
        raise ValueError(
            f"the wave-filling plan asks the card's occupancy; y is on "
            f"{y.device}")
    lib = _lib() if lib is None else bind(lib)
    key = (id(lib), y.device.index, y.shape[1], kb, y.element_size())
    per_sm = _BLOCKS_PER_SM.get(key)
    if per_sm is None:
        per_sm = lib.oryx_topk_partial_blocks_per_sm(
            y.shape[1], kb, y.element_size())
        if per_sm < 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {-per_sm}")
        if per_sm == 0:
            raise ValueError(f"{y.shape[1]} features need more shared memory than a block has")
        _BLOCKS_PER_SM[key] = per_sm
    sm_count = torch.cuda.get_device_properties(y.device).multi_processor_count
    return sm_count, per_sm


def launch_plan(b: int, y: torch.Tensor, kb: int, *,
                block_b: int | None = None, block_i: int | None = None,
                lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """(n_splits, split_len) of the partial kernel for ``b`` query rows
    against the item matrix ``y``. The blocks not given come from the
    table (``tuned_blocks``). An explicit split length -- an argument, the
    ``ORYX_TOPK_BLOCKS`` override or an autotune winner -- follows the
    round-down rule (``split_length``); the table's default is
    ``plan_splits``' wave for ``y``'s card (``lib``: the kernel library
    whose occupancy it asks, the checkout's by default). Raises
    ValueError for a plan the kernels cannot take (``check_plan``)."""
    t_bb, t_bi = tuned_blocks(y.shape[1], y.element_size(), kb)
    rows = block_rows(t_bb if block_b is None else block_b)
    block_i = t_bi if block_i is None else block_i
    n_items = y.shape[0]
    if block_i is None:
        sm_count, per_sm = _occupancy(y, kb, lib)
        _, tile = block_geometry(y.dtype)
        plan = plan_splits(b, n_items, sm_count, per_sm, rows, tile)
    else:
        split_len = split_length(block_i, n_items)
        plan = (-(-n_items // split_len), split_len)
    check_plan(b, kb, *plan)
    return plan


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


def _answer(xs, y, *, k: int, scales, n_splits: int, split_len: int):
    """The partial kernel over one plan, then the merge: the top-k of each
    row (quantizing f32/bf16 queries for an int8 ``y``). On the CPU both
    take their plain versions."""
    sx = None
    if scales is not None:
        xs, sx = quantize_queries(xs)
    part_v, part_i = topk_dot_partial(
        xs.contiguous(), y, kb=_next_pow2(k), n_splits=n_splits,
        split_len=split_len, scales=scales,
    )
    vals, idx = topk_merge(part_v, part_i, k=k)
    if sx is not None:
        vals = vals * sx[:, None]
    return vals, idx


def topk_dot_batch_cuda(xs, y, *, k: int, scales=None,
                        block_b: int | None = None,
                        block_i: int | None = None):
    """Top-k of xs @ y.T per row without materializing the score matrix.

    xs: [B, F] queries in y's type (bf16 or f32), or f32/bf16 queries for an
    int8 ``y`` with per-row f32 ``scales`` (scores become
    (q(xs) @ y.T) * scale * sx). Returns ([B, k] f32 values, [B, k] int32
    indices) in (value desc, index asc) order; slots past n_items hold
    (-inf, -1). k <= 128.

    block_b/block_i default to the block table (``tuned_blocks``): the
    64-row block and as many item splits as fill one wave of the card,
    unless the ``ORYX_TOPK_BLOCKS`` override or an ``autotune_blocks``
    winner set a split length. An explicit ``block_i`` is the split length,
    rounded down (``split_length``); ``block_b`` below 64 raises.

    On the CPU: ``topk_dot_batch_reference``, or, for an explicit
    ``block_i``, that plan through the partial and merge kernels' plain
    versions."""
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K}, got {k}")
    if y.device.type == "cpu" and block_i is None:
        if block_b is not None:
            block_rows(block_b)
        return topk_dot_batch_reference(xs, y, k=k, scales=scales)
    n_splits, split_len = launch_plan(
        xs.shape[0], y, _next_pow2(k), block_b=block_b, block_i=block_i)
    return _answer(xs, y, k=k, scales=scales, n_splits=n_splits,
                   split_len=split_len)


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

def _plan_ms(fn, y: torch.Tensor, iters: int) -> float:
    """ms of one call of ``fn``: on the card the median device time of
    ``iters`` calls queued behind a spin (ops/timing.py ``device_ms``); on
    the CPU the mean of ``iters`` calls by the host's clock."""
    if y.device.type == "cuda":
        from oryx_tpu_torch.ops.timing import device_ms

        return device_ms(torch, fn, reps=iters, warmup=1)[0]
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def autotune_blocks(xs, y, *, k: int, scales=None,
                    candidates=AUTOTUNE_BLOCK_I, iters: int = 5,
                    readings: list | None = None) -> tuple[int, int | None]:
    """Time the whole answer (``topk_dot_batch_cuda``'s partial kernel and
    merge) under each candidate split length and under the wave-filling
    plan, and lock the fastest into the block table under this matrix's
    key, so every later dispatch of the key with default blocks launches
    it. Returns the locked (rows, items); items None is the wave.
    Candidates round down as an explicit ``block_i`` does (those giving
    one plan are timed once); plans past the merge's or the partials'
    budget (``check_plan``) are skipped before any launch. A launch that
    fails raises: no candidate silently loses. On CPU tensors the plans
    run through the plain versions, timed by the host's clock.
    ``readings``, if given, gets one dict per plan: the request, its
    splits and length, and its ms or why it was skipped. Meant for bench
    and operator tooling -- never called on a request path."""
    b, n_items = xs.shape[0], y.shape[0]
    kb = _next_pow2(k)
    key = block_key(y.shape[1], y.element_size(), kb)
    tuned_blocks(y.shape[1], y.element_size(), kb)  # raises if too wide
    sm_count, per_sm = _occupancy(y, kb)
    plans = {plan_splits(b, n_items, sm_count, per_sm): None}
    for c in candidates:
        split_len = split_length(c, n_items)
        plans.setdefault((-(-n_items // split_len), split_len), c)
    best, best_ms = None, None
    for (n_splits, split_len), request in plans.items():
        line = {"block_i": request, "splits": n_splits,
                "split_len": split_len}
        try:
            check_plan(b, kb, n_splits, split_len)
        except ValueError as e:
            line["skipped"] = str(e)
        else:
            ms = _plan_ms(
                lambda: _answer(xs, y, k=k, scales=scales, n_splits=n_splits,
                                split_len=split_len), y, iters)
            line["ms"] = ms
            if best_ms is None or ms < best_ms:
                best, best_ms = (n_splits, split_len, request), ms
        if readings is not None:
            readings.append(line)
    if best is None:
        raise ValueError(f"no candidate plan fits for {b} rows at kb={kb}")
    _BLOCK_TABLE[key] = (ROWS_PER_BLOCK, None if best[2] is None else best[1])
    return _BLOCK_TABLE[key]
