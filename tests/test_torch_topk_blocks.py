"""The port's block table and autotune of the top-k kernel
(oryx_tpu_torch/ops/topk.py: ``tuned_blocks``, ``ORYX_TOPK_BLOCKS``, the
round-down rule of an explicit ``block_i`` and ``autotune_blocks``) against
the JAX package's (oryx_tpu/ops/pallas_topk.py's block tuning). Here on the
CPU explicit plans run through the partial and merge kernels' plain
versions; the kernels under every plan are held on the card by
tests/test_torch_cuda.py and chip_smoke.py's autotune phase."""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import pallas_topk as pt
from oryx_tpu.ops.pallas_topk import topk_dot_batch_pallas
from oryx_tpu.ops.transfer import quantize_rows_int8
from oryx_tpu_torch.ops import topk as T

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (stdlib imports only at module level)

TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int8": torch.int8}


@pytest.fixture(autouse=True)
def _fresh_table(monkeypatch):
    monkeypatch.setattr(T, "_BLOCK_TABLE", {})
    monkeypatch.delenv(T.BLOCKS_ENV, raising=False)


def _meta(n_items, features, dtype=torch.bfloat16):
    """An item matrix with a shape and a type and no storage: a plan needs
    no more of it."""
    return torch.empty((n_items, features), dtype=dtype, device="meta")


def _stub_occupancy(monkeypatch, per_sm, sm_count=132):
    monkeypatch.setattr(T, "_occupancy",
                        lambda y, kb, lib=None: (sm_count, per_sm))


def _jax_block_i(block_i, n_items):
    """The JAX entry point's rule (topk_dot_batch_pallas)."""
    return max(pt._LANE, min(pt._pow2_floor(block_i), pt._pow2_ceil(n_items)))


# ---- the table: the JAX package's contract on port objects ---------------


def test_tuned_block_table_and_env_override(monkeypatch):
    # the solver's entry: 64-row blocks and the wave of the launching card,
    # cached under the key of everything shared memory depends on
    assert T.tuned_blocks(50, 2, 32) == (T.ROWS_PER_BLOCK, None)
    assert T.block_key(50, 2, 32) in T._BLOCK_TABLE
    assert T.block_key(50, 2, 32) == (1, 2, 32)
    # int8 rows take half the bytes of bf16 ones: never more shared memory,
    # so never fewer resident blocks (the counterpart of the JAX test's
    # "int8 >= bf16" block_i)
    for f in (16, 50, 64, 65, 250, 600, 1024):
        for kb in (8, 32, 128):
            assert (T._working_set_bytes(f, 1, kb)
                    <= T._working_set_bytes(f, 2, kb))
    # the override wins for fresh entries, never for cached ones
    monkeypatch.setenv(T.BLOCKS_ENV, "64,1024")
    assert T.tuned_blocks(50, 2, 32) == (T.ROWS_PER_BLOCK, None)
    monkeypatch.setattr(T, "_BLOCK_TABLE", {})
    assert T.tuned_blocks(50, 2, 32) == (64, 1024)
    assert T.tuned_blocks(250, 2, 128) == (64, 1024)
    # its values round down: 100 rows give a 64-row block, 3000 items a
    # split of 2048
    monkeypatch.setattr(T, "_BLOCK_TABLE", {})
    monkeypatch.setenv(T.BLOCKS_ENV, "100,3000")
    assert T.tuned_blocks(50, 2, 32) == (100, 3000)
    assert T.launch_plan(512, _meta(1_000_000, 50), 32) == (489, 2048)


def test_key_tracks_shared_memory():
    # rows of one chunk share a key whatever their width; kb and the
    # item size each change it
    assert T.block_key(32, 2, 32) == T.block_key(64, 2, 32)
    assert T.block_key(65, 2, 32) != T.block_key(64, 2, 32)
    assert T.block_key(50, 1, 32) != T.block_key(50, 2, 32)
    assert T.block_key(50, 2, 64) != T.block_key(50, 2, 32)
    # the block of a 600-wide bf16 row at kb 128 (chip_smoke's wide-600)
    assert T._working_set_bytes(600, 2, 128) < T.MAX_SMEM
    # f32 streams its queries past ~450 features: a block never outgrows
    # shared memory
    assert T._working_set_bytes(60_000, 4, 128) < T.MAX_SMEM
    assert T._working_set_bytes(2000, 2, 128) > T.MAX_SMEM


def test_solver_refuses_rows_too_wide_for_a_block():
    with pytest.raises(ValueError, match="features"):
        T.tuned_blocks(2000, 2, 128)
    assert not T._BLOCK_TABLE


# ---- the round-down rule --------------------------------------------------


REQUESTS = (1, 64, 100, 128, 200, 255, 256, 257, 1000, 1024, 3000, 8191,
            8192, 100_000, 1 << 20)


@pytest.mark.parametrize(
    "n_items", [1, 6, 100, 128, 300, 777, 5000, 50_000, 1_000_000])
def test_round_down_rule_beside_jax(n_items):
    for block_i in REQUESTS:
        got = T.split_length(block_i, n_items)
        # the JAX rule, with the port's minimum of four tiles for one lane
        assert got == max(T.MIN_SPLIT, _jax_block_i(block_i, n_items))
        assert got & (got - 1) == 0
        assert got <= max(T.MIN_SPLIT, block_i)  # never more than asked
        plan = T.launch_plan(4, _meta(n_items, 16), 16, block_i=block_i)
        assert plan == (-(-n_items // got), got)


@pytest.mark.parametrize("value", [
    "abc", "64", "64,", ",1024", "64,1024,5", "0,1024", "64,0", "64,-3",
    "64;1024", "64.0,1024",
])
def test_malformed_override_raises(monkeypatch, value):
    monkeypatch.setenv(T.BLOCKS_ENV, value)
    with pytest.raises(ValueError, match=T.BLOCKS_ENV):
        T.tuned_blocks(50, 2, 32)
    with pytest.raises(ValueError, match=T.BLOCKS_ENV):
        T.topk_dot_batch_cuda(torch.zeros(2, 8), torch.zeros(300, 8), k=4,
                              block_i=256)


@pytest.mark.parametrize("block_b", [1, 8, 32, 63])
def test_block_b_below_64_raises(monkeypatch, block_b):
    with pytest.raises(ValueError, match="block_b"):
        T.launch_plan(8, _meta(1000, 16), 16, block_b=block_b, block_i=256)
    with pytest.raises(ValueError, match="block_b"):
        T.topk_dot_batch_cuda(torch.zeros(2, 8), torch.zeros(300, 8), k=4,
                              block_b=block_b)
    monkeypatch.setattr(T, "_BLOCK_TABLE", {})
    monkeypatch.setenv(T.BLOCKS_ENV, f"{block_b},1024")
    with pytest.raises(ValueError, match="block_b"):
        T.launch_plan(8, _meta(1000, 16), 16)


@pytest.mark.parametrize("block_b", [64, 65, 128, 4096])
def test_block_b_of_64_or_more_gives_64(monkeypatch, block_b):
    _stub_occupancy(monkeypatch, 4)
    y = _meta(1_000_000, 50)
    assert (T.launch_plan(512, y, 32, block_b=block_b)
            == T.plan_splits(512, 1_000_000, 132, 4))
    assert T.block_rows(block_b) == T.ROWS_PER_BLOCK


def test_plans_past_the_merge_or_partial_budget_raise():
    # 20M items in splits of 256: more lists than the merge takes
    with pytest.raises(ValueError, match="merge"):
        T.launch_plan(64, _meta(20_000_000, 128), 32, block_i=256)
    # 4096 rows x 3907 splits x 32 x 8 bytes: 4.1 GB of partial lists
    with pytest.raises(ValueError, match="budget"):
        T.launch_plan(4096, _meta(1_000_000, 50), 32, block_i=256)
    # one split is never refused, however many rows
    assert T.launch_plan(1 << 20, _meta(1_000_000, 50), 128,
                         block_i=1 << 20) == (1, 1 << 20)
    T.check_plan(1, 1, T.MAX_SPLITS, 256)
    with pytest.raises(ValueError, match="merge"):
        T.check_plan(1, 1, T.MAX_SPLITS + 1, 256)


# ---- the default plan: plan_splits' wave ---------------------------------


@pytest.mark.parametrize("per_sm", [1, 2, 4])
def test_default_launch_plan_is_plan_splits(monkeypatch, per_sm):
    """With an empty table and no override, every shape of chip_smoke.py's
    CASES in every type gets plan_splits' wave at the card's occupancy."""
    _stub_occupancy(monkeypatch, per_sm)
    for _, b, n, f, k, _ in chip_smoke.CASES:
        kb = T._next_pow2(k)
        for dtype in TYPES.values():
            got = T.launch_plan(b, _meta(n, f, dtype), kb)
            assert got == T.plan_splits(b, n, 132, per_sm, T.ROWS_PER_BLOCK,
                                        T.TILE_ITEMS), (b, n, f, k, dtype)
    assert all(v == (T.ROWS_PER_BLOCK, None) for v in T._BLOCK_TABLE.values())


def test_floor_probe_shapes_are_ones_a_floor_changes():
    from oryx_tpu_torch.ops import topk_probe

    for name, b, n, *_ in topk_probe.FLOOR_SHAPES:
        plans = {t: T.plan_splits(b, n, 132, 4, min_tiles=t)
                 for t in topk_probe.FLOOR_TILES}
        for t, (n_splits, split_len) in plans.items():
            assert split_len >= min(t, -(-n // 64)) * 64
            assert (n_splits - 1) * split_len < n <= n_splits * split_len
        changed = plans[4] != plans[16]
        assert changed == (name != "single-row"), name
    assert T.plan_splits(512, 50_000, 132, 4) == T.plan_splits(
        512, 50_000, 132, 4, min_tiles=4)


def test_wave_plan_needs_a_card():
    with pytest.raises(ValueError, match="occupancy"):
        T.launch_plan(8, torch.zeros(300, 8), 16)


# ---- explicit plans through the plain versions, beside the Pallas kernel -


def _inputs(type_name, b=9, n_items=1111, feats=30, seed=44):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n_items, feats)).astype(np.float32)
    xs = rng.normal(size=(b, feats)).astype(np.float32)
    if type_name == "int8":
        q, s = quantize_rows_int8(y)
        return ((jnp.asarray(xs), jnp.asarray(q), jnp.asarray(s)),
                (torch.from_numpy(xs), torch.from_numpy(q),
                 torch.from_numpy(s)))
    if type_name == "bfloat16":
        xs_j = jnp.asarray(xs, dtype=jnp.bfloat16)
        y_j = jnp.asarray(y, dtype=jnp.bfloat16)
        return ((xs_j, y_j, None),
                (torch.from_numpy(np.asarray(xs_j, dtype=np.float32)).to(
                    torch.bfloat16),
                 torch.from_numpy(np.asarray(y_j, dtype=np.float32)).to(
                     torch.bfloat16), None))
    return ((jnp.asarray(xs), jnp.asarray(y), None),
            (torch.from_numpy(xs), torch.from_numpy(y), None))


@pytest.mark.parametrize("type_name", list(TYPES))
@pytest.mark.parametrize("block_i", [256, 300, 512, 1000, 4096])
def test_explicit_block_i_matches_pallas_interpret(monkeypatch, type_name,
                                                   block_i):
    k = 12
    (xs_j, y_j, s_j), (xs_t, y_t, s_t) = _inputs(type_name)
    plans = []
    plain = T.topk_dot_partial_reference

    def spy(xs, y, **kw):
        plans.append((kw["n_splits"], kw["split_len"]))
        return plain(xs, y, **kw)

    monkeypatch.setattr(T, "topk_dot_partial_reference", spy)
    v, i = T.topk_dot_batch_cuda(xs_t, y_t, k=k, scales=s_t, block_i=block_i)
    length = T.split_length(block_i, y_t.shape[0])
    assert plans == [(-(-y_t.shape[0] // length), length)]
    v_p, i_p = topk_dot_batch_pallas(
        xs_j, y_j, k=k, scales=s_j, block_b=8, block_i=block_i,
        interpret=True)
    assert np.array_equal(i.numpy(), np.asarray(i_p))
    if type_name == "int8":
        # int8 x int8 sums are exact integers on both sides
        v_r, _ = T.topk_dot_batch_reference(xs_t, y_t, k=k, scales=s_t)
        assert np.array_equal(v.numpy(), v_r.numpy())
        np.testing.assert_allclose(v.numpy(), np.asarray(v_p), rtol=1e-6)
    else:
        np.testing.assert_allclose(v.numpy(), np.asarray(v_p), atol=1e-4)


def test_block_b_alone_on_cpu_is_the_reference():
    (_, _, _), (xs, y, _) = _inputs("float32")
    v, i = T.topk_dot_batch_cuda(xs, y, k=7, block_b=128)
    v_r, i_r = T.topk_dot_batch_reference(xs, y, k=7)
    assert torch.equal(v, v_r) and torch.equal(i, i_r)


# ---- autotune on CPU tensors with a swapped timer -------------------------


def _fake_timer(monkeypatch, ms_of_len, timed):
    def plan_ms(fn, y, iters):
        v, _ = fn()  # the plan runs, through the plain versions
        assert v.shape[1] == 12
        timed.append(len(timed))
        return ms_of_len(len(timed) - 1)

    monkeypatch.setattr(T, "_plan_ms", plan_ms)


def _spy_plans(monkeypatch):
    plans = []
    plain = T.topk_dot_partial_reference

    def spy(xs, y, **kw):
        plans.append(kw["split_len"])
        return plain(xs, y, **kw)

    monkeypatch.setattr(T, "topk_dot_partial_reference", spy)
    return plans


@pytest.mark.parametrize("fastest", [256, 512, 1024, None])
def test_autotune_locks_the_fastest(monkeypatch, fastest):
    _stub_occupancy(monkeypatch, 4)
    (_, _, _), (xs, y, s) = _inputs("int8", n_items=3000)
    plans = _spy_plans(monkeypatch)
    timed = []
    # the wave plan (first) is 300 items long at 9 rows: ms by plan order
    order = [None, 256, 512, 1024, 2048]
    _fake_timer(monkeypatch,
                lambda i: 1.0 if order[i] == fastest else 2.0 + i, timed)
    readings = []
    got = T.autotune_blocks(xs, y, k=12, scales=s,
                            candidates=(256, 300, 512, 1024, 2048),
                            readings=readings)
    assert got == (T.ROWS_PER_BLOCK, fastest)
    assert T._BLOCK_TABLE[T.block_key(30, 1, 16)] == got
    # 300 rounds down to 256: one plan, timed once
    assert [r["block_i"] for r in readings] == order
    assert [r["split_len"] for r in readings] == [
        T.plan_splits(9, 3000, 132, 4)[1], 256, 512, 1024, 2048]
    assert plans == [r["split_len"] for r in readings]
    assert all("ms" in r for r in readings)
    # later default dispatches of the key launch the winner
    if fastest is not None:
        assert T.launch_plan(9, y, 16)[1] == fastest


def test_autotune_skips_plans_past_the_budgets(monkeypatch):
    _stub_occupancy(monkeypatch, 4)
    (_, _, _), (xs, y, _) = _inputs("float32", n_items=3000)
    # the wave at 9 rows: 10 splits of 320 items; 9 rows x kb 16 x 8 bytes
    # = 1,152 bytes of lists a split
    assert T.plan_splits(9, 3000, 132, 4) == (10, 320)
    monkeypatch.setattr(T, "PARTIAL_BUDGET_BYTES", 6 * 1152)
    monkeypatch.setattr(T, "MAX_SPLITS", 11)
    plans = _spy_plans(monkeypatch)
    _fake_timer(monkeypatch, lambda i: 10.0 - i, [])
    readings = []
    got = T.autotune_blocks(xs, y, k=12, candidates=(256, 512, 1024, 2048),
                            readings=readings)
    why = {r["block_i"]: r.get("skipped", "") for r in readings}
    assert "budget" in why[None]   # 10 splits: 11,520 bytes
    assert "merge" in why[256]     # 12 splits
    assert why[512] == why[1024] == why[2048] == ""
    assert plans == [512, 1024, 2048]  # nothing skipped was launched
    assert got == (T.ROWS_PER_BLOCK, 2048)  # the last timed is fastest


def test_autotune_raises_where_a_candidate_raises(monkeypatch):
    _stub_occupancy(monkeypatch, 4)
    (_, _, _), (xs, y, _) = _inputs("bfloat16", n_items=3000)
    plain = T.topk_dot_partial_reference

    def failing(xs, y, **kw):
        if kw["split_len"] == 512:
            raise RuntimeError("topk_dot_partial launch failed: CUDA error 1")
        return plain(xs, y, **kw)

    monkeypatch.setattr(T, "topk_dot_partial_reference", failing)
    _fake_timer(monkeypatch, lambda i: 1.0, [])
    with pytest.raises(RuntimeError, match="launch failed"):
        T.autotune_blocks(xs, y, k=12, candidates=(256, 512, 1024))
    assert not any(v[1] for v in T._BLOCK_TABLE.values())


def test_autotune_with_no_plan_that_fits_raises(monkeypatch):
    _stub_occupancy(monkeypatch, 4)
    monkeypatch.setattr(T, "MAX_SPLITS", 0)
    (_, _, _), (xs, y, _) = _inputs("float32", n_items=3000)
    _fake_timer(monkeypatch, lambda i: 1.0, [])
    with pytest.raises(ValueError, match="no candidate"):
        T.autotune_blocks(xs, y, k=12, candidates=(256,))


def test_autotune_on_cpu_times_the_plain_versions(monkeypatch):
    """The real host-clock timer: every plan runs, and the locked entry is
    one of them."""
    _stub_occupancy(monkeypatch, 4)
    (_, _, _), (xs, y, _) = _inputs("float32", n_items=3000)
    readings = []
    got = T.autotune_blocks(xs, y, k=12, candidates=(256, 1024), iters=1,
                            readings=readings)
    assert all(r["ms"] > 0 for r in readings)
    assert got[1] in [r["block_i"] for r in readings]
