"""The port's fused top-k (oryx_tpu_torch/ops/topk.py) against the JAX
package: every case of tests/test_pallas_topk.py, held against both
topk_dot_batch_xla and the Pallas kernel in interpret mode. Here on the CPU
the port runs its plain PyTorch versions; the CUDA kernels themselves are
held against those plain versions on the card (tests marked ``cuda``, and
chip_smoke.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops.als import topk_dot_batch_quant_xla, topk_dot_batch_xla
from oryx_tpu.ops.pallas_topk import (
    _merge_top,
    topk_dot_batch_pallas,
)
from oryx_tpu.ops.pallas_topk import quantize_queries as jax_quantize_queries
from oryx_tpu.ops.transfer import quantize_rows_int8
from oryx_tpu_torch.ops import topk as T
from oryx_tpu_torch.ops.als import topk_dot_batch


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _check(b, n_items, feats, k, block_b=8, block_i=256, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, feats)).astype(np.float32)
    y = rng.normal(size=(n_items, feats)).astype(np.float32)
    v, i = T.topk_dot_batch_cuda(_t(xs), _t(y), k=k)
    v_x, i_x = topk_dot_batch_xla(jnp.asarray(xs), jnp.asarray(y), k=k)
    v_p, i_p = topk_dot_batch_pallas(
        jnp.asarray(xs), jnp.asarray(y), k=k, block_b=block_b,
        block_i=block_i, interpret=True,
    )
    for v_ref, i_ref in ((v_x, i_x), (v_p, i_p)):
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-4)
        assert np.array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize(
    "b,n_items,feats,k,block_i",
    [
        (16, 1000, 50, 10, 256),   # basic
        (13, 777, 33, 5, 256),     # batch and items off every block grid
        (4, 300, 8, 1, 256),       # k = 1
        (4, 300, 8, 16, 256),
        (4, 300, 8, 32, 256),      # the batcher's default overfetch bucket
        (8, 100, 16, 10, 256),     # items fit one block
        (1, 900, 50, 10, 256),     # B = 1: an idle server's dispatch
        (6, 700, 20, 18, 256),     # k divides no bucket boundary
        (6, 700, 20, 97, 256),
    ],
)
def test_matches_jax_shapes(b, n_items, feats, k, block_i):
    _check(b, n_items, feats, k, block_i=block_i)


@pytest.mark.parametrize("trial", range(5))
def test_property_random_shapes_match_jax(trial):
    rng = np.random.default_rng(33)
    for _ in range(trial + 1):  # the trial-th draw of the JAX test's sweep
        b = int(rng.integers(1, 20))
        n_items = int(rng.integers(150, 2500))
        feats = int(rng.integers(4, 70))
        k = int(rng.integers(1, min(128, n_items) + 1))
        block_i = int(rng.choice([128, 256, 512]))
    _check(b, n_items, feats, k, block_i=block_i, seed=100 + trial)


def test_fewer_items_than_k_padding_is_neg_inf():
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(4, 16)).astype(np.float32)
    y = rng.normal(size=(6, 16)).astype(np.float32)
    v, i = T.topk_dot_batch_cuda(_t(xs), _t(y), k=10)
    v_p, i_p = topk_dot_batch_pallas(
        jnp.asarray(xs), jnp.asarray(y), k=10, block_b=8, block_i=256,
        interpret=True,
    )
    scores = xs.astype(np.float64) @ y.astype(np.float64).T
    order = np.argsort(-scores, axis=1)
    np.testing.assert_allclose(
        v.numpy()[:, :6], np.take_along_axis(scores, order, 1)[:, :6],
        atol=1e-4,
    )
    assert np.array_equal(i.numpy()[:, :6], order[:, :6])
    assert np.array_equal(i.numpy()[:, :6], np.asarray(i_p)[:, :6])
    assert np.all(np.isneginf(v.numpy()[:, 6:]))
    assert np.all(np.isneginf(np.asarray(v_p)[:, 6:]))
    assert np.all(i.numpy()[:, 6:] == -1)


def test_bfloat16_inputs():
    # the same bf16-cast inputs on both sides: products are exact in f32,
    # so only the summation order differs
    rng = np.random.default_rng(7)
    xs = jnp.asarray(rng.normal(size=(8, 50)), dtype=jnp.bfloat16)
    y = jnp.asarray(rng.normal(size=(512, 50)), dtype=jnp.bfloat16)
    xs_t = _t(np.asarray(xs, dtype=np.float32), torch.bfloat16)
    y_t = _t(np.asarray(y, dtype=np.float32), torch.bfloat16)
    v, i = T.topk_dot_batch_cuda(xs_t, y_t, k=4)
    v_x, i_x = topk_dot_batch_xla(xs, y, k=4)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_x), atol=1e-4)
    assert np.array_equal(i.numpy(), np.asarray(i_x))


def test_k_over_lane_limit_rejected():
    with pytest.raises(ValueError):
        T.topk_dot_batch_cuda(torch.zeros(4, 8), torch.zeros(300, 8), k=200)


def test_dispatcher_on_cpu_matches_xla():
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(4, 8)).astype(np.float32)
    y = rng.normal(size=(100, 8)).astype(np.float32)
    v, i = topk_dot_batch(_t(xs), _t(y), k=3)
    v_x, i_x = topk_dot_batch_xla(jnp.asarray(xs), jnp.asarray(y), k=3)
    assert np.array_equal(i.numpy(), np.asarray(i_x))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_x), atol=1e-4)


def test_duplicate_scores_stable_tie_break():
    rng = np.random.default_rng(21)
    base = rng.normal(size=(60, 16)).astype(np.float32)
    y = np.repeat(base, 5, axis=0)  # every score appears 5x
    xs = rng.normal(size=(7, 16)).astype(np.float32)
    v, i = T.topk_dot_batch_cuda(_t(xs), _t(y), k=25)
    v_x, i_x = topk_dot_batch_xla(jnp.asarray(xs), jnp.asarray(y), k=25)
    v_p, i_p = topk_dot_batch_pallas(
        jnp.asarray(xs), jnp.asarray(y), k=25, block_b=8, block_i=128,
        interpret=True,
    )
    assert np.array_equal(i.numpy(), np.asarray(i_x))
    assert np.array_equal(i.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_x), atol=1e-4)


@pytest.mark.parametrize("k", [12, 128])
def test_quantized_bit_exact_against_quant_xla(k):
    # int8 x int8 sums stay below 2^24, so both sides compute the same
    # integers; the scales multiply in the same order
    rng = np.random.default_rng(44)
    y = rng.normal(size=(1111, 30)).astype(np.float32)
    xs = rng.normal(size=(9, 30)).astype(np.float32)
    q, s = quantize_rows_int8(y)
    v, i = T.topk_dot_batch_cuda(
        _t(xs), torch.from_numpy(q), k=k, scales=torch.from_numpy(s)
    )
    v_x, i_x = topk_dot_batch_quant_xla(
        jnp.asarray(xs), jnp.asarray(q), jnp.asarray(s), k=k
    )
    assert np.array_equal(i.numpy(), np.asarray(i_x))
    assert np.array_equal(v.numpy(), np.asarray(v_x))
    v_p, i_p = topk_dot_batch_pallas(
        jnp.asarray(xs), jnp.asarray(q), scales=jnp.asarray(s), k=k,
        block_b=8, block_i=256, interpret=True,
    )
    assert np.array_equal(i.numpy(), np.asarray(i_p))


def test_quantize_queries_bit_exact():
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(33, 50)).astype(np.float32) * 3
    xs[4] = 0.0  # a zero row keeps scale 1
    xs[7, :] = 0.5 / 127.0 * np.arange(50)  # exact .5 steps: round half even
    q, sx = T.quantize_queries(_t(xs))
    # compiled, as the JAX package always runs it (inside its jitted
    # top-k forms): XLA turns the division by 127 into a reciprocal multiply
    q_j, sx_j = jax.jit(jax_quantize_queries)(jnp.asarray(xs))
    assert np.array_equal(q.numpy(), np.asarray(q_j))
    assert np.array_equal(sx.numpy(), np.asarray(sx_j))


@pytest.mark.parametrize("length", [1, 8, 128])
def test_merge_top_matches_jax(length):
    rng = np.random.default_rng(length)
    # values drawn from a small set so ties across the two lists are common
    def sorted_list(offset):
        v = rng.integers(0, 5, size=(3, length)).astype(np.float32)
        i = np.stack([rng.permutation(1000)[:length] + offset for _ in range(3)])
        order = np.lexsort((i, -v), axis=1)
        return (np.take_along_axis(v, order, 1),
                np.take_along_axis(i, order, 1).astype(np.int32))
    av, ai = sorted_list(0)
    bv, bi = sorted_list(1000)
    v, i = T.merge_top(_t(av), torch.from_numpy(ai), _t(bv), torch.from_numpy(bi))
    v_j, i_j = _merge_top(jnp.asarray(av), jnp.asarray(ai), jnp.asarray(bv),
                          jnp.asarray(bi))
    assert np.array_equal(v.numpy(), np.asarray(v_j))
    assert np.array_equal(i.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("b,n_items,k,sm_count", [
    (13, 777, 5, 132), (1, 5000, 10, 132), (70, 3000, 97, 2), (4, 6, 10, 132),
])
def test_split_then_merge_equals_whole(b, n_items, k, sm_count):
    # the two-kernel decomposition, run through the plain versions: per
    # split top-kb, then the merge, equals the whole-catalog top-k
    rng = np.random.default_rng(b)
    xs = _t(rng.normal(size=(b, 12)))
    y = _t(np.repeat(rng.normal(size=(-(-n_items // 3), 12)), 3, axis=0)[:n_items])
    kb = 1 << max(0, (k - 1).bit_length())
    rows, tile = T.block_geometry(torch.float32)
    n_splits, split_len = T.plan_splits(b, n_items, sm_count,
                                        rows_per_block=rows, tile_items=tile)
    assert split_len % tile == 0
    assert (n_splits - 1) * split_len < n_items <= n_splits * split_len
    pv, pi = T.topk_dot_partial(
        xs, y, kb=kb, n_splits=n_splits, split_len=split_len
    )
    assert pv.shape == (n_splits, b, kb)
    v, i = T.topk_merge(pv, pi, k=k)
    v_r, i_r = T.topk_dot_batch_reference(xs, y, k=k)
    assert torch.equal(i, i_r)
    assert torch.equal(v, v_r)


def test_plain_paths_count_no_launches():
    T.reset_launches()
    T.topk_dot_batch_cuda(torch.randn(3, 4), torch.randn(50, 4), k=5)
    assert T.LAUNCHES == {"topk_dot_partial": 0, "topk_merge": 0}


def test_kernel_probe_still_finds_every_phase(tmp_path):
    # the ablation probe builds csrc/topk_dot.cu with one ORYX_PROBE_NO_*
    # switch set at a time: each switch must exist in the kernel, and each
    # variant (or another source) must build into a library of its own
    from oryx_tpu_torch.ops import _build, topk_probe

    src = (_build.CSRC_DIR / _build.SOURCES["topk_dot"]).read_text()
    paths = {_build.library_path("topk_dot")}
    for macros in topk_probe.VARIANTS.values():
        for m in macros:
            name = m.split("=")[0]
            assert f"#ifndef {name}" in src
            assert src.count(name) >= 3  # its default and at least one use
        paths.add(_build.library_path("topk_dot", macros))
    other = tmp_path / "old.cu"
    other.write_text(src + "\n// another version\n")
    paths.add(_build.library_path("topk_dot", source=other))
    assert len(paths) == len(topk_probe.VARIANTS) + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("b", [1, 64, 512, 2047])
@pytest.mark.parametrize("per_sm", [1, 2, 4])
def test_split_plan_covers_the_catalog_in_one_wave(dtype, b, per_sm):
    # the partial kernel's block (64 rows and 64-item tiles, every type) and
    # the split plan over it:
    # whole tiles, at least four a split, covering the catalog once, and no
    # more blocks than one wave of per_sm resident blocks on 132 SMs
    rows, tile = T.block_geometry(dtype)
    assert (rows, tile) == (T.ROWS_PER_BLOCK, T.TILE_ITEMS) == (64, 64)
    n_splits, split_len = T.plan_splits(b, 1_000_000, 132, per_sm, rows, tile)
    assert split_len % tile == 0 and split_len >= 4 * tile
    assert (n_splits - 1) * split_len < 1_000_000 <= n_splits * split_len
    row_blocks = -(-b // rows)
    assert row_blocks * n_splits <= max(per_sm * 132, row_blocks)


def _stacked_lists(rng, s, b, length, pad_every=0):
    """[S, B, length] sorted (value desc, index asc) lists with heavy ties
    (values from 4 levels) and distinct indices across lists; with
    ``pad_every``, every such list keeps only a few real entries and ends in
    (-inf, -1) padding, as a split shorter than kb does."""
    v = rng.integers(0, 4, size=(s, b, length)).astype(np.float32)
    i = np.stack([rng.permutation(s * length).reshape(s, length)
                  for _ in range(b)], axis=1).astype(np.int32)
    order = np.lexsort((i, -v), axis=-1)
    v = np.take_along_axis(v, order, -1)
    i = np.take_along_axis(i, order, -1)
    if pad_every:
        for j in range(0, s, pad_every):
            keep = j % length
            v[j, :, keep:] = -np.inf
            i[j, :, keep:] = -1
    return v, i


@pytest.mark.parametrize("s", [1, 2, 3, 66, 521])
@pytest.mark.parametrize("k", [1, 10, 32, 128])
def test_merge_reference_matches_jax_merge_tree(s, k):
    # the merge kernel's plain version against the JAX package's merge tree
    # (pairwise _merge_top halvings over the stacked lists)
    from oryx_tpu.ops.shard_topk import _merge_stacked_jit

    rng = np.random.default_rng(1000 * s + k)
    kb = 1 << max(0, (k - 1).bit_length())
    v, i = _stacked_lists(rng, s, 3, kb, pad_every=3)
    mv, mi = T.topk_merge_reference(_t(v), torch.from_numpy(i), k=k)
    v_j, i_j = _merge_stacked_jit(jnp.asarray(v), jnp.asarray(i), k=k)
    assert np.array_equal(mv.numpy(), np.asarray(v_j))
    assert np.array_equal(mi.numpy(), np.asarray(i_j))


def test_f32_partial_reference_matches_jax_at_f250():
    # per split, the f32 partial's plain version against the JAX package's
    # reference for the kernel (topk_dot_batch_xla, the f32 product at
    # Precision.HIGHEST and lax.top_k) over that split's items, indices
    # rebased; the last split is shorter than kb and padded with (-inf, -1)
    from oryx_tpu.ops.als import topk_dot_batch_xla

    rng = np.random.default_rng(250)
    xs = rng.normal(size=(5, 250)).astype(np.float32)
    y = rng.normal(size=(520, 250)).astype(np.float32)
    kb, split_len = 16, 256
    pv, pi = T.topk_dot_partial_reference(_t(xs), _t(y), kb=kb, n_splits=3,
                                          split_len=split_len)
    assert pv.shape == (3, 5, kb)
    for s in range(3):
        lo, hi = s * split_len, min(520, (s + 1) * split_len)
        n = min(kb, hi - lo)
        v_x, i_x = topk_dot_batch_xla(jnp.asarray(xs), jnp.asarray(y[lo:hi]), k=n)
        np.testing.assert_allclose(pv[s, :, :n].numpy(), np.asarray(v_x),
                                   rtol=1e-5, atol=1e-4)
        assert np.array_equal(pi[s, :, :n].numpy(), np.asarray(i_x) + lo)
        assert np.all(np.isneginf(pv[s, :, n:].numpy()))
        assert np.all(pi[s, :, n:].numpy() == -1)


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("feats", [1, 16, 50, 250, 600])
def test_f32_tolerance_holds_f32_and_rejects_tf32(feats):
    # the plain f32 version and the JAX reference (Precision.HIGHEST) stay
    # within f32_tolerance of the float64 scores; the same top-k computed
    # from TF32-rounded inputs does not
    rng = np.random.default_rng(feats)
    xs = rng.normal(size=(16, feats)).astype(np.float32)
    y = rng.normal(size=(3000, feats)).astype(np.float32)
    exact = xs.astype(np.float64) @ y.astype(np.float64).T
    tol = T.f32_tolerance(feats)
    v, i = T.topk_dot_batch_reference(_t(xs), _t(y), k=32)
    rows = np.arange(16)[:, None]
    assert np.abs(v.numpy() - exact[rows, i.numpy()]).max() <= tol
    v_x, i_x = topk_dot_batch_xla(jnp.asarray(xs), jnp.asarray(y), k=32)
    assert np.abs(np.asarray(v_x) - exact[rows, np.asarray(i_x)]).max() <= tol
    v_t, i_t = T.topk_dot_batch_reference(_t(_tf32(xs)), _t(_tf32(y)), k=32)
    assert np.abs(v_t.numpy() - exact[rows, i_t.numpy()]).max() > tol
