"""Sharded top-k of the port against the JAX package (tests/test_shard_topk.py's
contracts on port objects, on the CPU).

The port's sharded bf16 path is held bit-identical to the port's own
unsharded path (a row's score does not depend on the shard that holds it),
and to the JAX package's unsharded result within the bf16 contract: the
same bf16-cast inputs, values within 1e-4, the same indices. The int8
cases are exact against the JAX package, as its own sharded int8 cases are.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops.als import topk_dot_batch as jax_topk_dot_batch
from oryx_tpu.ops.transfer import (
    QuantizedMatrix as JaxQuantizedMatrix,
    staged_device_put as jax_staged_device_put,
)
from oryx_tpu_torch.ops.als import topk_dot_batch
from oryx_tpu_torch.ops.shard_topk import merge_topk_partials, topk_dot_batch_sharded
from oryx_tpu_torch.ops.transfer import (
    QuantizedMatrix,
    ShardedMatrix,
    quantize_rows_int8,
    scatter_rows,
    sharded_device_put,
    staged_device_put,
)

CPU = "cpu"


def _corpus(n_items=203, features=17, batch=5, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n_items, features)).astype(np.float32)
    xs = rng.normal(size=(batch, features)).astype(np.float32)
    return xs, y


def _bf16_pair(xs, y, n_shards, k):
    """(port unsharded, port sharded, JAX unsharded) answers of one bf16
    query block."""
    xt = torch.from_numpy(xs)
    full = staged_device_put(y, dtype=torch.bfloat16, device=CPU)
    sm = sharded_device_put(y, n_shards, dtype=torch.bfloat16, device=CPU)
    assert sm.shape == tuple(full.shape)
    jv, ji = jax_topk_dot_batch(
        jnp.asarray(xs), jax_staged_device_put(y, dtype=jnp.bfloat16), k=k
    )
    return topk_dot_batch(xt, full, k=k), topk_dot_batch(xt, sm, k=k), (
        np.asarray(jv), np.asarray(ji))


def _assert_bf16(xs, y, n_shards, k):
    (v0, i0), (v1, i1), (jv, ji) = _bf16_pair(xs, y, n_shards, k)
    assert torch.equal(i0, i1) and torch.equal(v0, v1)
    np.testing.assert_allclose(v1.numpy(), jv, atol=1e-4)
    np.testing.assert_array_equal(i1.numpy(), ji)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_topk_bit_identical_bf16(n_shards):
    xs, y = _corpus()
    _assert_bf16(xs, y, n_shards, 10)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_topk_bit_identical_quantized(n_shards):
    xs, y = _corpus(seed=11)
    q, s = quantize_rows_int8(y)
    sharded = sharded_device_put(y, n_shards, quantize=True, device=CPU)
    # per-row scales are row-local: shard-local quantization is
    # bit-identical to quantize-then-slice
    np.testing.assert_array_equal(
        np.concatenate([sh.q.numpy() for sh in sharded.shards]), q
    )
    full = QuantizedMatrix(torch.from_numpy(q), torch.from_numpy(s))
    v0, i0 = topk_dot_batch(torch.from_numpy(xs), full, k=10)
    v1, i1 = topk_dot_batch(torch.from_numpy(xs), sharded, k=10)
    assert torch.equal(i0, i1) and torch.equal(v0, v1)
    jv, ji = jax_topk_dot_batch(
        jnp.asarray(xs), JaxQuantizedMatrix(jnp.asarray(q), jnp.asarray(s)), k=10
    )
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v1.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_topk_duplicate_score_tie_break(n_shards):
    # duplicate rows straddling shard boundaries: every duplicate scores
    # identically, and the winner is the LOWER global index
    rng = np.random.default_rng(7)
    base = rng.normal(size=(40, 8)).astype(np.float32)
    y = np.concatenate([base, base, base])
    xs = rng.normal(size=(4, 8)).astype(np.float32)
    _assert_bf16(xs, y, n_shards, 12)


def test_sharded_topk_uneven_rows_and_wide_k():
    # 7 rows over 4 shards (sizes 2,2,2,1) with k wider than any shard
    xs, y = _corpus(n_items=7, features=5, batch=3, seed=23)
    _assert_bf16(xs, y, 4, 7)
    y_sharded = sharded_device_put(y, 4, dtype=torch.bfloat16, device=CPU)
    with pytest.raises(ValueError):
        topk_dot_batch_sharded(torch.from_numpy(xs), y_sharded, k=8)


def test_sharded_placement_uses_distinct_devices():
    """Shards go to the placement devices in order (cycled), and a delta
    scatter and the unit-view map keep every shard on its device."""
    from oryx_tpu_torch.parallel.shardspec import shard_devices

    _, y = _corpus(n_items=64)
    devs = shard_devices(4, [CPU, CPU])
    sm = sharded_device_put(y, 4, dtype=torch.bfloat16, devices=[CPU, CPU])
    assert [sh.device for sh in sm.shards] == devs
    after = scatter_rows(
        sm, np.array([17], dtype=np.int64),
        np.ones((1, y.shape[1]), dtype=np.float32),
    )
    assert [sh.device for sh in after.shards] == devs
    unit = sm.map(lambda s: (s.float() / 2).to(s.dtype))
    assert [sh.device for sh in unit.shards] == devs
    smq = sharded_device_put(y, 4, quantize=True, devices=[CPU])
    afterq = scatter_rows(
        smq, np.array([33], dtype=np.int64),
        np.ones((1, y.shape[1]), dtype=np.float32),
    )
    assert [sh.device for sh in afterq.shards] == [torch.device(CPU)] * 4
    # the full view reassembles exactly
    np.testing.assert_array_equal(
        torch.cat([sh.float() for sh in sm.shards]).numpy(),
        staged_device_put(y, dtype=torch.bfloat16, device=CPU).float().numpy(),
    )


def test_merge_topk_partials_direct():
    # hand-built partials with ties across shards and uneven widths
    v_a = np.array([[3.0, 1.0]], dtype=np.float32)
    i_a = np.array([[4, 9]], dtype=np.int32)
    v_b = np.array([[3.0, 2.0, 0.5]], dtype=np.float32)
    i_b = np.array([[2, 11, 20]], dtype=np.int32)
    v, i = merge_topk_partials([(v_a, i_a), (v_b, i_b)], k=4)
    np.testing.assert_array_equal(i.numpy(), [[2, 4, 11, 9]])
    np.testing.assert_array_equal(v.numpy(), [[3.0, 3.0, 2.0, 1.0]])
    with pytest.raises(ValueError):
        merge_topk_partials([], k=2)


def test_merge_topk_partials_matches_jax():
    """Random sorted lists of several widths: the port's merge and the JAX
    package's merge tree give the same (value, index) pairs."""
    from oryx_tpu.ops.shard_topk import merge_topk_partials as jax_merge

    rng = np.random.default_rng(12)
    parts = []
    for s, width in enumerate((3, 8, 5)):
        v = np.round(rng.normal(size=(6, width)), 1).astype(np.float32)
        i = rng.permutation(1000)[: 6 * width].reshape(6, width).astype(np.int32)
        o = np.lexsort((i, -v), axis=1)
        parts.append((np.take_along_axis(v, o, 1), np.take_along_axis(i, o, 1)))
    v, i = merge_topk_partials(parts, k=6)
    jv, ji = jax_merge(parts, 6)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_sharded_scatter_touches_owning_shard_only():
    _, y = _corpus(n_items=20, features=6)
    sm = sharded_device_put(y, 4, dtype=torch.bfloat16, device=CPU)
    old_shards = list(sm.shards)
    rows = np.array([6, 8], dtype=np.int64)  # both owned by shard 1
    new_rows = np.full((2, 6), 2.5, dtype=np.float32)
    out = scatter_rows(sm, rows, new_rows)
    assert isinstance(out, ShardedMatrix)
    # untouched shards are the SAME buffers, not copies
    assert out.shards[0] is old_shards[0]
    assert out.shards[2] is old_shards[2]
    assert out.shards[3] is old_shards[3]
    assert out.shards[1] is not old_shards[1]
    got = out.shards[1].float().numpy()
    np.testing.assert_allclose(got[[1, 3]], new_rows, rtol=0.01)
    # empty delta: the view object rides through unchanged
    same = scatter_rows(out, np.array([], dtype=np.int64), np.zeros((0, 6)))
    assert same is out


def test_sharded_scatter_growth_joins_the_last_shard():
    """The port's views hold live rows: appended rows join the last shard,
    and no row changes owner."""
    _, y = _corpus(n_items=20, features=6)
    sm = sharded_device_put(y, 4, dtype=torch.bfloat16, device=CPU)
    fresh = np.full((2, 6), 4.0, dtype=np.float32)
    out = scatter_rows(sm, np.array([20, 21]), fresh, n_rows=22)
    assert out.plan.bounds == (0, 5, 10, 15, 22)
    assert all(out.shards[s] is sm.shards[s] for s in range(3))
    np.testing.assert_array_equal(out.shards[3][5:].float().numpy(), fresh)


def test_sharded_scatter_quantized_requantizes_locally():
    _, y = _corpus(n_items=12, features=4)
    sm = sharded_device_put(y, 3, quantize=True, device=CPU)
    old = list(sm.shards)
    rows = np.array([5], dtype=np.int64)  # shard 1, local row 1
    fresh = np.array([[9.0, -3.0, 0.5, 1.0]], dtype=np.float32)
    out = scatter_rows(sm, rows, fresh)
    assert out.shards[0] is old[0] and out.shards[2] is old[2]
    q_exp, s_exp = quantize_rows_int8(fresh)
    np.testing.assert_array_equal(out.shards[1].q.numpy()[1], q_exp[0])
    np.testing.assert_allclose(out.shards[1].scale.numpy()[1], s_exp[0], rtol=1e-6)
    # the other rows of the touched shard kept their int8 bits exactly
    np.testing.assert_array_equal(
        out.shards[1].q.numpy()[[0, 2, 3]], old[1].q.numpy()[[0, 2, 3]]
    )


def _interactions(pkg, seed, n, nu, ni):
    rng = np.random.default_rng(seed)
    return pkg.aggregate_interactions(
        rng.integers(0, nu, n).astype(str),
        rng.integers(0, ni, n).astype(str),
        (rng.random(n) * 2 + 0.2).astype(np.float32),
        implicit=True,
    )


def test_bucketed_train_under_sharded_factors():
    """The bucketed trainer with the item-factor table row-sharded over a
    model-axis CPU mesh lands on the JAX package's row-sharded model from
    the same Y (summation order only differs), and the warm-start loop
    threads the shard mesh through."""
    from oryx_tpu.ops import als as J
    from oryx_tpu.parallel.mesh import model_mesh as jax_model_mesh
    from oryx_tpu_torch.ops import als as T
    from oryx_tpu_torch.parallel.mesh import host_mesh, model_mesh

    dj, dt = _interactions(J, 13, 800, 50, 30), _interactions(T, 13, 800, 50, 30)
    y0 = np.random.default_rng(4).normal(size=(dj.n_items, 6)).astype(np.float32)
    for n in (2, 4):
        want = J.train_als(dj, features=6, iterations=4, resume_y=y0,
                           shard_mesh=jax_model_mesh(n))
        got = T.train_als(dt, features=6, iterations=4, resume_y=y0,
                          shard_mesh=model_mesh(n, CPU))
        np.testing.assert_allclose(got.x, want.x, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(got.y, want.y, rtol=2e-3, atol=2e-4)
    warm, sweeps = T.train_als_warm(
        dt, features=6, iterations=8, resume_y=y0, tol=0.05,
        min_iterations=2, check_every=2, shard_mesh=model_mesh(2, CPU),
    )
    assert warm.y.shape == want.y.shape
    assert 2 <= sweeps <= 8
    with pytest.raises(ValueError):
        T.train_als(dt, features=6, iterations=1, resume_y=y0,
                    mesh=host_mesh(2, CPU), shard_mesh=model_mesh(2, CPU))


def test_checkpointed_train_threads_shard_mesh(tmp_path):
    from oryx_tpu_torch.ops import als as T
    from oryx_tpu_torch.parallel.mesh import model_mesh

    dt = _interactions(T, 21, 400, 30, 20)
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    ref = T.train_als(dt, features=4, iterations=4, seed_key=gen(), device=CPU)
    ck = T.train_als_checkpointed(
        dt, tmp_path / "ck", 2, features=4, iterations=4, seed_key=gen(),
        shard_mesh=model_mesh(2, CPU),
    )
    np.testing.assert_allclose(ck.x, ref.x, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ck.y, ref.y, rtol=2e-3, atol=2e-4)


def test_sharded_matrix_through_the_batcher():
    """The shared TopKBatcher scores a ShardedMatrix view exactly like a
    plain device matrix: the serving integration point."""
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    xs, y = _corpus(n_items=96, features=8, batch=1)
    sm = sharded_device_put(y, 2, dtype=torch.bfloat16, device=CPU)
    b = TopKBatcher()
    try:
        vals, idx = b.submit(xs[0], 5, sm)
        v0, i0 = topk_dot_batch(
            torch.from_numpy(xs[:1]),
            staged_device_put(y, dtype=torch.bfloat16, device=CPU), k=5,
        )
        np.testing.assert_array_equal(np.asarray(idx), i0.numpy()[0])
        np.testing.assert_array_equal(np.asarray(vals), v0.numpy()[0])
    finally:
        b.close()
