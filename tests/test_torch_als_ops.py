"""The port's ALS fold-in and plain scoring forms (oryx_tpu_torch/ops/als.py)
against the JAX package's oryx_tpu/ops/als.py, on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import als as J
from oryx_tpu.ops.transfer import QuantizedMatrix as JQ
from oryx_tpu.ops.transfer import quantize_rows_int8
from oryx_tpu_torch.ops import als as P
from oryx_tpu_torch.ops.transfer import QuantizedMatrix


def _solver(rng, k, n=40):
    y = rng.standard_normal((n, k)).astype(np.float32)
    yty = y.T @ y + 0.1 * np.eye(k, dtype=np.float32)
    return np.linalg.cholesky(yty).astype(np.float32), y


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("implicit", [True, False])
def test_fold_in_batch_matches_jax(implicit):
    rng = np.random.default_rng(3 if implicit else 4)
    k, n = 10, 64
    chol, y = _solver(rng, k)
    xus = rng.standard_normal((n, k)).astype(np.float32) * 0.3
    xus[:5] = 0.0  # new users: current prediction counts as 0.5
    yis = y[rng.integers(0, len(y), size=n)]
    values = rng.choice([-2.0, -0.5, 0.5, 1.0, 3.0], size=n).astype(np.float32)
    # rows whose implicit target is NaN (no change needed) stay as they are
    xus[10] = yis[10] * (2.0 / float(yis[10] @ yis[10]))  # prediction 2 > 1
    values[10] = 1.0
    got = P.fold_in_batch(_t(chol), _t(values), _t(xus), _t(yis),
                          implicit=implicit)
    fn = J.fold_in_batch if implicit else J.fold_in_batch_explicit
    want = fn(jnp.asarray(chol), jnp.asarray(values), jnp.asarray(xus),
              jnp.asarray(yis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if implicit:
        assert np.array_equal(got.numpy()[10], xus[10])


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("value", [1.0, -1.0, 0.25])
def test_compute_updated_xu_matches_jax(implicit, value):
    rng = np.random.default_rng(11)
    k = 7
    chol, y = _solver(rng, k)
    xu = rng.standard_normal(k).astype(np.float32) * 0.2
    got = P.compute_updated_xu(_t(chol), value, _t(xu), _t(y[3]),
                               implicit=implicit)
    want = J.compute_updated_xu(jnp.asarray(chol), value, jnp.asarray(xu),
                                jnp.asarray(y[3]), implicit=implicit)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_compute_target_qui_matches_jax():
    values = np.array([2.0, 2.0, -1.0, -1.0, 0.5, -3.0], dtype=np.float32)
    current = np.array([0.2, 1.5, 0.7, -0.2, 0.5, 1.2], dtype=np.float32)
    got = P.compute_target_qui(_t(values), _t(current), implicit=True)
    want = J.compute_target_qui(jnp.asarray(values), jnp.asarray(current),
                                implicit=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               equal_nan=True)


def test_plain_scoring_forms_match_jax():
    rng = np.random.default_rng(21)
    y = rng.standard_normal((900, 20)).astype(np.float32)
    xs = rng.standard_normal((6, 20)).astype(np.float32)
    v, i = P.topk_dot_batch_xla(_t(xs), _t(y), k=40)
    v_j, i_j = J.topk_dot_batch_xla(jnp.asarray(xs), jnp.asarray(y), k=40)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)
    assert np.array_equal(i.numpy(), np.asarray(i_j))
    # approx computes exactly off the TPU, in both packages
    v, i = P.topk_dot_batch_approx(_t(xs), _t(y), k=10, recall=0.9)
    v_j, i_j = J.topk_dot_batch_approx(jnp.asarray(xs), jnp.asarray(y), k=10,
                                       recall=0.9)
    assert np.array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)
    q, s = quantize_rows_int8(y)
    v, i = P.topk_dot_batch_quant_xla(_t(xs), torch.from_numpy(q),
                                      torch.from_numpy(s), k=200)
    v_j, i_j = J.topk_dot_batch_quant_xla(jnp.asarray(xs), jnp.asarray(q),
                                          jnp.asarray(s), k=200)
    assert np.array_equal(v.numpy(), np.asarray(v_j))
    assert np.array_equal(i.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("k,recall", [(10, 1.0), (128, 1.0), (300, 1.0),
                                      (10, 0.95)])
def test_dispatcher_routes_match_jax(k, recall):
    # every route of topk_dot_batch: the fused kernel's wrapper (k <= 128),
    # the plain large product (k > 128) and approx, for the bf16 view and
    # the quantized view
    rng = np.random.default_rng(k)
    y = rng.standard_normal((700, 12)).astype(np.float32)
    xs = rng.standard_normal((5, 12)).astype(np.float32)
    yb = jnp.asarray(y, dtype=jnp.bfloat16)
    v, i = P.topk_dot_batch(_t(xs), _t(np.asarray(yb, np.float32)).bfloat16(),
                            k=k, recall=recall)
    v_j, i_j = J.topk_dot_batch(jnp.asarray(xs), yb, k=k, recall=recall)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)
    assert np.array_equal(i.numpy(), np.asarray(i_j))
    q, s = quantize_rows_int8(y)
    v, i = P.topk_dot_batch(
        _t(xs), QuantizedMatrix(torch.from_numpy(q), torch.from_numpy(s)),
        k=k, recall=recall,
    )
    v_j, i_j = J.topk_dot_batch(
        jnp.asarray(xs), JQ(jnp.asarray(q), jnp.asarray(s)), k=k,
        recall=recall,
    )
    assert np.array_equal(v.numpy(), np.asarray(v_j))
    assert np.array_equal(i.numpy(), np.asarray(i_j))


def test_pallas_max_k_stays_coupled_to_batcher_buckets():
    from oryx_tpu.serving.batcher import K_BUCKETS as J_BUCKETS
    from oryx_tpu_torch.serving.batcher import K_BUCKETS

    assert P.PALLAS_TOPK_MAX_K == J.PALLAS_TOPK_MAX_K == 128
    assert K_BUCKETS == J_BUCKETS
