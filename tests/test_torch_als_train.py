"""ALS training in the port against the JAX package on the same numpy
inputs, on the CPU (``device="cpu"``).

Tolerances, each with its reason:
- ``gram``, ``batched_spd_solve``, ``make_solver``: f32 at rtol 1e-5 (one
  factorization and two triangular solves, summed in another order);
- the host preparation (aggregation, aggregate state, padded and bucketed
  lists): bit-identical, since it is the same numpy code;
- ``_half_step``: f32 at rtol 1e-4, atol 1e-5; bf16 at rtol 2e-3 (the same
  bf16 products, f32 sums in another order, through one solve);
- ``train_als`` at 300 x 200 x 5,000, K=8, three sweeps from the same Y:
  factors at rtol 1e-3 in f32, predictions on the observed pairs within
  1e-3 (three sweeps of the f32 half-step).
The random streams differ (jax.random against torch.Generator), so every
comparison of trained factors hands both packages the same ``resume_y``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oryx_tpu.ops.als as J
import oryx_tpu_torch.ops.als as T
from oryx_tpu.ops import solver as J_solver
from oryx_tpu.ops import vector as J_vector
from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.ops import solver as T_solver
from oryx_tpu_torch.ops import vector as T_vector

_DAY = 86_400_000


def _spd(rng, n, k):
    a = rng.standard_normal((n, k, k)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + k * np.eye(k, dtype=np.float32)).astype(np.float32)


# ---- vector and solver ------------------------------------------------------

def test_gram_matches():
    x = np.random.default_rng(0).standard_normal((500, 12)).astype(np.float32)
    got = T_vector.gram(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(J_vector.gram(jnp.asarray(x))), rtol=1e-5, atol=1e-4)
    # bf16 inputs go up to f32 first in both
    xb = torch.from_numpy(x).bfloat16()
    got = T_vector.gram(xb).numpy()
    want = np.asarray(J_vector.gram(jnp.asarray(x).astype(jnp.bfloat16)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_batched_spd_solve_matches():
    rng = np.random.default_rng(1)
    a, b = _spd(rng, 32, 9), rng.standard_normal((32, 9)).astype(np.float32)
    got = T_solver.batched_spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(J_solver.batched_spd_solve(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("packed", [False, True])
def test_make_solver_matches(packed):
    rng = np.random.default_rng(2)
    a = _spd(rng, 1, 6)[0]
    arg = a[np.tril_indices(6)] if packed else a
    b = rng.standard_normal((5, 6)).astype(np.float32)
    got = T_solver.make_solver(arg, device="cpu")
    want = J_solver.make_solver(arg)
    np.testing.assert_allclose(got.solve_f(b), want.solve_f(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.solve_f(b[0]), want.solve_f(b[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.chol.numpy(), np.asarray(want.chol), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["indefinite", "ill-conditioned", "packed-size"])
def test_make_solver_rejects_what_the_jax_solver_rejects(bad):
    mat = {
        "indefinite": np.array([[1.0, 2.0], [2.0, 1.0]], np.float32),
        "ill-conditioned": np.diag([1.0, 1e-12]).astype(np.float32),
        "packed-size": np.ones(4, np.float32),
    }[bad]
    errors = (T_solver.SingularMatrixError, ValueError)
    with pytest.raises(errors):
        T_solver.make_solver(mat, device="cpu")
    with pytest.raises((J_solver.SingularMatrixError, ValueError)):
        J_solver.make_solver(mat)


def test_solvers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T_solver.make_solver(np.eye(3, dtype=np.float32))


# ---- host preparation: bit-identical ----------------------------------------

def _raw_events(seed, n=3000, users=80, items=50, deletes=True):
    r = np.random.default_rng(seed)
    u = np.array([f"u{j}" for j in r.integers(0, users, n)])
    i = np.array([f"i{j}" for j in r.integers(0, items, n)])
    v = r.choice([0.25, 0.5, 1.0, 2.0, -1.0], n)
    if deletes:
        v[r.random(n) < 0.02] = np.nan
    ts = r.integers(0, 10 * _DAY, n)
    return u, i, v, ts


def _same_data(a, b):
    assert a.user_ids == b.user_ids and a.item_ids == b.item_ids
    for name in ("users", "items", "values"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), name


@pytest.mark.parametrize("kw", [
    dict(implicit=True),
    dict(implicit=False),
    dict(implicit=True, decay_factor=0.5, now_ms=12 * _DAY, zero_threshold=0.3),
    dict(implicit=False, decay_factor=0.5, now_ms=12 * _DAY),
    dict(implicit=True, log_strength=True, epsilon=0.5),
])
def test_aggregate_interactions_bit_identical(kw):
    u, i, v, ts = _raw_events(3)
    _same_data(T.aggregate_interactions(u, i, v, ts, **kw),
               J.aggregate_interactions(u, i, v, ts, **kw))


def test_aggregate_interactions_integer_ids_bit_identical():
    r = np.random.default_rng(4)
    u, i = r.integers(0, 10_000, 5000), r.integers(0, 300, 5000)
    v = r.random(5000)
    _same_data(T.aggregate_interactions(u, i, v), J.aggregate_interactions(u, i, v))
    _same_data(T.aggregate_interactions(u.astype(str), i.astype(str), v),
               J.aggregate_interactions(u.astype(str), i.astype(str), v))


@pytest.mark.parametrize("implicit,with_days", [(True, False), (True, True), (False, False)])
def test_aggregate_state_merge_materialize_bit_identical(implicit, with_days):
    states = []
    for pkg in (T, J):
        st = pkg.AggregateState.empty(implicit=implicit, with_days=with_days)
        for seed in range(4):
            u, i, v, ts = _raw_events(10 + seed, n=700)
            st = st.merge(pkg.AggregateState.from_window(
                u, i, v, ts, implicit=implicit, with_days=with_days))
        states.append(st)
    a, b = states
    assert a.fingerprint == b.fingerprint
    arrays_a, arrays_b = a.to_arrays(), b.to_arrays()
    for key in arrays_b:
        x, y = arrays_a[key], arrays_b[key]
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), key
    kw = dict(decay_factor=0.5, now_ms=12 * _DAY, zero_threshold=0.1, log_strength=True)
    _same_data(a.materialize(**kw), b.materialize(**kw))
    rt = T.AggregateState.from_arrays(arrays_a)
    _same_data(rt.materialize(**kw), b.materialize(**kw))


def test_padded_and_bucketed_lists_bit_identical():
    r = np.random.default_rng(5)
    n_e, n_o, nnz = 700, 300, 20_000
    e = (r.zipf(1.3, nnz) % n_e).astype(np.int32)
    o = r.integers(0, n_o, nnz).astype(np.int32)
    v = r.random(nnz).astype(np.float32)
    for got, want in zip(T.build_padded_lists(e, o, v, n_e, cap=64),
                         J.build_padded_lists(e, o, v, n_e, cap=64)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    kw = dict(cap=256, min_rows=64, block=128, unit=128)
    (tb, tblk), (jb, jblk) = (pkg.build_bucketed_lists(e, o, v, n_e, **kw) for pkg in (T, J))
    assert tblk == jblk and len(tb) == len(jb) > 1
    for got, want in zip(tb, jb):
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_upload_cuts_the_padding_rows():
    r = np.random.default_rng(6)
    e = r.integers(0, 100, 2000).astype(np.int32)
    o = r.integers(0, 40, 2000).astype(np.int32)
    buckets, _ = T.build_bucketed_lists(e, o, np.ones(2000, np.float32), 100,
                                        min_rows=8, block=64, unit=64)
    up = T._upload_buckets(buckets, 100, "cpu")
    for (rows, idx, _, _), (rows_d, idx_d, _, _) in zip(buckets, up):
        live = rows < 100
        assert not live[live.sum():].any()  # real rows come first
        assert np.array_equal(rows_d.numpy(), rows[live])
        assert np.array_equal(idx_d.numpy(), idx[live])


# ---- the half-step ----------------------------------------------------------

def _half_step_inputs(n=128, p=32, k=8, m=60, seed=7, singular_row=None):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    idx = rng.integers(0, m, (n, p)).astype(np.int32)
    mask = (rng.random((n, p)) < 0.7).astype(np.float32)
    val = (rng.integers(1, 5, (n, p)) * mask).astype(np.float32)
    if singular_row is not None:
        # explicit: no interaction at all and lam = 0 leaves A = 0
        mask[singular_row] = 0.0
        val[singular_row] = 0.0
    return f, idx, val, mask


def _both_half_steps(f, idx, val, mask, lam, implicit, dtype, block=32):
    g = f.T @ f
    want = np.asarray(J._half_step(
        jnp.asarray(f), jnp.asarray(g), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(mask), lam, 1.0, implicit, block, compute_dtype=jnp.dtype(dtype)))
    got = T._half_step(
        torch.from_numpy(f), torch.from_numpy(g), torch.from_numpy(idx),
        torch.from_numpy(val), torch.from_numpy(mask), lam, 1.0, implicit, block,
        compute_dtype=dtype)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-5), ("bfloat16", 2e-3, 1e-4)])
def test_half_step_matches(implicit, dtype, rtol, atol):
    got, want = _both_half_steps(*_half_step_inputs(), 0.01, implicit, dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_half_step_zeroes_a_singular_row_in_both(dtype):
    f, idx, val, mask = _half_step_inputs(singular_row=9)
    got, want = _both_half_steps(f, idx, val, mask, 0.0, False, dtype)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert not got[9].any() and not want[9].any()
    keep = np.arange(len(got)) != 9
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-3, atol=1e-4)


def test_half_step_solves_rows_f32_cannot_factor_in_f64():
    """Two nearly collinear factor columns at scale 1e4 put lam = 0.01
    below what an f32 gram resolves, so some rows' f32 Cholesky fails.
    Those rows come out as the f64 solution of the same normal equations
    (numpy, float64; rtol 1e-3 of the row's largest entry), where the JAX
    package jitters them (2% of the mean diagonal) and lands far off."""
    rng = np.random.default_rng(5)
    m, k, n, p = 400, 4, 16, 12
    base = rng.standard_normal(m) * 1e4
    f = np.stack([base, base + rng.standard_normal(m) * 1e-2,
                  rng.standard_normal(m), rng.standard_normal(m)], 1).astype(np.float32)
    idx = rng.integers(0, m, (n, p)).astype(np.int32)
    mask = np.ones((n, p), np.float32)
    val = rng.integers(1, 5, (n, p)).astype(np.float32)
    g = f.T @ f
    a, b = T._normal_equations(*(torch.from_numpy(v) for v in (f, g, idx, val, mask)),
                               0.01, 1.0, True)
    failed = ~T.batched_spd_solve_ex(a, b)[1].numpy()
    assert 0 < failed.sum() < n
    got, jax_jittered = _both_half_steps(f, idx, val, mask, 0.01, True, "float32", block=8)
    f64 = f.astype(np.float64)
    for r in np.nonzero(failed)[0]:
        yu, w = f64[idx[r]], val[r].astype(np.float64)
        want = np.linalg.solve(f64.T @ f64 + yu.T @ (w[:, None] * yu) + 0.01 * np.eye(k),
                               yu.T @ (1.0 + w))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[r], want, rtol=0, atol=1e-3 * scale)
        assert np.abs(jax_jittered[r] - want).max() > 0.1 * scale


def test_cholesky_ex_failure_is_read_from_info():
    """torch reports a failed factorization through info and leaves a
    finite partial factor; the guard must not read finiteness alone."""
    a = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 2.0]]])
    chol, info = torch.linalg.cholesky_ex(a)
    assert torch.isfinite(chol).all() and info.tolist()[0] != 0
    x, ok = T_solver.batched_spd_solve_ex(a, torch.ones(2, 2))
    assert ok.tolist() == [False, True]


# ---- trainers ---------------------------------------------------------------

def _train_data(seed=8):
    r = np.random.default_rng(seed)
    u, i = r.integers(0, 300, 5000), r.integers(0, 200, 5000)
    v = r.integers(1, 5, 5000).astype(float)
    return (T.aggregate_interactions(u.astype(str), i.astype(str), v),
            J.aggregate_interactions(u.astype(str), i.astype(str), v), r)


@pytest.mark.parametrize("implicit", [True, False])
def test_train_als_matches(implicit):
    dt, dj, r = _train_data()
    y0 = (r.standard_normal((dj.n_items, 8)) * 0.1 + 1 / np.sqrt(8)).astype(np.float32)
    kw = dict(features=8, lam=0.01, alpha=1.0, iterations=3, implicit=implicit, resume_y=y0)
    timings = {}
    got = T.train_als(dt, device="cpu", timings=timings, **kw)
    want = J.train_als(dj, **kw)
    assert got.user_ids == want.user_ids and got.item_ids == want.item_ids
    np.testing.assert_allclose(got.x, want.x, rtol=1e-3, atol=1e-3 * np.abs(want.x).max())
    np.testing.assert_allclose(got.y, want.y, rtol=1e-3, atol=1e-3 * np.abs(want.y).max())
    pg = (got.x[dt.users] * got.y[dt.items]).sum(1)
    pw = (want.x[dj.users] * want.y[dj.items]).sum(1)
    assert np.abs(pg - pw).max() <= 1e-3
    assert timings["compile_s"] == 0.0 and timings["train_s"] > 0
    assert timings["train_flops"] > 0 and timings["lists_s"] > 0


def test_train_als_bf16_learns_like_the_jax_package():
    dt, dj, r = _train_data(9)
    y0 = (r.standard_normal((dj.n_items, 8)) * 0.1 + 1 / np.sqrt(8)).astype(np.float32)
    kw = dict(features=8, lam=0.01, iterations=3, resume_y=y0, compute_dtype="bfloat16")
    got = T.train_als(dt, device="cpu", **kw)
    want = J.train_als(dj, **kw)
    pg = (got.x[dt.users] * got.y[dt.items]).sum(1)
    pw = (want.x[dj.users] * want.y[dj.items]).sum(1)
    assert np.abs(pg - pw).max() <= 0.05 * np.abs(pw).max()


def test_singular_systems_never_nan():
    """Mirror of the JAX package's test: rank-1 explicit systems at lam=0."""
    rng = np.random.default_rng(11)
    users = np.arange(40, dtype=np.int64)
    items = rng.integers(0, 30, size=40).astype(np.int64)
    data = T.aggregate_interactions(users, items, rng.uniform(1, 5, size=40), implicit=False)
    m = T.train_als(data, features=8, lam=0.0, iterations=4, implicit=False, device="cpu")
    assert np.isfinite(m.x).all() and np.isfinite(m.y).all()
    assert np.isfinite(m.x @ m.y.T).all()


def test_train_als_seeded_init_is_deterministic():
    dt, _, _ = _train_data(10)
    a = T.train_als(dt, features=4, iterations=1, device="cpu",
                    seed_key=torch.Generator().manual_seed(3))
    b = T.train_als(dt, features=4, iterations=1, device="cpu",
                    seed_key=torch.Generator().manual_seed(3))
    assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)


@pytest.mark.parametrize("arg", ["mesh", "shard_mesh"])
def test_multi_device_training_is_not_ported(arg):
    """(Named when both arguments raised.) A two-cell CPU mesh trains the
    single-device model from the same Y, within the reordered sums of
    f32; combining the two arguments raises."""
    from oryx_tpu_torch.parallel.mesh import host_mesh, model_mesh

    dt, _, _ = _train_data()
    y0 = np.random.default_rng(4).normal(size=(dt.n_items, 4)).astype(np.float32)
    kw = dict(features=4, iterations=3, resume_y=y0)
    one = T.train_als(dt, device="cpu", **kw)
    mesh = host_mesh(2, "cpu") if arg == "mesh" else model_mesh(2, "cpu")
    two = T.train_als(dt, **{arg: mesh}, **kw)
    np.testing.assert_allclose(two.x, one.x, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(two.y, one.y, rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        T.train_als(dt, mesh=host_mesh(2, "cpu"),
                    shard_mesh=model_mesh(2, "cpu"), **kw)


def test_train_als_defaults_to_the_card(monkeypatch):
    dt, _, _ = _train_data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.train_als(dt, features=4, iterations=1)


def test_empty_data_raises():
    with pytest.raises(ValueError, match="empty"):
        T.train_als(T.aggregate_interactions([], [], []), device="cpu")


def test_checkpointed_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A build killed after its first chunk resumes from the checkpoint and
    ends EXACTLY where the uninterrupted build ends."""
    dt, _, _ = _train_data(12)
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    kw = dict(features=8, iterations=6, device="cpu")
    base = T.train_als(dt, seed_key=gen(), **kw)
    real, calls = T.train_als, []

    def killed_after_first_chunk(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("killed")
        return real(*a, **k)

    ck = tmp_path / "ck"
    monkeypatch.setattr(T, "train_als", killed_after_first_chunk)
    with pytest.raises(KeyboardInterrupt):
        T.train_als_checkpointed(dt, ck, checkpoint_every=2, seed_key=gen(), **kw)
    monkeypatch.setattr(T, "train_als", real)
    assert (ck / "als-train.ckpt.npz").exists()
    with np.load(ck / "als-train.ckpt.npz") as z:
        assert int(z["done"]) == 2
    resumed = T.train_als_checkpointed(dt, ck, checkpoint_every=2, seed_key=gen(), **kw)
    assert np.array_equal(resumed.x, base.x) and np.array_equal(resumed.y, base.y)
    assert not (ck / "als-train.ckpt.npz").exists()  # removed on success


def test_checkpointed_ignores_a_torn_checkpoint(tmp_path):
    dt, _, _ = _train_data(13)
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "als-train.ckpt.npz").write_bytes(b"torn garbage")
    gen = lambda: torch.Generator().manual_seed(2)  # noqa: E731
    m = T.train_als_checkpointed(dt, ck, checkpoint_every=2, features=4,
                                 iterations=4, seed_key=gen(), device="cpu")
    base = T.train_als(dt, features=4, iterations=4, seed_key=gen(), device="cpu")
    assert np.array_equal(m.x, base.x)


def _synth_interactions(seed=1, n=2000, users=60, items=40):
    r = np.random.default_rng(seed)
    u = np.array([f"u{r.integers(0, users)}" for _ in range(n)], dtype=object)
    i = np.array([f"i{r.integers(0, items)}" for _ in range(n)], dtype=object)
    return T.aggregate_interactions(u, i, r.uniform(0.5, 3.0, n), implicit=True)


def test_warm_start_early_stops_and_matches_cold_quality():
    RandomManager.use_test_seed(7)
    data = _synth_interactions()
    kw = dict(features=8, lam=0.01, alpha=10.0, iterations=10, device="cpu")
    cold, it_cold = T.train_als_warm(data, tol=0.0, **kw)
    assert it_cold == 10
    warm, it_warm = T.train_als_warm(
        data, resume_y=cold.y, tol=0.05, min_iterations=2, check_every=2, **kw)
    assert it_warm < 10
    p_cold, p_warm = cold.x @ cold.y.T, warm.x @ warm.y.T
    assert np.linalg.norm(p_warm - p_cold) / np.linalg.norm(p_cold) < 0.2


def test_align_factors_keeps_retained_rows():
    prev = np.arange(12, dtype=np.float32).reshape(4, 3)
    args = (["b", "a", "d", "c"], prev, ["a", "c", "e"], 3)
    got = T.align_factors(*args, seed_key=torch.Generator().manual_seed(0))
    want = J.align_factors(*args)
    assert got.shape == want.shape == (3, 3)
    assert np.array_equal(got[:2], want[:2]) and np.array_equal(got[0], prev[1])
    assert not np.allclose(got[2], 0.0)  # new id: cold init, not zeros
    assert T.align_factors(["a"], prev, ["a"], 5) is None
    assert T.align_factors(None, None, ["a"], 3) is None


# ---- flops, rng, synth, evaluate, quality -----------------------------------

def test_flops_match_and_peaks_are_the_card_table():
    from oryx_tpu.ops import flops as JF
    from oryx_tpu_torch.ops import flops as TF

    assert TF.als_halfstep_flops(100, 32, 8, 50) == JF.als_halfstep_flops(100, 32, 8, 50)
    assert TF.topk_score_flops(3, 10, 5) == JF.topk_score_flops(3, 10, 5)
    for d in ("int8", "bf16", "f32", "weird"):
        assert TF.normalize_dtype(d) == JF.normalize_dtype(d)
    name = "NVIDIA H100 80GB HBM3"
    assert TF.peak_flops_for_name(name, "bfloat16") == 989e12
    assert TF.peak_flops_for_name(name, "int8") == 1979e12
    assert TF.peak_flops_for_name(name, "float32") == 67e12
    assert TF.peak_flops_for_name("NVIDIA A100-SXM4-80GB") is None
    assert TF.mfu(1e12, None) is None and TF.mfu(5e11, 1e12) == 0.5


def test_rng_generators_follow_the_test_seed():
    RandomManager.use_test_seed(5)
    a = [torch.randn(3, generator=RandomManager.get_generator()) for _ in range(2)]
    RandomManager.use_test_seed(5)
    b = [torch.randn(3, generator=RandomManager.get_generator()) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


def test_synth_and_evaluate_match():
    from oryx_tpu.common.rng import RandomManager as JR
    from oryx_tpu.ml import evaluate as JE
    from oryx_tpu.ml.synth import synthesize_interactions as j_synth
    from oryx_tpu_torch.ml import evaluate as TE
    from oryx_tpu_torch.ml.synth import synthesize_interactions as t_synth

    for a, b in zip(t_synth(300, 120, 5000, seed=3), j_synth(300, 120, 5000, seed=3)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((30, 4)), rng.standard_normal((50, 4))
    tu, ti = rng.integers(0, 30, 80), rng.integers(0, 50, 80)
    tv = rng.random(80)
    known = {0: {1, 2}, 3: {4}}
    JR.use_test_seed(9)
    RandomManager.use_test_seed(9)
    assert TE.auc_mean_per_user(x, y, tu, ti, known) == JE.auc_mean_per_user(x, y, tu, ti, known)
    assert TE.rmse(x, y, tu, ti, tv) == JE.rmse(x, y, tu, ti, tv)


def test_hyperparam_combos_match():
    from oryx_tpu.common.rng import RandomManager as JR
    from oryx_tpu.ml.hyperparams import choose_combos as j_choose
    from oryx_tpu_torch.ml.hyperparams import choose_combos as t_choose

    ranges = {"features": [4, 8, 16], "lambda": {"min": 0.001, "max": 0.1},
              "alpha": 1.0}
    for search in ("grid", "random"):
        JR.use_test_seed(4)
        RandomManager.use_test_seed(4)
        assert t_choose(ranges, 5, search) == j_choose(ranges, 5, search)


def test_build_and_evaluate_on_the_cpu():
    from oryx_tpu_torch.ml.quality import build_and_evaluate

    rep = build_and_evaluate(600, 370, 20_000, features=10, iterations=4,
                             compute_dtype="float32", device="cpu")
    assert rep.nan_rows == 0 and rep.auc > 0.85
    assert rep.timings["train_s"] > 0 and rep.timings["synth_s"] > 0
    assert rep.model.x.shape == (rep.data.n_users, 10)


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("tol", [0.2, 0.05])
def test_train_als_warm_matches_with_the_same_resume_y(implicit, tol):
    """The incremental generation's trainer: the same data and the same
    resume_y into both packages' train_als_warm run the same number of
    sweeps (the early stop reads the same prediction change) and give
    factors within the train_als tolerance above."""
    dt, dj, r = _train_data(21)
    y0 = (r.standard_normal((dj.n_items, 8)) * 0.1
          + 1 / np.sqrt(8)).astype(np.float32)
    kw = dict(features=8, lam=0.01, alpha=1.0, iterations=10,
              implicit=implicit, resume_y=y0, tol=tol, min_iterations=2,
              check_every=2)
    got, got_sweeps = T.train_als_warm(dt, device="cpu", **kw)
    want, want_sweeps = J.train_als_warm(dj, **kw)
    assert got_sweeps == want_sweeps
    assert got.user_ids == want.user_ids and got.item_ids == want.item_ids
    np.testing.assert_allclose(got.x, want.x, rtol=1e-3,
                               atol=1e-3 * np.abs(want.x).max())
    np.testing.assert_allclose(got.y, want.y, rtol=1e-3,
                               atol=1e-3 * np.abs(want.y).max())


def test_checkpointed_resume_matches_the_jax_package(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote mid-build (killed after its first
    chunk) resumes in the port as in the JAX package: the same format and
    fingerprint, so the port picks up at sweep 2 from the JAX package's Y
    and both end within the train_als tolerance; each package's resume
    equals its own uninterrupted build exactly (the JAX package's own
    test, and test_checkpointed_resume_equals_uninterrupted above)."""
    import shutil

    dt, dj, _ = _train_data(12)
    kw = dict(features=8, iterations=6, lam=0.01, alpha=1.0)
    real, calls = J.train_als, []

    def killed_after_first_chunk(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("killed")
        return real(*a, **k)

    ck = tmp_path / "jax-ck"
    monkeypatch.setattr(J, "train_als", killed_after_first_chunk)
    with pytest.raises(KeyboardInterrupt):
        J.train_als_checkpointed(dj, ck, checkpoint_every=2, **kw)
    monkeypatch.setattr(J, "train_als", real)
    with np.load(ck / "als-train.ckpt.npz") as z:
        assert int(z["done"]) == 2
        y_ck = z["y"].copy()
    port_ck = tmp_path / "port-ck"
    shutil.copytree(ck, port_ck)

    seen = []
    port_real = T.train_als

    def spy(*a, **k):
        seen.append((k["iterations"], k["resume_y"]))
        return port_real(*a, **k)

    monkeypatch.setattr(T, "train_als", spy)
    got = T.train_als_checkpointed(dt, port_ck, checkpoint_every=2,
                                   device="cpu", **kw)
    want = J.train_als_checkpointed(dj, ck, checkpoint_every=2, **kw)
    # the port resumed: 4 sweeps left in 2 chunks, the first from the
    # JAX package's checkpointed Y
    assert [n for n, _ in seen] == [2, 2]
    np.testing.assert_array_equal(seen[0][1], y_ck)
    assert not (port_ck / "als-train.ckpt.npz").exists()
    np.testing.assert_allclose(got.x, want.x, rtol=1e-3,
                               atol=1e-3 * np.abs(want.x).max())
    np.testing.assert_allclose(got.y, want.y, rtol=1e-3,
                               atol=1e-3 * np.abs(want.y).max())
