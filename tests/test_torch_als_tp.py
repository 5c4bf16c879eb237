"""The port's multi-device ALS trainers against the JAX package's
(tests/test_als_tp.py's contracts on port objects, on the CPU).

The port's ``train_als_tp`` on a (4, 2) CPU mesh and the JAX package's on
its 8-virtual-device ``mesh42`` start from the same ``resume_y``; the same
math in another summation order, so factors agree within rtol 2e-3 and
atol 2e-4 (the tolerance the JAX package holds its own TP trainer to
against its replicated one). The data-parallel ``train_als(mesh=)`` is
held to the JAX package's the same way.
"""

import jax
import numpy as np
import pytest

from oryx_tpu.ops import als as J
from oryx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec, make_mesh as jax_make_mesh
from oryx_tpu_torch.ops import als as T
from oryx_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, MeshSpec, host_mesh, make_mesh,
)

CPU = "cpu"
TOL = dict(rtol=2e-3, atol=2e-4)


def _synth(pkg, n_users=60, n_items=40, nnz=600, seed=5):
    rng = np.random.default_rng(seed)
    return pkg.aggregate_interactions(
        rng.integers(0, n_users, nnz).astype(str),
        rng.integers(0, n_items, nnz).astype(str),
        (rng.random(nnz) * 3 + 0.2).astype(np.float32),
        implicit=True,
    )


def _y0(n, k, seed=3):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, k)) * 0.1 + 1 / np.sqrt(k)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh42():
    return make_mesh(MeshSpec(data=4, model=2), [CPU] * 8)


@pytest.fixture(scope="module")
def jax_mesh42():
    return jax_make_mesh(JaxMeshSpec(data=4, model=2), jax.devices()[:8])


@pytest.mark.parametrize("implicit", [True, False])
def test_tp_matches_replicated_trainer(mesh42, jax_mesh42, implicit):
    dt, dj = _synth(T), _synth(J)
    kwargs = dict(features=6, lam=0.05, alpha=2.0, iterations=5,
                  implicit=implicit, resume_y=_y0(dj.n_items, 6))
    want = J.train_als_tp(dj, jax_mesh42, **kwargs)
    got = T.train_als_tp(dt, mesh42, **kwargs)
    one = T.train_als(dt, device=CPU, **kwargs)
    assert got.user_ids == want.user_ids and got.item_ids == want.item_ids
    np.testing.assert_allclose(got.x, want.x, **TOL)
    np.testing.assert_allclose(got.y, want.y, **TOL)
    np.testing.assert_allclose(got.x, one.x, **TOL)
    np.testing.assert_allclose(got.y, one.y, **TOL)


def test_tp_uneven_shapes_and_small_blocks(mesh42, jax_mesh42):
    dt = _synth(T, n_users=37, n_items=23, nnz=300, seed=9)
    dj = _synth(J, n_users=37, n_items=23, nnz=300, seed=9)
    kw = dict(features=4, iterations=3, resume_y=_y0(dj.n_items, 4, 1))
    want = J.train_als_tp(dj, jax_mesh42, **kw)
    got = T.train_als_tp(dt, mesh42, **kw)
    np.testing.assert_allclose(got.x, want.x, **TOL)
    np.testing.assert_allclose(got.y, want.y, **TOL)


def test_tp_hlo_contains_cross_shard_collectives(mesh42, monkeypatch):
    """The loop sums over both mesh axes (the partial normal equations and
    the Grams), and its outputs stay split: X over "data" rows, Y over
    "model" rows, no cell holding either whole."""
    dt = _synth(T, n_users=32, n_items=16, nnz=200, seed=2)
    dp, tp = mesh42.shape[DATA_AXIS], mesh42.shape[MODEL_AXIS]
    blk = 8
    n_u = -(-dt.n_users // (dp * blk)) * (dp * blk)
    n_i = -(-dt.n_items // (tp * blk)) * (tp * blk)
    u = T.build_padded_lists(dt.users, dt.items, dt.values, n_u)
    i = T.build_padded_lists(dt.items, dt.users, dt.values, n_i)
    y0 = T.torch.from_numpy(_y0(n_i, 4))
    axes = []
    real = Mesh.psum

    def counting(self, parts, axis):
        axes.append(axis)
        return real(self, parts, axis)

    monkeypatch.setattr(Mesh, "psum", counting)
    x, y = T.als_train_tp(mesh42, u, i, y0, 0.01, 1.0, implicit=True,
                          iterations=2, block=blk)
    assert axes.count(MODEL_AXIS) >= 2 and axes.count(DATA_AXIS) >= 2
    assert x.axis == DATA_AXIS and y.axis == MODEL_AXIS
    assert x.block(0, 0).shape[0] == n_u // dp
    assert y.block(0, 0).shape[0] == n_i // tp
    assert np.asarray(y).shape == (n_i, 4)


def test_row_pad_helper():
    a = np.ones((3, 2))
    assert T._row_pad(a, 8).shape == (8, 2)
    assert T._row_pad(a, 3) is a


def test_checkpointed_training_on_tp_mesh(tmp_path):
    """resume_y threads through the tensor-parallel dispatch: a chunked
    checkpointed run on a (2, 2) mesh equals the uninterrupted one."""
    rng = np.random.default_rng(9)
    data = T.aggregate_interactions(
        rng.integers(0, 64, 4000).astype(str),
        rng.integers(0, 80, 4000).astype(str),
        rng.random(4000) + 0.1,
        implicit=True,
    )
    mesh = make_mesh(MeshSpec(data=2, model=2), [CPU] * 4)
    gen = lambda: T.torch.Generator().manual_seed(13)  # noqa: E731
    base = T.train_als(data, features=8, iterations=4, implicit=True,
                       mesh=mesh, block=8, seed_key=gen())
    chunked = T.train_als_checkpointed(
        data, tmp_path / "ck", checkpoint_every=2, features=8, iterations=4,
        implicit=True, mesh=mesh, block=8, seed_key=gen(),
    )
    np.testing.assert_allclose(chunked.x, base.x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(chunked.y, base.y, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_mesh_matches_jax(n):
    """train_als(mesh=host_mesh(n)) of both packages from the same Y."""
    from oryx_tpu.parallel.mesh import host_mesh as jax_host_mesh

    dt, dj = _synth(T, seed=7), _synth(J, seed=7)
    kw = dict(features=5, lam=0.02, iterations=4, resume_y=_y0(dj.n_items, 5))
    want = J.train_als(dj, mesh=jax_host_mesh(n), **kw)
    got = T.train_als(dt, mesh=host_mesh(n, CPU), **kw)
    np.testing.assert_allclose(got.x, want.x, **TOL)
    np.testing.assert_allclose(got.y, want.y, **TOL)


def test_tp_failed_rows_take_one_decision_per_group(mesh42):
    """A tiny lambda with explicit zeros makes some systems singular in
    f32: the rows are re-solved in f64 (then jittered), and every model
    replica of a data row holds the same X block."""
    rng = np.random.default_rng(3)
    dt = T.aggregate_interactions(
        rng.integers(0, 40, 300).astype(str), rng.integers(0, 30, 300).astype(str),
        np.where(rng.random(300) < 0.5, 0.0, 1.0).astype(np.float32) + 1e-9,
        implicit=False,
    )
    blk = min(T._tp_block(dt.n_users, 4, 8), T._tp_block(dt.n_items, 2, 8))
    n_u = -(-dt.n_users // (4 * blk)) * (4 * blk)
    n_i = -(-dt.n_items // (2 * blk)) * (2 * blk)
    u = [T._row_pad(a, n_u) for a in T.build_padded_lists(
        dt.users, dt.items, dt.values, dt.n_users)]
    i = [T._row_pad(a, n_i) for a in T.build_padded_lists(
        dt.items, dt.users, dt.values, dt.n_items)]
    y0 = T.torch.from_numpy(_y0(n_i, 6))
    x, _ = T.als_train_tp(mesh42, u, i, y0, 1e-12, 1.0, implicit=False,
                          iterations=2, block=blk)
    for d in range(4):
        assert T.torch.equal(x.block(d, 0), x.block(d, 1))
    assert np.isfinite(np.asarray(x)).all()


def test_f64_reference_witnesses_both_f32_trainers(mesh42):
    """The trainer probe's float64 witness (ops/als_probe.py
    ``f64_reference``) holds the JAX package's f32 trainer and both of the
    port's f32 trainers, single-device and tensor-parallel, to the parity
    tolerance."""
    from oryx_tpu_torch.ops.als_probe import f64_reference

    dt, dj = _synth(T), _synth(J)
    y0 = _y0(dt.n_items, 6)
    kw = dict(features=6, lam=0.05, alpha=1.0, iterations=6, implicit=True,
              resume_y=y0)
    one = T.train_als(dt, device=CPU, **kw)
    tp = T.train_als_tp(dt, mesh42, **kw)
    jx = J.train_als(dj, **kw)
    x64, y64, failed = f64_reference(dt, y0, lam=0.05, alpha=1.0,
                                     iterations=6, device=CPU)
    assert failed == 0
    for m in (one, tp):
        np.testing.assert_allclose(m.x, x64, **TOL)
        np.testing.assert_allclose(m.y, y64, **TOL)
    np.testing.assert_allclose(np.asarray(jx.y), y64, **TOL)
