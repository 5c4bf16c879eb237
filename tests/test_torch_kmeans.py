"""k-means ops of the PyTorch port (oryx_tpu_torch/ops/kmeans.py) on the CPU
against the JAX package's (oryx_tpu/ops/kmeans.py), same numpy-seeded
inputs, each tolerance stated; then tests/test_ops_kmeans.py's contracts
against the port. The port runs on ``device="cpu"``; the k-means||
draws come from a torch generator and the JAX package's from
``jax.random``, so parity of the Lloyd step is tested from the same
``centers0``, and of the whole trainer by its SSE.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import kmeans as J
from oryx_tpu_torch.common.rng import RandomManager as PortRandom
from oryx_tpu_torch.ops import kmeans as P

CPU = "cpu"


def _points(n=2400, d=6, k=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((k, d)) * 4).astype(np.float32)
    pts = (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return pts, centers


def _sq_scale(pts, centers):
    """The expansion's natural scale per (point, center): |x|^2 + |c|^2."""
    return (pts * pts).sum(1)[:, None] + (centers * centers).sum(1)[None, :]


def test_assign_clusters_matches_jax():
    """ids equal; squared distances within 1e-5 relative to |x|^2 + |c|^2
    (the expansion's own roundoff; a distance near 0 has no relative
    accuracy in either package)."""
    pts, _ = _points()
    centers = pts[:7] + 0.25
    ij, dj = J.assign_clusters(pts, centers)
    ip, dp = P.assign_clusters(pts, centers, device=CPU)
    np.testing.assert_array_equal(np.asarray(ij), ip.numpy())
    scale = _sq_scale(pts, centers)[np.arange(len(pts)), ip.numpy()]
    err = np.abs(np.asarray(dj, np.float64) ** 2 - dp.numpy().astype(np.float64) ** 2)
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())


def test_assign_clusters_first_of_tied_centers():
    """argmin keeps the first of tied centers, as jnp.argmin does."""
    centers = np.array([[1.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]], np.float32)
    pts = np.array([[2.0, 0.0], [-2.0, 0.0], [0.0, 0.0]], np.float32)
    ip, _ = P.assign_clusters(pts, centers, device=CPU)
    ij, _ = J.assign_clusters(pts, centers)
    assert ip.tolist() == np.asarray(ij).tolist() == [0, 2, 0]


@pytest.mark.parametrize("iterations", [1, 8])
def test_lloyd_matches_jax(iterations):
    """Same centers0 and weights (every 7th weight zero, one center far
    from every point, so its cluster stays empty): centers within 1e-5
    relative to the largest center entry, counts equal."""
    pts, _ = _points()
    c0 = pts[:6].copy()
    c0[5] = 1000.0
    w = np.ones(len(pts), np.float32)
    w[::7] = 0.0
    cj, nj = J.lloyd_jit(jnp.asarray(pts), jnp.asarray(w), jnp.asarray(c0),
                         iterations=iterations)
    cp, np_ = P.lloyd(pts, w, c0, iterations=iterations, device=CPU)
    cj = np.asarray(cj)
    np.testing.assert_allclose(cp.numpy(), cj, rtol=0, atol=1e-5 * np.abs(cj).max())
    np.testing.assert_array_equal(np_.numpy(), np.asarray(nj))
    # the empty cluster kept its center; zero-weight rows counted nothing
    np.testing.assert_array_equal(cp.numpy()[5], c0[5])
    assert np_.numpy().sum() == w.sum()


def test_zero_weight_rows_never_move_a_center():
    pts, _ = _points(n=300)
    far = np.full((50, pts.shape[1]), 500.0, np.float32)
    w = np.concatenate([np.ones(len(pts), np.float32), np.zeros(50, np.float32)])
    c0 = pts[:3]
    cp, counts = P.lloyd(np.concatenate([pts, far]), w, c0, iterations=5, device=CPU)
    cref, _ = P.lloyd(pts, np.ones(len(pts), np.float32), c0, iterations=5, device=CPU)
    np.testing.assert_allclose(cp.numpy(), cref.numpy(), rtol=0, atol=1e-5)
    assert counts.numpy().sum() == len(pts)


def test_weighted_kmeanspp_bit_identical():
    rng = np.random.default_rng(4)
    cand = rng.standard_normal((300, 5)).astype(np.float32)
    w = rng.integers(0, 50, 300).astype(np.float32)
    for k in (1, 9, 40):
        np.testing.assert_array_equal(
            P._weighted_kmeanspp(cand, w, k), J._weighted_kmeanspp(cand, w, k, None))
    dup = np.repeat(cand[:3], 4, axis=0)  # fewer distinct candidates than k
    wd = np.ones(len(dup), np.float32)
    np.testing.assert_array_equal(
        P._weighted_kmeanspp(dup, wd, 6), J._weighted_kmeanspp(dup, wd, 6, None))


def test_online_update_bit_identical():
    rng = np.random.default_rng(6)
    for _ in range(50):
        c, p = rng.standard_normal(8), rng.standard_normal(8)
        n, m = int(rng.integers(1, 1000)), int(rng.integers(1, 100))
        a, na = P.online_update(c, n, p, m)
        b, nb = J.online_update(c, n, p, m)
        np.testing.assert_array_equal(a, b)
        assert na == nb


@pytest.mark.parametrize("metric", [
    "sum_squared_error", "davies_bouldin_index", "dunn_index", "silhouette_coefficient",
])
def test_metrics_match_jax(metric):
    """All four metrics within 1e-6 relative; 2,000 points, under the
    silhouette's 4,096 sample bound, so neither package samples."""
    pts, _ = _points(n=2000)
    centers = np.asarray(J.lloyd_jit(
        jnp.asarray(pts), jnp.ones(len(pts)), jnp.asarray(pts[:5]), iterations=4)[0])
    a = getattr(J, metric)(pts, centers)
    b = getattr(P, metric)(pts, centers, device=CPU)
    assert b == pytest.approx(a, rel=1e-6)


def test_silhouette_samples_from_the_torch_generator():
    """Past SILHOUETTE_MAX_SAMPLE points the sample comes from the
    generator: the same seed gives the same value."""
    pts, centers = _points(n=P.SILHOUETTE_MAX_SAMPLE + 500)
    vals = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        vals.append(P.silhouette_coefficient(pts, centers, generator=g, device=CPU))
    assert vals[0] == vals[1] and 0.0 < vals[0] <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_kmeans_sse_matches_jax(seed):
    """Planted blobs, the default k-means|| init: the port's trained SSE
    within 1% of the JAX package's (different init draws, same data).
    The random init is left out here: from different draws either package
    may stop in another local optimum (test_train_recovers_blobs holds it
    to the planted blobs with restarts)."""
    from oryx_tpu.common.rng import RandomManager as JaxRandom

    pts, _ = _points(n=3000, k=5, seed=seed)
    JaxRandom.use_test_seed()
    PortRandom.use_test_seed()
    mj = J.train_kmeans(pts, 5, iterations=15)
    mp = P.train_kmeans(pts, 5, iterations=15, device=CPU)
    sj = J.sum_squared_error(pts, mj.centers)
    sp = P.sum_squared_error(pts, mp.centers, device=CPU)
    assert sp == pytest.approx(sj, rel=0.01)
    assert mp.counts.sum() == len(pts) and mp.counts.dtype == np.int64


def test_train_kmeans_timings_and_drops_nan_rows():
    pts, _ = _points(n=500, k=3)
    pts[::50, 1] = np.nan
    PortRandom.use_test_seed()
    timings: dict = {}
    m = P.train_kmeans(pts, 3, iterations=5, device=CPU, timings=timings)
    assert m.counts.sum() == len(pts) - 10
    assert set(timings) == {"upload_s", "init_s", "lloyd_s"}
    with pytest.raises(ValueError):
        P.train_kmeans(np.full((4, 2), np.nan, np.float32), 2, device=CPU)


def test_mesh_raises():
    pts, _ = _points(n=100, k=2)
    with pytest.raises(ValueError, match="queue 1 item 11"):
        P.train_kmeans(pts, 2, mesh=object(), device=CPU)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, _ = _points(n=50, k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.train_kmeans(pts, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.assign_clusters(pts, pts[:2])
    # a tensor already placed runs where it lies
    ids, _ = P.assign_clusters(torch.from_numpy(pts), pts[:2])
    assert ids.device.type == "cpu"


# ---------------------------------------------------------------------------
# tests/test_ops_kmeans.py's contracts against the port
# ---------------------------------------------------------------------------

def _blobs(n_per=60, d=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array(
        [[5.0] * d, [-5.0] * d, [5.0] * (d // 2) + [-5.0] * (d - d // 2)],
        dtype=np.float32,
    )
    pts = np.concatenate(
        [c + rng.normal(0, 0.3, (n_per, d)).astype(np.float32) for c in centers]
    )
    return pts, centers


@pytest.mark.parametrize("init", ["k-means||", "random"])
def test_train_recovers_blobs(init):
    PortRandom.use_test_seed()
    pts, true_centers = _blobs()
    runs = 4 if init == "random" else 1
    m = P.train_kmeans(pts, k=3, iterations=20, init=init, runs=runs, device=CPU)
    assert m.centers.shape == (3, 4)
    assert m.counts.sum() == len(pts)
    for tc in true_centers:
        assert np.linalg.norm(m.centers - tc, axis=1).min() < 0.5
    assert sorted(m.counts) == [60, 60, 60]


def test_k_clamped_to_distinct_points():
    pts = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 0.0]], dtype=np.float32)
    m = P.train_kmeans(pts, k=5, iterations=5, device=CPU)
    assert len(m.centers) == 2


def test_assign_and_metrics_tiny():
    centers = np.array([[0.0, 0.0], [10.0, 0.0]], dtype=np.float32)
    pts = np.array([[1.0, 0.0], [-1.0, 0.0], [9.0, 0.0], [11.0, 0.0]], dtype=np.float32)
    ids, dist = P.assign_clusters(pts, centers, device=CPU)
    assert ids.tolist() == [0, 0, 1, 1]
    assert np.allclose(dist.numpy(), 1.0, atol=1e-5)
    assert P.sum_squared_error(pts, centers, device=CPU) == pytest.approx(4.0, abs=1e-4)
    assert P.davies_bouldin_index(pts, centers, device=CPU) == pytest.approx(0.2, abs=1e-4)
    assert P.dunn_index(pts, centers, device=CPU) == pytest.approx(10.0, abs=1e-3)
    assert 0.5 < P.silhouette_coefficient(pts, centers, device=CPU) <= 1.0


def test_silhouette_singleton_cluster_zero():
    centers = np.array([[0.0], [100.0]], dtype=np.float32)
    pts = np.array([[0.0], [1.0], [100.0]], dtype=np.float32)
    assert P.silhouette_coefficient(pts, centers, device=CPU) > 0.5


def test_online_update_matches_reference_formula():
    center, count = P.online_update(np.array([0.0, 0.0]), 3, np.array([4.0, 8.0]), 1)
    assert np.allclose(center, [1.0, 2.0])
    assert count == 4
