"""Random-decision-forest ops of the PyTorch port (oryx_tpu_torch/ops/rdf.py)
on the CPU against the JAX package's (oryx_tpu/ops/rdf.py), same
numpy-seeded inputs, each tolerance stated; then tests/test_ops_rdf.py's
contracts against the port (``device="cpu"``).

Both packages draw the bootstrap weights from their RandomManager's numpy
stream, so under the same test seed the weights are the same. The per-node
feature subsets come from ``jax.random`` in one and a torch generator in
the other, so structural parity is tested with every feature at every node
(``feature_subset="all"``). Classification histograms sum integers exactly
in both, so the trees must be identical; a split that still differs is
accepted only as a near tie: the two packages' chosen splits, scored in
float64 on the node's examples, within 1e-6 of each other (relative to
the node's impurity). Regression histograms are float sums in another
order, so near-tie flips do happen there; predictions must agree within
1e-4 relative wherever both forests send an example to the same leaves.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.common.rng import RandomManager as JaxRandom
from oryx_tpu.ops import rdf as J
from oryx_tpu_torch.common.rng import RandomManager as PortRandom
from oryx_tpu_torch.ops import rdf as P

CPU = "cpu"
NEAR_TIE = 1e-6


@pytest.fixture(autouse=True)
def _seed():
    JaxRandom.use_test_seed()
    PortRandom.use_test_seed()
    yield


def _port_data(d) -> P.BinnedData:
    return P.BinnedData(d.binned, d.edges, d.n_bins, d.is_categorical)


def _xor_data(n=3000):
    rng = np.random.default_rng(2)
    x0 = rng.random(n)
    cat = rng.integers(0, 4, n)
    y = ((x0 > 0.5) ^ (cat == 2)).astype(np.int32)
    x = np.stack([x0, rng.random(n), cat.astype(float)], axis=1)
    data = P.bin_dataset(x, np.array([False, False, True]), np.array([0, 0, 4]), 32)
    return data, y


def _multiclass_data(n=4000, c=5):
    """Four numeric predictors, a categorical one and c classes with label
    noise, so nodes deep in a tree have mixed, uneven class counts."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, 5))
    x[:, 4] = rng.integers(0, 6, n)
    y = ((x[:, 0] > 0) * 2 + (x[:, 1] > 0.4) + (x[:, 4] > 2)) % c
    y = np.where(rng.random(n) < 0.15, rng.integers(0, c, n), y).astype(np.int32)
    is_cat = np.array([False] * 4 + [True])
    data = P.bin_dataset(x, is_cat, np.array([0, 0, 0, 0, 6]), 16)
    return data, y


def _regression_data(n=3000):
    rng = np.random.default_rng(3)
    x0, x1 = rng.random(n), rng.random(n)
    y = (3 * x0 + np.sin(4 * x1)).astype(np.float32)
    data = P.bin_dataset(np.stack([x0, x1], axis=1), np.array([False, False]),
                         np.array([0, 0]), 64)
    return data, y


def _grow_both(data, y, **kw):
    """The same inputs through both packages, each from a fresh test seed
    (so both draw the same bootstrap weights), plus those weights."""
    JaxRandom.use_test_seed()
    fj = J.grow_forest(data, y, **kw)
    PortRandom.use_test_seed()
    fp = P.grow_forest(_port_data(data), y, device=CPU, **kw)
    PortRandom.use_test_seed()
    n = data.binned.shape[0]
    w = PortRandom.get_random().multinomial(
        n, np.full(n, 1.0 / n), size=kw["num_trees"]).astype(np.float64)
    return fj, fp, w


def _split_gain_f64(binned, y, w, f, left_bins, kind, n_classes):
    """Float64 gain of splitting the weighted examples (binned, y, w) on
    predictor f by the goes-left bin mask; 0 for no split."""
    if f < 0:
        return 0.0

    def stats(mask):
        ww = w * mask
        if kind == "variance":
            return np.array([ww.sum(), (ww * y).sum(), (ww * y * y).sum()])
        return np.bincount(y.astype(np.int64), weights=ww, minlength=n_classes)

    def impurity(s):
        if kind == "variance":
            n = max(s[0], 1.0)
            return max(s[2] / n - (s[1] / n) ** 2, 0.0)
        p = s / max(s.sum(), 1.0)
        if kind == "gini":
            return 1.0 - (p * p).sum()
        return -sum(v * np.log(v) for v in p if v > 0)

    goes_left = left_bins[binned[:, f]]
    parent, left, right = stats(np.ones_like(w)), stats(goes_left), stats(~goes_left)
    count = (lambda s: s[0]) if kind == "variance" else (lambda s: s.sum())
    n = max(count(parent), 1.0)
    return (impurity(parent) - count(left) / n * impurity(left)
            - count(right) / n * impurity(right)), impurity(parent)


def _first_flips(fj, fp, data, y, w, kind, n_classes):
    """Per tree, the first heap slot whose split differs between the two
    forests (its ancestors agree, so both saw the same examples there).
    Asserts each is a near tie and returns [(tree, slot, gap)]."""
    flips = []
    for t in range(fj.num_trees):
        differ = (fj.feature[t] != fp.feature[t]) | (
            (fj.split_left[t] != fp.split_left[t]).any(axis=1))
        if not differ.any():
            continue
        slot = int(np.argmax(differ))
        depth = int(np.floor(np.log2(slot + 1)))
        at = J.route_binned(fj.feature[t:t + 1], fj.split_left[t:t + 1],
                            data.binned, depth)[0] == slot
        b, yy, ww = data.binned[at], y[at], w[t][at]
        gains = []
        for f in (fj, fp):
            g = _split_gain_f64(b, yy, ww, int(f.feature[t, slot]),
                                f.split_left[t, slot], kind, n_classes)
            gains.append(g if isinstance(g, tuple) else (g, 1.0))
        gap = abs(gains[0][0] - gains[1][0])
        scale = max(gains[0][1], gains[1][1], 1e-12)
        assert gap <= NEAR_TIE * scale, (
            f"tree {t} slot {slot}: not a near tie, gains {gains}")
        flips.append((t, slot, gap / scale))
    return flips


def _under(slot: int, flips_at: set) -> bool:
    while slot > 0:
        if slot in flips_at:
            return True
        slot = (slot - 1) // 2
    return slot in flips_at


@pytest.mark.parametrize("impurity", ["entropy", "gini"])
@pytest.mark.parametrize("which", ["xor", "multiclass"])
def test_classification_trees_identical_to_jax(impurity, which):
    """feature, split_left and the class counts of every node equal the
    JAX package's (feature_subset="all", the same bootstrap weights);
    any differing split must be a near tie, and only its subtree may
    differ. The importances agree within 1e-6."""
    data, y = _xor_data() if which == "xor" else _multiclass_data()
    c = int(y.max()) + 1
    fj, fp, w = _grow_both(data, y, num_trees=6, max_depth=6, impurity=impurity,
                           n_classes=c, feature_subset="all")
    flips = _first_flips(fj, fp, data, y, w, impurity, c)
    for t in range(fj.num_trees):
        at = {s for tt, s, _ in flips if tt == t}
        keep = np.array([not _under(s, at) for s in range(fj.feature.shape[1])])
        np.testing.assert_array_equal(fp.feature[t][keep], fj.feature[t][keep])
        np.testing.assert_array_equal(fp.split_left[t][keep], fj.split_left[t][keep])
        np.testing.assert_array_equal(fp.class_counts[t][keep], fj.class_counts[t][keep])
    if not flips:
        np.testing.assert_allclose(fp.feature_importances, fj.feature_importances,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_depth", [4, 8])
def test_regression_matches_jax(max_depth):
    """Regression with every feature at every node: every differing split
    is a near tie, and predictions agree within 1e-4 relative on every
    example that both forests route to the same leaves."""
    data, y = _regression_data()
    fj, fp, w = _grow_both(data, y, num_trees=5, max_depth=max_depth,
                           impurity="variance", n_classes=0, feature_subset="all")
    _first_flips(fj, fp, data, y, w, "variance", 0)
    lj = J.route_binned(fj.feature, fj.split_left, data.binned, max_depth)
    lp = P.route_binned(fp.feature, fp.split_left, data.binned, max_depth)
    same = (lj == lp).all(axis=0)
    assert same.mean() > 0.9
    pj = J.predict_regression(fj, data.binned)[same]
    pp = P.predict_regression(fp, data.binned)[same]
    np.testing.assert_allclose(pp, pj, rtol=1e-4, atol=0)


def test_bootstrap_weights_follow_the_jax_stream():
    """The port's RandomManager hands out the JAX package's numpy stream
    under the test seed, so the bootstrap weights are the same."""
    JaxRandom.use_test_seed()
    PortRandom.use_test_seed()
    a = JaxRandom.get_random().multinomial(500, np.full(500, 1 / 500), size=3)
    b = PortRandom.get_random().multinomial(500, np.full(500, 1 / 500), size=3)
    np.testing.assert_array_equal(a, b)


def test_binning_and_node_ids_bit_identical():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2000, 4))
    x[::13, 0] = np.nan
    x[:, 2] = rng.integers(0, 5, 2000)
    x[::17, 2] = np.nan
    x[:, 3] = np.round(x[:, 3])  # heavy ties in the quantiles
    is_cat = np.array([False, False, True, False])
    counts = np.array([0, 0, 5, 0])
    for cap in (8, 32, 300):
        a = J.bin_dataset(x, is_cat, counts, cap)
        b = P.bin_dataset(x, is_cat, counts, cap)
        np.testing.assert_array_equal(a.binned, b.binned)
        np.testing.assert_array_equal(a.n_bins, b.n_bins)
        for ea, eb in zip(a.edges, b.edges):
            assert (ea is None and eb is None) or np.array_equal(ea, eb)
        for j in range(4):
            np.testing.assert_array_equal(
                J.bin_column(x[:, j] + 0.01, a.edges[j], int(a.n_bins[j])),
                P.bin_column(x[:, j] + 0.01, b.edges[j], int(b.n_bins[j])))
    for i in range(200):
        s = J.heap_to_node_id(i)
        assert P.heap_to_node_id(i) == s and P.node_id_to_heap(s) == J.node_id_to_heap(s)


def test_route_and_predictions_match_jax_on_the_same_forest():
    """The JAX package's forest arrays through both packages' routing and
    prediction: leaves bit-identical (host and device routing), class
    probabilities and regression predictions within 1e-6."""
    data, y = _xor_data(1500)
    fj = J.grow_forest(data, y, num_trees=5, max_depth=6, impurity="entropy",
                       n_classes=2)
    fport = P.Forest(**vars(fj))
    host = P.route_binned(fj.feature, fj.split_left, data.binned, fj.max_depth)
    dev = P.route_binned_device(torch.tensor(fj.feature),
                                torch.tensor(fj.split_left),
                                torch.from_numpy(data.binned), fj.max_depth)
    ref = np.asarray(J.route_binned_jit(fj.feature, fj.split_left, data.binned,
                                        max_depth=fj.max_depth))
    np.testing.assert_array_equal(host, ref)
    np.testing.assert_array_equal(dev.numpy(), ref)
    np.testing.assert_allclose(P.predict_class_probs(fport, data.binned),
                               J.predict_class_probs(fj, data.binned), rtol=0, atol=1e-6)
    rd, ry = _regression_data(1500)
    JaxRandom.use_test_seed()
    fr = J.grow_forest(rd, ry, num_trees=4, max_depth=6, impurity="variance", n_classes=0)
    np.testing.assert_allclose(P.predict_regression(P.Forest(**vars(fr)), rd.binned),
                               J.predict_regression(fr, rd.binned), rtol=1e-6, atol=0)


def test_mesh_raises():
    data, y = _xor_data(200)
    with pytest.raises(ValueError, match="queue 1 item 11"):
        P.grow_forest(data, y, num_trees=2, max_depth=3, impurity="entropy",
                      n_classes=2, mesh=object(), device=CPU)


def test_grow_forest_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, y = _xor_data(200)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.grow_forest(data, y, num_trees=2, max_depth=3, impurity="entropy",
                      n_classes=2)


def test_labels_outside_the_classes_add_nothing():
    """A label past n_classes has an all-zero one-hot row in the JAX
    package; the port's folded index must not spill it into a neighbour."""
    data, y = _xor_data(800)
    y2 = y.copy()
    y2[::9] = 5  # outside [0, 2)
    fj, fp, _ = _grow_both(data, y2, num_trees=3, max_depth=4, impurity="gini",
                           n_classes=2, feature_subset="all")
    np.testing.assert_array_equal(fp.class_counts, fj.class_counts)
    np.testing.assert_array_equal(fp.feature, fj.feature)


# ---------------------------------------------------------------------------
# tests/test_ops_rdf.py's contracts against the port
# ---------------------------------------------------------------------------

def test_node_id_round_trip():
    ids = [P.heap_to_node_id(i) for i in range(31)]
    assert ids[:7] == ["r", "r-", "r+", "r--", "r-+", "r+-", "r++"]
    for i, s in enumerate(ids):
        assert P.node_id_to_heap(s) == i
    with pytest.raises(ValueError):
        P.node_id_to_heap("x-")
    with pytest.raises(ValueError):
        P.node_id_to_heap("r0")


def test_bin_dataset_quantiles_and_categories():
    rng = np.random.default_rng(1)
    x = np.stack([rng.random(500), rng.integers(0, 3, 500).astype(float)], axis=1)
    data = P.bin_dataset(x, np.array([False, True]), np.array([0, 3]), 8)
    assert data.n_bins[0] <= 8 and data.n_bins[1] == 3
    assert data.binned[:, 0].max() < data.n_bins[0]
    assert set(np.unique(data.binned[:, 1])) <= {0, 1, 2}
    xb = P.bin_column(np.array([np.nan]), data.edges[0], int(data.n_bins[0]))
    assert xb[0] == data.n_bins[0] - 1


def test_classification_learns_xor_of_numeric_and_categorical():
    data, y = _xor_data()
    forest = P.grow_forest(data, y, num_trees=10, max_depth=6, impurity="entropy",
                           n_classes=2, device=CPU)
    probs = P.predict_class_probs(forest, data.binned)
    assert probs.shape == (len(y), 2)
    assert np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    assert np.mean(probs.argmax(axis=1) == y) > 0.95
    imp = forest.feature_importances
    assert imp[1] == min(imp) and max(imp) == 1.0


def test_gini_also_learns():
    data, y = _xor_data(1500)
    forest = P.grow_forest(data, y, num_trees=10, max_depth=6, impurity="gini",
                           n_classes=2, device=CPU)
    acc = np.mean(P.predict_class_probs(forest, data.binned).argmax(axis=1) == y)
    assert acc > 0.93


def test_regression_learns_additive_function():
    data, y = _regression_data()
    forest = P.grow_forest(data, y, num_trees=15, max_depth=8, impurity="variance",
                           n_classes=0, device=CPU)
    pred = P.predict_regression(forest, data.binned)
    assert float(np.sqrt(np.mean((pred - y) ** 2))) < 0.35 * y.std()


def test_route_host_and_device_agree():
    data, y = _xor_data(800)
    forest = P.grow_forest(data, y, num_trees=4, max_depth=5, impurity="entropy",
                           n_classes=2, device=CPU)
    host = P.route_binned(forest.feature, forest.split_left, data.binned,
                          forest.max_depth)
    dev = P.route_binned_device(torch.from_numpy(forest.feature),
                                torch.from_numpy(forest.split_left),
                                torch.from_numpy(data.binned), forest.max_depth)
    np.testing.assert_array_equal(host, dev.numpy())
    t_ix = np.arange(forest.num_trees)[:, None]
    assert (forest.feature[t_ix, host] == -1).all()


def test_deterministic_under_test_seed():
    data, y = _xor_data(500)
    out = []
    for _ in range(2):
        PortRandom.use_test_seed()
        out.append(P.grow_forest(data, y, num_trees=3, max_depth=4,
                                 impurity="entropy", n_classes=2, device=CPU))
    np.testing.assert_array_equal(out[0].feature, out[1].feature)
    np.testing.assert_array_equal(out[0].class_counts, out[1].class_counts)


def test_feature_subsets_draw_from_the_generator():
    """With mtry < P the forest differs from "all" but is reproducible."""
    data, y = _multiclass_data(1500)
    forests = []
    for subset in ("sqrt", "sqrt", "all"):
        PortRandom.use_test_seed()
        forests.append(P.grow_forest(data, y, num_trees=4, max_depth=5,
                                     impurity="entropy", n_classes=5,
                                     feature_subset=subset, device=CPU))
    np.testing.assert_array_equal(forests[0].feature, forests[1].feature)
    assert not np.array_equal(forests[0].feature, forests[2].feature)


def test_resolve_mtry_strategies():
    assert P.resolve_mtry("auto", 54, True) == 7
    assert P.resolve_mtry(None, 54, True) == 7
    assert P.resolve_mtry("auto", 54, False) == 18
    assert P.resolve_mtry("all", 54, True) == 54
    assert P.resolve_mtry("sqrt", 54, True) == 7
    assert P.resolve_mtry("log2", 54, True) == 5
    assert P.resolve_mtry("onethird", 54, True) == 18
    assert P.resolve_mtry(14, 54, True) == 14
    assert P.resolve_mtry("14", 54, True) == 14
    assert P.resolve_mtry("auto", 54, True, num_trees=1) == 54
    assert P.resolve_mtry("auto", 54, False, num_trees=1) == 54
    assert P.resolve_mtry("auto", 54, True, num_trees=20) == 7
    assert P.resolve_mtry("onethird", 10, True) == 4
    assert P.resolve_mtry("auto", 10, False) == 4
    for bad in (0, 55, "bogus"):
        with pytest.raises(ValueError):
            P.resolve_mtry(bad, 54, True)


def test_rdf_config_feature_subset_reaches_trainer():
    from oryx_tpu_torch.apps.rdf.common import RDFConfig
    from oryx_tpu_torch.common.config import load_config

    cfg = load_config(overlay={"oryx.rdf.hyperparams.feature-subset": 12})
    assert RDFConfig.from_config(cfg).feature_subset == 12
    assert RDFConfig.from_config(load_config()).feature_subset == "auto"
