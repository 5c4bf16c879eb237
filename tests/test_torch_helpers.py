"""The port's public helpers beside the JAX package's: ops/vector.py's
``dot``, ``norm``, ``cosine_similarity`` and ``random_unit_vectors`` (the
contracts of tests/test_ops_als.py's vector tests on port objects),
``classutil.class_exists``, ``executil.do_in_parallel``,
``map_in_parallel`` and ``LoggingRunnable``, ``Forest.weights()`` and the
RDF app's ``node_id``, each on the same inputs in both packages."""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oryx_tpu.common.classutil as jclassutil
import oryx_tpu.common.executil as jexecutil
import oryx_tpu.ops as jops
from oryx_tpu.apps.rdf import common as jrdf_common
from oryx_tpu.ops import rdf as jrdf
from oryx_tpu_torch import ops as P
from oryx_tpu_torch.apps.rdf import common as rdf_common
from oryx_tpu_torch.common import classutil, executil
from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.ops import rdf


# ---- vector: tests/test_ops_als.py's contracts -----------------------------


def test_vector_primitives():
    x = torch.tensor([1.0, 2.0, 3.0])
    y = torch.tensor([4.0, 5.0, 6.0])
    assert float(P.dot(x, y)) == pytest.approx(32.0)
    assert float(P.norm(x)) == pytest.approx(np.sqrt(14.0))
    assert float(P.cosine_similarity(x, x)) == pytest.approx(1.0, abs=1e-6)
    assert float(P.cosine_similarity(x, -x)) == pytest.approx(-1.0, abs=1e-6)


def test_random_unit_vectors():
    v = P.random_unit_vectors(10, 5, device="cpu").numpy()
    assert v.shape == (10, 5) and v.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-5)


def test_random_unit_vectors_deterministic_under_the_test_seed():
    RandomManager.use_test_seed(7)
    try:
        a = P.random_unit_vectors(4, 3, device="cpu")
        RandomManager.use_test_seed(7)
        b = P.random_unit_vectors(4, 3, device="cpu")
    finally:
        RandomManager.clear_test_seed()
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    c = P.random_unit_vectors(4, 3, generator=gen, device="cpu")
    assert torch.equal(
        c, P.random_unit_vectors(4, 3, device="cpu",
                                 generator=torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("seed", range(3))
def test_vector_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=17).astype(np.float32)
    y = rng.normal(size=17).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(float(P.dot(xt, yt)), float(jops.dot(xj, yj)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(P.norm(xt)), float(jops.norm(xj)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(P.cosine_similarity(xt, yt)),
                               float(jops.cosine_similarity(xj, yj)),
                               rtol=1e-5)
    ny = float(np.linalg.norm(y))
    np.testing.assert_allclose(
        float(P.cosine_similarity(xt, yt, norm_y=torch.tensor(ny))),
        float(jops.cosine_similarity(xj, yj, norm_y=ny)), rtol=1e-5)
    m = rng.normal(size=(20, 6)).astype(np.float32)
    np.testing.assert_allclose(P.gram(torch.from_numpy(m)).numpy(),
                               np.asarray(jops.gram(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-5)


# ---- classutil and executil -------------------------------------------------


@pytest.mark.parametrize("dotted", [
    "collections.OrderedDict", "oryx_tpu_torch.ops.rdf.Forest",
    "collections.NoSuchClass", "no_such_module.Thing", "OrderedDict", "",
])
def test_class_exists_matches_jax(dotted):
    want = jclassutil.class_exists(dotted.replace("oryx_tpu_torch", "oryx_tpu"))
    assert classutil.class_exists(dotted) is want


def test_do_in_parallel_runs_every_task():
    for parallelism in (None, 1, 3, 16):
        seen, jseen = [], []
        assert executil.do_in_parallel(5, seen.append, parallelism) is None
        jexecutil.do_in_parallel(5, jseen.append, parallelism)
        assert sorted(seen) == sorted(jseen) == list(range(5))
    executil.do_in_parallel(0, lambda i: pytest.fail("no task to run"))


@pytest.mark.parametrize("parallelism", [1, 2, 4, 8])
def test_map_in_parallel_keeps_order(parallelism):
    items = list(range(11))
    got = executil.map_in_parallel(items, lambda v: v * v, parallelism)
    assert got == jexecutil.map_in_parallel(items, lambda v: v * v, parallelism)
    assert got == [v * v for v in items]


def test_logging_runnable_logs_and_reraises(caplog):
    ran = []
    executil.LoggingRunnable(lambda: ran.append(1), name="ok")()
    assert ran == [1]

    def boom():
        raise ValueError("boom")

    for cls in (executil.LoggingRunnable, jexecutil.LoggingRunnable):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            with pytest.raises(ValueError, match="boom"):
                cls(boom, name="the-task")()
        assert "unexpected error in the-task" in caplog.text


# ---- the forest's weights and node ids --------------------------------------


@pytest.mark.parametrize("trees", [1, 3, 10])
def test_forest_weights_match_jax(trees):
    feature = np.full((trees, 7), -1, dtype=np.int32)
    importances = np.zeros(4)
    kw = dict(split_left=np.zeros((trees, 7, 2), dtype=bool),
              class_counts=np.ones((trees, 7, 2)), leaf_stats=None,
              feature_importances=importances, max_depth=2)
    got = rdf.Forest(feature=feature, **kw).weights()
    want = jrdf.Forest(feature=feature, **kw).weights()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == pytest.approx(1.0)


def test_node_id_matches_jax():
    for slot in range(63):
        nid = rdf_common.node_id(slot)
        assert nid == jrdf_common.node_id(slot)
        assert rdf.node_id_to_heap(nid) == slot
