"""The k-means and RDF apps of the PyTorch port: batch builds, speed updates
and REST serving, on ``device="cpu"``.

- The app-tier contracts of tests/test_kmeans_app.py and
  tests/test_rdf_app.py take a ``pkg`` fixture naming the JAX package or
  the port, so each runs against both.
- The lambda slices of tests/test_e2e_kmeans.py and tests/test_e2e_rdf.py
  run against the port's layers.
- Weights carried across: artifacts that the JAX package's ``KMeansUpdate``
  and ``RDFUpdate`` publish are loaded by the port's serving managers, and
  a JAX ``ServingLayer`` and the port's, side by side on their own mem://
  topics, must answer /assign, /distanceToNearest, /predict and
  /classificationDistribution alike (cluster ids and predicted labels
  equal; distances within 1e-5 relative to |x|^2 + |c|^2, probabilities
  within 1e-6). Both speed managers fed the same window from the same
  model must publish the same UP messages (k-means centers within 1e-9 of
  the JAX package's float64 update; RDF rows identical).
- The app registry (apps/spi.py) and ``--app kmeans|rdf`` on the CLI.
"""

from __future__ import annotations

import importlib
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from e2e_common import http_request as _http

_MODULES = {
    "config": "common.config",
    "broker": "bus.broker",
    "inproc": "bus.inproc",
    "bus_api": "bus.api",
    "ioutil": "common.ioutil",
    "rng": "common.rng",
    "server": "serving.server",
    "layers": "layers",
    "km_batch": "apps.kmeans.batch",
    "km_speed": "apps.kmeans.speed",
    "km_serving": "apps.kmeans.serving",
    "rdf_batch": "apps.rdf.batch",
    "rdf_speed": "apps.rdf.speed",
    "rdf_serving": "apps.rdf.serving",
}


def _namespace(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root)
    for name, rel in _MODULES.items():
        setattr(ns, name, importlib.import_module(f"{root}.{rel}"))
    kw = {"device": "cpu"} if root == "oryx_tpu_torch" else {}
    ns.KeyMessage = ns.bus_api.KeyMessage
    ns.load_config = ns.config.load_config
    ns.ServingLayer = ns.server.ServingLayer
    ns.RandomManager = ns.rng.RandomManager
    ns.KMeansUpdate = lambda cfg: ns.km_batch.KMeansUpdate(cfg, **kw)
    ns.KMeansSpeed = lambda cfg: ns.km_speed.KMeansSpeedModelManager(cfg, **kw)
    ns.KMeansServing = lambda cfg: ns.km_serving.KMeansServingModelManager(cfg, **kw)
    ns.RDFUpdate = lambda cfg: ns.rdf_batch.RDFUpdate(cfg, **kw)
    ns.RDFSpeed = lambda cfg: ns.rdf_speed.RDFSpeedModelManager(cfg, **kw)
    ns.RDFServing = lambda cfg: ns.rdf_serving.RDFServingModelManager(cfg, **kw)
    return ns


JAX, PORT = _namespace("oryx_tpu"), _namespace("oryx_tpu_torch")


def _reset():
    for p in (JAX, PORT):
        p.inproc.InProcBroker.reset_all()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    JAX.RandomManager.use_test_seed()
    PORT.RandomManager.use_test_seed()
    yield
    _reset()


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return JAX if request.param == "jax" else PORT


def _pkg_resources(pkg, app: str) -> list[str]:
    return [f"{pkg.root}.serving.resources.common",
            f"{pkg.root}.serving.resources.{app}"]


def _km_cfg(pkg, name="kmt", port=0, **extra):
    overlay = {
        "oryx.id": name,
        "oryx.input-topic.broker": f"mem://{name}",
        "oryx.update-topic.broker": f"mem://{name}",
        "oryx.serving.api.port": port,
        "oryx.serving.application-resources": _pkg_resources(pkg, "clustering"),
        "oryx.input-schema.num-features": 2,
        "oryx.input-schema.numeric-features": ["0", "1"],
        "oryx.kmeans.hyperparams.k": 2,
        "oryx.kmeans.iterations": 10,
        "oryx.ml.eval.test-fraction": 0.2,
    }
    overlay.update(extra)
    return pkg.load_config(overlay=overlay)


def _rdf_cfg(pkg, name="rdft", port=0, **extra):
    overlay = {
        "oryx.id": name,
        "oryx.input-topic.broker": f"mem://{name}",
        "oryx.update-topic.broker": f"mem://{name}",
        "oryx.serving.api.port": port,
        "oryx.serving.application-resources": _pkg_resources(pkg, "classreg"),
        "oryx.input-schema.feature-names": ["size", "color", "label"],
        "oryx.input-schema.numeric-features": ["size"],
        "oryx.input-schema.target-feature": "label",
        "oryx.rdf.num-trees": 8,
        "oryx.rdf.hyperparams.max-depth": 5,
        "oryx.ml.eval.test-fraction": 0.2,
    }
    overlay.update(extra)
    return pkg.load_config(overlay=overlay)


def _reg_cfg(pkg):
    return pkg.load_config(overlay={
        "oryx.id": "rdfr",
        "oryx.input-schema.feature-names": ["a", "b", "y"],
        "oryx.input-schema.numeric-features": ["a", "b", "y"],
        "oryx.input-schema.target-feature": "y",
        "oryx.rdf.num-trees": 8,
        "oryx.rdf.hyperparams.max-depth": 6,
    })


def _blob_lines(seed=0) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for c in ((0.0, 0.0), (10.0, 10.0)):
        for _ in range(40):
            out.append(f"{rng.normal(c[0], 0.2):.4f},{rng.normal(c[1], 0.2):.4f}")
    return out


def _cls_lines(n=600, seed=0) -> list[str]:
    """label = banana iff (size>0.5) xor (color==red)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = rng.random()
        color = rng.choice(["red", "green", "blue"])
        label = "banana" if (size > 0.5) ^ (color == "red") else "apple"
        out.append(f"{size:.4f},{color},{label}")
    return out


def _reg_lines(n=800, seed=1) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = rng.random(), rng.random()
        out.append(f"{a:.4f},{b:.4f},{3 * a - 2 * b:.4f}")
    return out


def _km(pkg, lines):
    return [pkg.KeyMessage(None, ln) for ln in lines]


def _hp(cfg):
    return {"max-split-candidates": 32,
            "max-depth": cfg.get_int("oryx.rdf.hyperparams.max-depth", 8),
            "impurity": "entropy"}


def _wait_ready(base: str, timeout: float = 30.0) -> None:
    deadline = time.time() + timeout
    status = None
    while time.time() < deadline:
        status, _ = _http("GET", f"{base}/ready")
        if status == 200:
            return
        time.sleep(0.05)
    raise AssertionError(f"/ready answered {status}")


def _start_serving(pkg, cfg, manager, update_topic: str, art) -> object:
    bus = cfg.get_string("oryx.update-topic.broker")
    for key in ("input", "update"):
        pkg.broker.topics.maybe_create(
            bus, cfg.get_string(f"oryx.{key}-topic.message.topic"), 1)
    pkg.broker.get_broker(bus).send(update_topic, "MODEL", art.to_string())
    layer = pkg.ServingLayer(cfg, model_manager=manager)
    layer.start()
    _wait_ready(f"http://127.0.0.1:{layer.port}")
    return layer


# ---------------------------------------------------------------------------
# tests/test_kmeans_app.py's contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["SILHOUETTE", "DAVIES_BOULDIN", "DUNN", "SSE"])
def test_kmeans_build_and_eval_strategies(pkg, strategy):
    data = _km(pkg, _blob_lines())
    upd = pkg.KMeansUpdate(_km_cfg(pkg, **{"oryx.kmeans.evaluation-strategy": strategy}))
    art = upd.build_model(data, {"k": 2})
    assert art.tensors["centers"].shape == (2, 2)
    assert sorted(art.content["counts"]) == [40, 40]
    ev = upd.evaluate(art, data, [])
    assert np.isfinite(ev)
    if strategy == "SILHOUETTE":
        assert ev > 0.8
    if strategy in ("DAVIES_BOULDIN", "SSE"):
        assert ev < 0


def test_kmeans_speed_manager_shifts_centroids(pkg):
    cfg = _km_cfg(pkg)
    art = pkg.KMeansUpdate(cfg).build_model(_km(pkg, _blob_lines()), {"k": 2})
    mgr = pkg.KMeansSpeed(cfg)
    assert mgr.build_updates(_km(pkg, ["0,0"])) == []  # no model yet
    mgr.consume_key_message("MODEL", art.to_string())
    ups = mgr.build_updates(_km(pkg, ["2.0,2.0"] * 10))
    assert len(ups) == 1
    key, msg = ups[0]
    cid, center, count = json.loads(msg)
    assert key == "UP" and count == 50 and 0.3 < center[0] < 0.6
    mgr.consume_key_message("UP", msg)  # hearing our own updates: ignored


def test_kmeans_serving_model_applies_updates(pkg):
    cfg = _km_cfg(pkg)
    art = pkg.KMeansUpdate(cfg).build_model(_km(pkg, _blob_lines()), {"k": 2})
    mgr = pkg.KMeansServing(cfg)
    mgr.consume_key_message("UP", json.dumps([0, [1.0, 1.0], 5]))  # pre-model: noop
    mgr.consume_key_message("MODEL", art.to_string())
    model = mgr.get_model()
    cid0, d0 = model.closest_cluster(model.vectorize("0.1,0.1"))
    cid1, d1 = model.closest_cluster(model.vectorize("9.9,10.1"))
    assert cid0 != cid1 and d0 < 1 and d1 < 1
    mgr.consume_key_message("UP", json.dumps([cid0, [5.0, 5.0], 99]))
    _, d_after = model.closest_cluster(model.vectorize("5.0,5.0"))
    assert d_after < 1e-6
    assert model.counts[cid0] == 99


def test_clustering_rest_surface_and_console():
    pkg = PORT
    cfg = _km_cfg(pkg)
    art = pkg.KMeansUpdate(cfg).build_model(_km(pkg, _blob_lines()), {"k": 2})
    layer = _start_serving(pkg, cfg, pkg.KMeansServing(cfg), "OryxUpdate", art)
    try:
        base = f"http://127.0.0.1:{layer.port}"
        s, one = _http("GET", f"{base}/assign/0.1,0.2")
        assert s == 200
        s, other = _http("GET", f"{base}/assign/9.9,10.0")
        assert s == 200 and json.loads(one) != json.loads(other)
        s, body = _http("POST", f"{base}/assign", b"0.0,0.0\n10.0,10.0\n")
        assert s == 200 and len(json.loads(body)) == 2
        s, body = _http("GET", f"{base}/distanceToNearest/0.0,0.0")
        assert s == 200 and float(json.loads(body)) < 1.0
        assert _http("GET", f"{base}/assign/not-a-number,1")[0] == 400
        assert _http("GET", f"{base}/assign/1")[0] == 400  # wrong arity
        assert _http("POST", f"{base}/add/3.0,4.0")[0] == 200
        assert _http("POST", f"{base}/add", b"5.0,6.0\n7.0,8.0\n")[0] == 200
        recs = pkg.broker.get_broker("mem://kmt").read("OryxInput", 0, 0, 10)
        assert {m for _, _, m in recs} >= {"3.0,4.0", "5.0,6.0", "7.0,8.0"}
        s, html = _http("GET", f"{base}/console")
        assert s == 200 and "Clustering model" in html and "clusters" in html
    finally:
        layer.close()


# ---------------------------------------------------------------------------
# tests/test_rdf_app.py's contracts
# ---------------------------------------------------------------------------

def test_rdf_classification_build_and_evaluate(pkg):
    cfg = _rdf_cfg(pkg)
    upd = pkg.RDFUpdate(cfg)
    art = upd.build_model(_km(pkg, _cls_lines()), _hp(cfg))
    assert art.content["numTrees"] == 8
    assert set(art.content["encodings"]["1"]) == {"red", "green", "blue"}
    assert upd.evaluate(art, [], _km(pkg, _cls_lines(200, seed=7))) > 0.9


def test_rdf_regression_build_and_evaluate(pkg):
    cfg = _reg_cfg(pkg)
    upd = pkg.RDFUpdate(cfg)
    art = upd.build_model(_km(pkg, _reg_lines()), _hp(cfg))
    assert -upd.evaluate(art, [], _km(pkg, _reg_lines(200, seed=9))) < 0.5


def test_rdf_speed_manager_emits_terminal_node_stats(pkg):
    cfg = _rdf_cfg(pkg)
    art = pkg.RDFUpdate(cfg).build_model(_km(pkg, _cls_lines()), _hp(cfg))
    mgr = pkg.RDFSpeed(cfg)
    assert mgr.build_updates(_km(pkg, ["0.9,red,apple"])) == []  # no model
    mgr.consume_key_message("MODEL", art.to_string())
    ups = mgr.build_updates(_km(pkg, ["0.9,red,apple"] * 5))
    assert len(ups) == 8  # one terminal node per tree
    for key, u in ups:
        tree, node_id, counts = json.loads(u)
        assert key == "UP" and 0 <= tree < 8
        assert node_id.startswith("r") and set(node_id[1:]) <= {"-", "+"}
        assert sum(counts.values()) == 5
    mgr.consume_key_message("UP", ups[0][1])


def test_rdf_serving_applies_leaf_updates(pkg):
    cfg = _rdf_cfg(pkg)
    art = pkg.RDFUpdate(cfg).build_model(_km(pkg, _cls_lines()), _hp(cfg))
    mgr = pkg.RDFServing(cfg)
    mgr.consume_key_message("UP", json.dumps([0, "r", {"0": 1}]))  # pre-model noop
    mgr.consume_key_message("MODEL", art.to_string())
    model = mgr.get_model()
    value, probs = model.predict("0.9,red,")
    assert value == "apple" and probs is not None
    speed = pkg.RDFSpeed(cfg)
    speed.consume_key_message("MODEL", art.to_string())
    for _, u in speed.build_updates(_km(pkg, ["0.9,red,banana"] * 500)):
        mgr.consume_key_message("UP", u)
    assert model.predict("0.9,red,")[0] == "banana"
    dist = model.classification_distribution("0.9,red,")
    assert dist["banana"] > dist["apple"]


def test_classreg_rest_surface_and_console():
    pkg = PORT
    cfg = _rdf_cfg(pkg)
    art = pkg.RDFUpdate(cfg).build_model(_km(pkg, _cls_lines()), _hp(cfg))
    layer = _start_serving(pkg, cfg, pkg.RDFServing(cfg), "OryxUpdate", art)
    try:
        base = f"http://127.0.0.1:{layer.port}"
        s, body = _http("GET", f"{base}/predict/0.9,red,")
        assert s == 200 and json.loads(body) in ("apple", "banana")
        s, body = _http("POST", f"{base}/predict", b"0.9,red,\n0.1,red,\n")
        assert s == 200 and len(json.loads(body)) == 2
        s, body = _http("GET", f"{base}/classificationDistribution/0.9,red,")
        assert s == 200
        assert abs(sum(dict(json.loads(body)).values()) - 1.0) < 1e-5
        s, body = _http("GET", f"{base}/feature/importance")
        assert s == 200 and len(json.loads(body)) == 2
        assert _http("GET", f"{base}/feature/importance/0")[0] == 200
        assert _http("GET", f"{base}/feature/importance/9")[0] == 400
        assert _http("POST", f"{base}/train/0.5,blue,apple")[0] == 200
        recs = pkg.broker.get_broker("mem://rdft").read("OryxInput", 0, 0, 10)
        assert any(m == "0.5,blue,apple" for _, _, m in recs)
        s, html = _http("GET", f"{base}/console")
        assert s == 200 and "label" in html and "classification" in html
        assert "importance: " in html and "error" not in html
    finally:
        layer.close()


# ---------------------------------------------------------------------------
# the lambda slices (tests/test_e2e_kmeans.py, tests/test_e2e_rdf.py)
# ---------------------------------------------------------------------------

def _e2e_cfg(pkg, tmp_path, name, app, schema):
    overlay = {
        "oryx.id": name,
        "oryx.input-topic.broker": f"mem://{name}",
        "oryx.update-topic.broker": f"mem://{name}",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.monitoring.quarantine.dir": str(tmp_path / "quarantine"),
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.api.port": 0,
        "oryx.serving.application-resources": _pkg_resources(pkg, app),
        "oryx.ml.eval.test-fraction": 0.2,
        "oryx.serving.min-model-load-fraction": 1.0,
        "oryx.speed.min-model-load-fraction": 0.8,
        "oryx.speed.streaming.generation-interval-sec": 1,
    }
    overlay.update(schema)
    pkg.broker.topics.maybe_create(f"mem://{name}", "OryxInput", partitions=2)
    pkg.broker.topics.maybe_create(f"mem://{name}", "OryxUpdate", partitions=1)
    return pkg.load_config(overlay=overlay)


def _batch_generation(pkg, cfg, update, n_lines: int) -> None:
    batch = pkg.layers.BatchLayer(cfg, update=update)
    batch.ensure_streams()
    batch._consumer._fetch_pos = {p: 0 for p in batch._consumer._fetch_pos}
    try:
        assert batch.run_generation(timestamp_ms=1_700_000_000_000) == n_lines
    finally:
        batch.close()


def test_full_kmeans_slice(tmp_path):
    pkg = PORT
    cfg = _e2e_cfg(pkg, tmp_path, "e2ekm", "clustering", {
        "oryx.input-schema.num-features": 2,
        "oryx.input-schema.numeric-features": ["0", "1"],
        "oryx.kmeans.hyperparams.k": 2,
        "oryx.kmeans.iterations": 10,
    })
    broker = pkg.broker.get_broker("mem://e2ekm")
    serving = pkg.ServingLayer(cfg, model_manager=pkg.KMeansServing(cfg))
    serving.start()
    speed = None
    try:
        base = f"http://127.0.0.1:{serving.port}"
        assert _http("GET", f"{base}/ready")[0] == 503
        lines = _blob_lines()
        assert _http("POST", f"{base}/ingest", body="\n".join(lines).encode())[0] == 200
        _batch_generation(pkg, cfg, pkg.KMeansUpdate(cfg), len(lines))
        assert broker.read("OryxUpdate", 0, 0, 5)[0][1] == "MODEL"
        _wait_ready(base)
        s0, a0 = _http("GET", f"{base}/assign/0.1,0.1")
        s1, a1 = _http("GET", f"{base}/assign/9.9,10.1")
        assert s0 == s1 == 200 and json.loads(a0) != json.loads(a1)
        s, d = _http("GET", f"{base}/distanceToNearest/0.1,0.1")
        assert s == 200 and float(json.loads(d)) < 1.0
        s, d_before = _http("GET", f"{base}/distanceToNearest/12.0,12.0")
        d_before = float(json.loads(d_before))

        speed = pkg.layers.SpeedLayer(cfg, manager=pkg.KMeansSpeed(cfg))
        speed.start()
        deadline = time.time() + 30
        while speed.manager._model is None and time.time() < deadline:
            time.sleep(0.05)
        assert speed.manager._model is not None
        before = speed.batch_count
        for _ in range(30):
            assert _http("POST", f"{base}/add/12.0,12.0")[0] == 200
        deadline = time.time() + 30
        d_after = d_before
        while time.time() < deadline:
            s, resp = _http("GET", f"{base}/distanceToNearest/12.0,12.0")
            d_after = float(json.loads(resp))
            if speed.batch_count > before and d_after < d_before - 0.05:
                break
            time.sleep(0.1)
        assert d_after < d_before - 0.05, (d_before, d_after)
    finally:
        if speed is not None:
            speed.close()
        serving.close()


def test_full_rdf_slice(tmp_path):
    pkg = PORT
    cfg = _e2e_cfg(pkg, tmp_path, "e2erdf", "classreg", {
        "oryx.input-schema.feature-names": ["size", "color", "label"],
        "oryx.input-schema.numeric-features": ["size"],
        "oryx.input-schema.target-feature": "label",
        "oryx.rdf.num-trees": 8,
        "oryx.rdf.hyperparams.max-depth": 5,
    })
    broker = pkg.broker.get_broker("mem://e2erdf")
    serving = pkg.ServingLayer(cfg, model_manager=pkg.RDFServing(cfg))
    serving.start()
    speed = None
    try:
        base = f"http://127.0.0.1:{serving.port}"
        assert _http("GET", f"{base}/ready")[0] == 503
        lines = _cls_lines()
        assert _http("POST", f"{base}/ingest", body="\n".join(lines).encode())[0] == 200
        _batch_generation(pkg, cfg, pkg.RDFUpdate(cfg), len(lines))
        assert broker.read("OryxUpdate", 0, 0, 5)[0][1] == "MODEL"
        _wait_ready(base)
        for datum, want in (("0.9,green", "banana"), ("0.9,red", "apple"),
                            ("0.1,red", "banana"), ("0.1,blue", "apple")):
            s, resp = _http("GET", f"{base}/predict/{datum}")
            assert s == 200 and json.loads(resp) == want, (datum, resp)
        s, resp = _http("GET", f"{base}/classificationDistribution/0.9,green")
        dist = dict(json.loads(resp))
        assert abs(sum(dist.values()) - 1.0) < 1e-6
        assert dist.get("banana", 0) > dist.get("apple", 0)
        assert _http("GET", f"{base}/feature/importance/9")[0] == 400
        assert _http("GET", f"{base}/nothere")[0] == 404

        speed = pkg.layers.SpeedLayer(cfg, manager=pkg.RDFSpeed(cfg))
        speed.start()
        deadline = time.time() + 30
        while speed.manager.model is None and time.time() < deadline:
            time.sleep(0.05)
        assert speed.manager.model is not None
        model = serving.model_manager.get_model()
        leaf_total = model.rdf.forest.class_counts.sum()
        before = speed.batch_count
        train = "\n".join(_cls_lines(n=100, seed=9)).encode()
        assert _http("POST", f"{base}/train", body=train)[0] == 200
        deadline = time.time() + 30
        while time.time() < deadline:
            if (speed.batch_count > before
                    and model.rdf.forest.class_counts.sum() > leaf_total):
                break
            time.sleep(0.05)
        # every tree folds each of the 100 examples into one leaf
        assert model.rdf.forest.class_counts.sum() == leaf_total + 8 * 100
        s, resp = _http("GET", f"{base}/predict/0.9,green")
        assert s == 200 and json.loads(resp) == "banana"
    finally:
        if speed is not None:
            speed.close()
        serving.close()


# ---------------------------------------------------------------------------
# weights carried across: the JAX package's artifacts, the port's tiers
# ---------------------------------------------------------------------------

def _side_by_side(cfg_fn, manager_fn, art_jax, paths):
    """A JAX ServingLayer and the port's load the same JAX-built artifact
    from their own mem:// update topics; -> [(path, jax answer, port
    answer)], each answer (status, parsed JSON body)."""
    layers, out = [], []
    try:
        for p in (JAX, PORT):
            cfg = cfg_fn(p, name=f"side-{p.root}")
            layers.append(_start_serving(p, cfg, manager_fn(p)(cfg), "OryxUpdate", art_jax))
        for path in paths:
            got = []
            for layer in layers:
                s, body = _http("GET", f"http://127.0.0.1:{layer.port}{path}")
                got.append((s, json.loads(body) if s == 200 else None))
            out.append((path, got[0], got[1]))
    finally:
        for layer in layers:
            layer.close()
    return out


def test_jax_kmeans_artifact_served_alike():
    rng = np.random.default_rng(21)
    lines = _blob_lines(3) + [f"{x:.3f},{y:.3f}" for x, y in rng.uniform(-2, 12, (40, 2))]
    cfg = _km_cfg(JAX, **{"oryx.kmeans.hyperparams.k": 3})
    art = JAX.KMeansUpdate(cfg).build_model(_km(JAX, lines), {"k": 3})
    probes = [f"{x:.3f},{y:.3f}" for x, y in rng.uniform(-3, 13, (40, 2))]
    centers = np.asarray(art.tensors["centers"], np.float64)
    answers = _side_by_side(
        _km_cfg, lambda p: p.KMeansServing, art,
        [f"/assign/{d}" for d in probes] + [f"/distanceToNearest/{d}" for d in probes])
    for path, (sj, bj), (sp, bp) in answers:
        assert sj == sp == 200, path
        if path.startswith("/assign/"):
            assert bj == bp, path
        else:
            x = np.asarray(path.rsplit("/", 1)[1].split(","), np.float64)
            scale = (x * x).sum() + (centers * centers).sum(1).max()
            assert abs(float(bj) ** 2 - float(bp) ** 2) <= 1e-5 * scale, path


def test_jax_rdf_artifact_served_alike():
    rng = np.random.default_rng(22)
    cfg = _rdf_cfg(JAX)
    art = JAX.RDFUpdate(cfg).build_model(_km(JAX, _cls_lines()), _hp(cfg))
    probes = [f"{s:.3f},{c}," for s, c in zip(
        rng.random(40), rng.choice(["red", "green", "blue", "purple"], 40))]
    answers = _side_by_side(
        _rdf_cfg, lambda p: p.RDFServing, art,
        [f"/predict/{d}" for d in probes]
        + [f"/classificationDistribution/{d}" for d in probes]
        + ["/feature/importance"])
    for path, (sj, bj), (sp, bp) in answers:
        assert sj == sp == 200, path
        if path.startswith("/classificationDistribution/"):
            dj, dp = dict(bj), dict(bp)
            assert dj.keys() == dp.keys()
            for k in dj:
                assert abs(dj[k] - dp[k]) <= 1e-6, path
        else:
            assert bj == bp, path


def test_both_speed_managers_publish_alike():
    """The same JAX-built models and micro-batch windows through both
    packages' speed managers: the same UP rows."""
    km_cfg = {p.root: _km_cfg(p) for p in (JAX, PORT)}
    art = JAX.KMeansUpdate(km_cfg["oryx_tpu"]).build_model(_km(JAX, _blob_lines()), {"k": 2})
    rng = np.random.default_rng(5)
    window = [f"{x:.3f},{y:.3f}" for x, y in rng.uniform(-1, 11, (60, 2))]
    rows = []
    for p in (JAX, PORT):
        mgr = p.KMeansSpeed(km_cfg[p.root])
        mgr.consume_key_message("MODEL", art.to_string())
        rows.append([(k, json.loads(m)) for k, m in mgr.build_updates(_km(p, window))])
    assert len(rows[0]) == len(rows[1]) > 0
    for (kj, mj), (kp, mp) in zip(*rows):
        assert kj == kp == "UP" and mj[0] == mp[0] and mj[2] == mp[2]
        np.testing.assert_allclose(mp[1], mj[1], rtol=0, atol=1e-9)

    rdf_cfg = {p.root: _rdf_cfg(p) for p in (JAX, PORT)}
    jcfg = rdf_cfg["oryx_tpu"]
    art = JAX.RDFUpdate(jcfg).build_model(_km(JAX, _cls_lines()), _hp(jcfg))
    window = _cls_lines(n=150, seed=4)
    rows = []
    for p in (JAX, PORT):
        mgr = p.RDFSpeed(rdf_cfg[p.root])
        mgr.consume_key_message("MODEL", art.to_string())
        rows.append(mgr.build_updates(_km(p, window)))
    assert rows[0] == rows[1] and len(rows[0]) > 0


def test_port_artifacts_load_in_the_jax_package():
    """And the other way round: what the port's batch tier publishes, the
    JAX package's serving managers load and answer alike."""
    cfg = _km_cfg(PORT)
    art = PORT.KMeansUpdate(cfg).build_model(_km(PORT, _blob_lines()), {"k": 2})
    jm = JAX.KMeansServing(_km_cfg(JAX))
    jm.consume_key_message("MODEL", art.to_string())
    pm = PORT.KMeansServing(cfg)
    pm.consume_key_message("MODEL", art.to_string())
    for d in ("0.1,0.1", "9.9,10.1", "5,5"):
        a = jm.get_model().closest_cluster(jm.get_model().vectorize(d))
        b = pm.get_model().closest_cluster(pm.get_model().vectorize(d))
        assert a[0] == b[0] and b[1] == pytest.approx(a[1], rel=1e-5, abs=1e-3)
    rcfg = _rdf_cfg(PORT)
    art = PORT.RDFUpdate(rcfg).build_model(_km(PORT, _cls_lines()), _hp(rcfg))
    jr = JAX.RDFServing(_rdf_cfg(JAX))
    jr.consume_key_message("MODEL", art.to_string())
    pr = PORT.RDFServing(rcfg)
    pr.consume_key_message("MODEL", art.to_string())
    for d in ("0.9,red,", "0.1,green,", "0.6,blue,"):
        (lj, pj), (lp, pp) = jr.get_model().predict(d), pr.get_model().predict(d)
        assert lj == lp
        np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the registry and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["kmeans", "rdf"])
def test_spi_registers_the_app(app):
    from oryx_tpu_torch.apps import spi
    from oryx_tpu_torch.common.classutil import load_class

    spec = spi.get_app(app)
    overlay = spi.app_overlay(app)
    assert overlay["oryx.batch.update-class"] == spec.batch_update
    for dotted in (spec.batch_update, spec.speed_manager, spec.serving_manager):
        assert dotted.startswith("oryx_tpu_torch.")
        load_class(dotted)
    for mod in spec.serving_resources:
        assert hasattr(importlib.import_module(mod), "register")
    cfg = PORT.load_config(overlay={**overlay, **spec.example_overlay})
    kw = {"device": "cpu"}
    for dotted in (spec.batch_update, spec.speed_manager, spec.serving_manager):
        load_class(dotted)(cfg, **kw)


@pytest.mark.parametrize("app", ["kmeans", "rdf"])
def test_app_classes_from_config_resolve_cuda(app, monkeypatch):
    """Built from config alone (as the layers and the CLI build them) each
    class resolves the card, and raises where there is none."""
    import torch

    from oryx_tpu_torch.apps import spi
    from oryx_tpu_torch.common.classutil import load_class

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = spi.get_app(app)
    cfg = PORT.load_config(overlay={**spi.app_overlay(app), **spec.example_overlay})
    for dotted in (spec.batch_update, spec.speed_manager, spec.serving_manager):
        with pytest.raises(RuntimeError, match="CUDA"):
            load_class(dotted)(cfg)


def test_cli_app_overlay_names_the_port_classes(monkeypatch):
    from oryx_tpu_torch import cli

    seen = {}
    monkeypatch.setattr(cli, "cmd_serving", lambda config, *_: seen.setdefault("cfg", config) and 0)
    for app, manager in (("kmeans", "KMeansServingModelManager"),
                         ("rdf", "RDFServingModelManager")):
        seen.clear()
        cli.main(["serving", "--app", app])
        assert seen["cfg"].get_string("oryx.serving.model-manager-class").endswith(manager)
