"""The whole lambda loop in the port, on the CPU: batch -> update topic ->
serving answers HTTP -> speed folds new events -> serving applies them,
over mem:// (a mirror of tests/test_e2e_als.py's full slices, implicit
and explicit, with the port's layers and ALS classes on
``device="cpu"``); and the JAX and the port ``ALSUpdate`` side by side on
the same input records, both trainers started from the same Y.

Side-by-side tolerance: the published factors within the ``train_als``
tolerance of tests/test_torch_als_train.py (rtol 1e-3 in f32 over the
configured sweeps); ids, extensions and known items exactly.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from e2e_common import http_request as _http
from oryx_tpu_torch.apps.als.batch import ALSUpdate
from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
from oryx_tpu_torch.apps.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.apps.spi import app_overlay
from oryx_tpu_torch.bus.broker import get_broker, topics
from oryx_tpu_torch.bus.inproc import InProcBroker
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.layers import BatchLayer, SpeedLayer
from oryx_tpu_torch.serving.server import ServingLayer


@pytest.fixture(autouse=True)
def _fresh_registry():
    InProcBroker.reset_all()
    yield
    InProcBroker.reset_all()


def _make_config(tmp_path, **extra):
    overlay = dict(app_overlay("als"))
    overlay.update({
        "oryx.id": "e2e",
        "oryx.input-topic.broker": "mem://e2e",
        "oryx.update-topic.broker": "mem://e2e",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.monitoring.quarantine.dir": str(tmp_path / "quarantine"),
        "oryx.serving.api.port": 0,
        "oryx.als.hyperparams.features": 8,
        "oryx.als.hyperparams.iterations": 6,
        "oryx.als.hyperparams.alpha": 10.0,
        "oryx.als.hyperparams.lambda": 0.01,
        "oryx.ml.eval.test-fraction": 0.1,
        "oryx.speed.min-model-load-fraction": 0.8,
        "oryx.serving.min-model-load-fraction": 1.0,
    })
    overlay.update(extra)
    return load_config(overlay=overlay)


def _genre_events(n_users=40, n_items=32, per_user=6, groups=4, seed=3):
    rng = np.random.default_rng(seed)
    lines = []
    for u in range(n_users):
        g = u % groups
        items = rng.choice(np.arange(g, n_items, groups), per_user, replace=False)
        for ts, i in enumerate(items):
            lines.append(f"u{u},i{i},{1 + int(rng.poisson(1))},{1000 + ts * 1000 + u}")
    return lines


def _wait_ready(base):
    deadline = time.time() + 30
    status = None
    while time.time() < deadline:
        status, _ = _http("GET", f"{base}/ready")
        if status == 200:
            break
        time.sleep(0.1)
    assert status == 200, "serving never became ready"


def _serving(cfg):
    layer = ServingLayer(cfg, model_manager=ALSServingModelManager(cfg, device="cpu"))
    layer.start()
    return layer, f"http://127.0.0.1:{layer.port}"


def _one_generation(cfg, n_lines):
    batch = BatchLayer(cfg, update=ALSUpdate(cfg, device="cpu"))
    batch.ensure_streams()
    # the events were sent before the batch consumer existed: read them
    # from the start of the topic
    batch._consumer._fetch_pos = {p: 0 for p in batch._consumer._fetch_pos}
    assert batch.run_generation(timestamp_ms=1_700_000_000_000) == n_lines
    batch.close()


def test_full_lambda_slice(tmp_path):
    RandomManager.use_test_seed(99)
    cfg = _make_config(tmp_path)
    topics.maybe_create("mem://e2e", "OryxInput", partitions=2)
    topics.maybe_create("mem://e2e", "OryxUpdate", partitions=1)
    broker = get_broker("mem://e2e")
    serving, base = _serving(cfg)
    try:
        status, _ = _http("GET", f"{base}/ready")
        assert status == 503
        lines = _genre_events()
        status, resp = _http("POST", f"{base}/ingest", body="\n".join(lines).encode())
        assert status == 200 and json.loads(resp)["ingested"] == len(lines)

        _one_generation(cfg, len(lines))
        recs = broker.read("OryxUpdate", 0, 0, 10)
        assert recs[0][1] == "MODEL"
        _wait_ready(base)

        status, resp = _http("GET", f"{base}/console")
        assert status == 200 and "ALS model" in resp and "features" in resp
        status, resp = _http("GET", f"{base}/recommend/u5?howMany=5")
        assert status == 200, resp
        recs5 = json.loads(resp)
        assert len(recs5) == 5
        genres = [int(r[0][1:]) % 4 for r in recs5]
        assert genres[0] == 1 and genres[1] == 1, recs5
        status, resp = _http("GET", f"{base}/knownItems/u5")
        known = set(json.loads(resp))
        assert status == 200 and known
        assert not (known & {r[0] for r in recs5})
        some_known = sorted(known)[0]
        status, resp = _http("GET", f"{base}/estimate/u5/{some_known}")
        assert status == 200 and json.loads(resp)[0][1] > 0
        status, resp = _http("GET", f"{base}/similarity/{some_known}?howMany=3")
        assert status == 200 and len(json.loads(resp)) == 3
        status, resp = _http("GET", f"{base}/recommendToAnonymous/{some_known}=2?howMany=4")
        assert status == 200 and len(json.loads(resp)) == 4
        status, resp = _http("GET", f"{base}/recommend/u5?howMany=2", accept="text/csv")
        assert status == 200 and len(resp.strip().splitlines()) == 2 and "," in resp
        status, _ = _http("GET", f"{base}/recommend/nobody")
        assert status == 404

        speed = SpeedLayer(cfg, manager=ALSSpeedModelManager(cfg, device="cpu"))
        speed.start()
        try:
            deadline = time.time() + 30
            while time.time() < deadline:
                st = speed.manager.state
                if st is not None and st.fraction_loaded() >= 0.8:
                    break
                time.sleep(0.1)
            assert speed.manager.state is not None
            for item in ("i2", "i6"):
                status, _ = _http("POST", f"{base}/pref/newuser/{item}", body=b"3.0")
                assert status == 200
            deadline = time.time() + 30
            got = None
            while time.time() < deadline:
                status, resp = _http("GET", f"{base}/recommend/newuser?howMany=4")
                if status == 200:
                    got = json.loads(resp)
                    break
                time.sleep(0.2)
            assert got is not None, "speed fold-in never reached serving"
            genres = [int(r[0][1:]) % 4 for r in got]
            assert sum(g == 2 for g in genres) >= 2, got
        finally:
            speed.close()
    finally:
        serving.close()


def test_full_lambda_slice_explicit(tmp_path):
    RandomManager.use_test_seed(21)
    cfg = _make_config(tmp_path, **{
        "oryx.als.implicit": False, "oryx.als.hyperparams.lambda": 0.02})
    topics.maybe_create("mem://e2e", "OryxInput", partitions=1)
    topics.maybe_create("mem://e2e", "OryxUpdate", partitions=1)
    serving, base = _serving(cfg)
    try:
        rng = np.random.default_rng(4)
        lines, ts = [], 0
        for u in range(24):
            g = u % 3
            for i in range(18):
                if rng.random() < 0.7:
                    ts += 1
                    lines.append(f"u{u},i{i},{5.0 if i % 3 == g else 1.0},{1000 + ts}")
        status, resp = _http("POST", f"{base}/ingest", body="\n".join(lines).encode())
        assert status == 200, resp
        _one_generation(cfg, len(lines))
        _wait_ready(base)
        status, resp = _http("GET", f"{base}/estimate/u4/i1/i0")
        assert status == 200, resp
        est = dict(json.loads(resp))
        assert est["i1"] > est["i0"] + 1.0, est
        status, resp = _http("GET", f"{base}/recommend/u4?howMany=3")
        assert status == 200
        assert int(json.loads(resp)[0][0][1:]) % 3 == 1
    finally:
        serving.close()


# ---- the two packages' ALSUpdate side by side ----------------------------------

def _same_start(module, monkeypatch, k):
    """Hand the package's trainer a Y drawn from numpy, the same in both
    packages (their own random streams differ)."""
    real = module.train_als

    def train_als(data, **kw):
        kw["resume_y"] = (np.random.default_rng(17).standard_normal(
            (data.n_items, k)) * 0.1 + 1 / np.sqrt(k)).astype(np.float32)
        return real(data, **kw)

    monkeypatch.setattr(module, "train_als", train_als)


@pytest.mark.parametrize("implicit", [True, False])
def test_jax_and_port_batch_updates_publish_alike(tmp_path, monkeypatch, implicit):
    import oryx_tpu.apps.als.batch as jax_batch
    import oryx_tpu_torch.apps.als.batch as port_batch
    from oryx_tpu.bus.broker import get_broker as jax_get_broker
    from oryx_tpu.bus.broker import topics as jax_topics
    from oryx_tpu.bus.inproc import InProcBroker as JaxInProc
    from oryx_tpu.common.config import load_config as jax_load_config
    from oryx_tpu.common.rng import RandomManager as JaxRandom
    from oryx_tpu.layers import BatchLayer as JaxBatchLayer

    k = 6
    overlay = {
        "oryx.id": "side", "oryx.input-topic.broker": "mem://side",
        "oryx.update-topic.broker": "mem://side",
        "oryx.als.hyperparams.features": k,
        "oryx.als.hyperparams.iterations": 4,
        "oryx.als.hyperparams.lambda": 0.05,
        "oryx.als.implicit": implicit,
        "oryx.ml.eval.test-fraction": 0.1,
    }
    lines = _genre_events(n_users=60, n_items=40, per_user=8)
    published = {}
    JaxInProc.reset_all()
    for name, load, topic_admin, broker_of, layer_cls, update, module in (
        ("jax", jax_load_config, jax_topics, jax_get_broker, JaxBatchLayer,
         lambda c: jax_batch.ALSUpdate(c), jax_batch),
        ("port", load_config, topics, get_broker, BatchLayer,
         lambda c: port_batch.ALSUpdate(c, device="cpu"), port_batch),
    ):
        JaxRandom.use_test_seed(1)
        RandomManager.use_test_seed(1)
        cfg = load(overlay={
            **overlay,
            "oryx.batch.storage.data-dir": str(tmp_path / name / "data"),
            "oryx.batch.storage.model-dir": str(tmp_path / name / "model"),
        })
        topic_admin.maybe_create("mem://side", "OryxInput", 1)
        topic_admin.maybe_create("mem://side", "OryxUpdate", 1)
        _same_start(module, monkeypatch, k)
        layer = layer_cls(cfg, update=update(cfg))
        layer.ensure_streams()
        broker = broker_of("mem://side")
        for line in lines:
            broker.send("OryxInput", None, line)
        layer.run_generation(timestamp_ms=1_700_000_000_000)
        layer.close()
        published[name] = broker.read("OryxUpdate", 0, 0, 100_000)
    JaxInProc.reset_all()

    jax_recs, port_recs = published["jax"], published["port"]
    assert [r[1] for r in port_recs] == [r[1] for r in jax_recs]
    (jm,), (pm,) = ([json.loads(m) for _, key, m in recs if key == "MODEL"]
                    for recs in (jax_recs, port_recs))
    # the skeleton: app, extensions (ids, hyperparameters); the port stamps
    # no training profile (the quality plane is not ported)
    assert "qualityProfile" not in pm["extensions"]
    jm["extensions"].pop("qualityProfile", None)
    assert pm == jm
    jup = [json.loads(m) for _, key, m in jax_recs if key == "UP"]
    pup = [json.loads(m) for _, key, m in port_recs if key == "UP"]
    assert len(pup) == len(jup) > 0
    for a, b in zip(pup, jup):
        assert a[0] == b[0] and a[1] == b[1] and a[3:] == b[3:]  # ids, known
    for kind in ("X", "Y"):
        pa = np.asarray([r[2] for r in pup if r[0] == kind])
        ja = np.asarray([r[2] for r in jup if r[0] == kind])
        np.testing.assert_allclose(pa, ja, rtol=1e-3, atol=1e-3 * np.abs(ja).max())
