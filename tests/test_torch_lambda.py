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
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
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



def _same_quality_profile(jm: dict, pm: dict) -> None:
    """Both artifacts carry the training profile (common/qualitystats.py),
    alike but for the predicted-score statistics, which come from each
    package's own factors (trained in another order: 1e-3 relative); then
    the profiles are taken out of both for the byte comparison."""
    jp = json.loads(jm["extensions"].pop("qualityProfile"))
    pp = json.loads(pm["extensions"].pop("qualityProfile"))
    for key in ("score_mean", "score_std"):
        assert pp.pop(key) == pytest.approx(jp.pop(key), rel=1e-3)
    assert pp == jp

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
    # the skeleton: app, extensions (ids, hyperparameters, the training
    # profile of the quality plane)
    _same_quality_profile(jm, pm)
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


# ---- the two packages' speed managers side by side -----------------------------

def _speed_artifact(tmp_path, implicit: bool, k: int = 6) -> str:
    from oryx_tpu.common.artifact import ModelArtifact

    rng = np.random.default_rng(11)
    n_u, n_i = 50, 40
    art = ModelArtifact("als", content={}, tensors={
        "X": rng.standard_normal((n_u, k)).astype(np.float32),
        "Y": rng.standard_normal((n_i, k)).astype(np.float32),
    })
    art.set_extension("features", str(k))
    art.set_extension("implicit", "true" if implicit else "false")
    art.set_extension("XIDs", [f"u{j}" for j in range(n_u)])
    art.set_extension("YIDs", [f"i{j}" for j in range(n_i)])
    path = tmp_path / f"speed-model-{implicit}"
    art.write(path)
    return str(path)


def _speed_events(n=300):
    """Events on known users and items, and on users and items the model
    has never seen (u-new*, i-new*), with repeats and a delete."""
    rng = np.random.default_rng(12)
    lines = []
    for j in range(n):
        u = f"u{rng.integers(0, 50)}" if rng.random() < 0.85 else \
            f"u-new{rng.integers(0, 8)}"
        i = f"i{rng.integers(0, 40)}" if rng.random() < 0.85 else \
            f"i-new{rng.integers(0, 8)}"
        v = "" if j % 97 == 5 else str(1 + int(rng.integers(0, 5)))
        lines.append(f"{u},{i},{v},{1_700_000_000_000 + j}")
    return lines


@pytest.mark.parametrize("implicit", [True, False])
def test_jax_and_port_speed_updates_alike(tmp_path, implicit):
    """ALSSpeedModelManager.build_updates in both packages on the same
    artifact and the same 300 events (unseen users and items included):
    the same keys, ids and known lists, and vectors within the UP codec's
    six-decimal rounding on top of 1e-4 relative to the row's largest
    entry (f32 fold-in solves summed in another order)."""
    from oryx_tpu.apps.als.speed import ALSSpeedModelManager as JaxSpeed
    from oryx_tpu.bus.api import KeyMessage as JaxKeyMessage
    from oryx_tpu.common.config import load_config as jax_load_config
    from oryx_tpu_torch.bus.api import KeyMessage

    path = _speed_artifact(tmp_path, implicit)
    overlay = dict(app_overlay("als"))
    overlay["oryx.als.implicit"] = implicit
    jm = JaxSpeed(jax_load_config(overlay=overlay))
    pm = ALSSpeedModelManager(load_config(overlay=overlay), device="cpu")
    jm.consume_key_message("MODEL-REF", path)
    pm.consume_key_message("MODEL-REF", path)
    lines = _speed_events()
    jout = list(jm.build_updates([JaxKeyMessage(None, ln) for ln in lines]))
    pout = list(pm.build_updates([KeyMessage(None, ln) for ln in lines]))
    assert len(pout) == len(jout) > 100
    assert [k for k, _ in pout] == [k for k, _ in jout] == ["UP"] * len(jout)
    jrows = [json.loads(m) for _, m in jout]
    prows = [json.loads(m) for _, m in pout]
    assert [(r[0], r[1], r[3:]) for r in prows] == [
        (r[0], r[1], r[3:]) for r in jrows]
    # unseen users and items got folded in, as in the JAX package
    assert any(r[1].startswith("u-new") for r in prows)
    assert any(r[1].startswith("i-new") for r in prows)
    for p, j in zip(prows, jrows):
        pv, jv = np.asarray(p[2]), np.asarray(j[2])
        assert np.abs(pv - jv).max() <= 1e-4 * np.abs(jv).max() + 1e-6, (p, j)


# ---- a second, incremental generation side by side ----------------------------

@pytest.mark.parametrize("implicit", [True, False])
def test_jax_and_port_second_generation_publish_alike(tmp_path, monkeypatch,
                                                      implicit):
    """Generation 2 in a fresh batch layer in each package: the merged
    aggregate snapshot, the warm start from the newest model dir, and
    train_als_warm's early stop. Both start generation 1 from the same Y,
    and generation 2's warm start sees the same previous factors in both
    (the JAX package's generation-1 Y, new items from one numpy init), so
    the published generation must agree: ids, extensions and known items
    exactly, the sweeps run equal, factors within the side-by-side
    tolerance above."""
    import oryx_tpu.apps.als.batch as jax_batch
    import oryx_tpu_torch.apps.als.batch as port_batch
    from oryx_tpu.bus.broker import get_broker as jax_get_broker
    from oryx_tpu.bus.broker import topics as jax_topics
    from oryx_tpu.bus.inproc import InProcBroker as JaxInProc
    from oryx_tpu.common.config import load_config as jax_load_config
    from oryx_tpu.common.metrics import get_registry as jax_registry
    from oryx_tpu.common.rng import RandomManager as JaxRandom
    from oryx_tpu.layers import BatchLayer as JaxBatchLayer
    from oryx_tpu_torch.common.metrics import get_registry

    k = 6
    overlay = {
        "oryx.id": "side2", "oryx.input-topic.broker": "mem://side2",
        "oryx.update-topic.broker": "mem://side2",
        "oryx.als.hyperparams.features": k,
        "oryx.als.hyperparams.iterations": 8,
        "oryx.als.hyperparams.lambda": 0.05,
        "oryx.als.implicit": implicit,
        "oryx.ml.eval.test-fraction": 0.1,
        "oryx.batch.train.tol": 0.05,
    }
    first = _genre_events(n_users=60, n_items=40, per_user=8)
    rng = np.random.default_rng(5)
    second = [f"u{rng.integers(0, 60)},i{rng.integers(0, 40)},"
              f"{1 + int(rng.integers(0, 3))},{900_000 + j}"
              for j in range(60)]
    second += [f"u-new{j % 4},i-new{j % 3},2,{990_000 + j}" for j in range(12)]
    shared_prev, aligned = {}, []

    def same_warm_start(module):
        real = module.align_factors

        def align(prev_ids, prev_mat, new_ids, features, *a, **kw):
            aligned.append(module.__name__)
            if not shared_prev:  # the JAX package runs first
                shared_prev.update(zip(prev_ids, np.asarray(prev_mat)))
            init = np.random.default_rng(23)
            rows = [shared_prev[i] if i in shared_prev else
                    (init.standard_normal(features) * 0.1
                     + 1 / np.sqrt(features)) for i in new_ids]
            out = real(prev_ids, prev_mat, new_ids, features, *a, **kw)
            assert out is not None and out.shape == (len(new_ids), features)
            return np.asarray(rows, dtype=np.float32)

        monkeypatch.setattr(module, "align_factors", align)

    published, sweeps, deltas = {}, {}, {}
    JaxInProc.reset_all()
    for name, load, topic_admin, broker_of, layer_cls, update, module, reg in (
        ("jax", jax_load_config, jax_topics, jax_get_broker, JaxBatchLayer,
         lambda c: jax_batch.ALSUpdate(c), jax_batch, jax_registry),
        ("port", load_config, topics, get_broker, BatchLayer,
         lambda c: port_batch.ALSUpdate(c, device="cpu"), port_batch,
         get_registry),
    ):
        JaxRandom.use_test_seed(1)
        RandomManager.use_test_seed(1)
        cfg = load(overlay={
            **overlay,
            "oryx.batch.storage.data-dir": str(tmp_path / name / "data"),
            "oryx.batch.storage.model-dir": str(tmp_path / name / "model"),
        })
        topic_admin.maybe_create("mem://side2", "OryxInput", 1)
        topic_admin.maybe_create("mem://side2", "OryxUpdate", 1)
        _same_start(module, monkeypatch, k)
        same_warm_start(module)
        broker = broker_of("mem://side2")
        c_delta = reg().counter("oryx_batch_incremental_total")
        before = c_delta.value(kind="delta")
        for gen, (lines, ts) in enumerate(((first, 1_700_000_000_000),
                                           (second, 1_700_000_600_000))):
            layer = layer_cls(cfg, update=update(cfg))  # a fresh layer
            layer.ensure_streams()
            start = broker.read("OryxUpdate", 0, 0, 100_000)
            for line in lines:
                broker.send("OryxInput", None, line)
            layer.run_generation(timestamp_ms=ts)
            layer.close()
        deltas[name] = c_delta.value(kind="delta") - before
        sweeps[name] = reg().gauge("oryx_batch_warm_iterations").value()
        published[name] = broker.read("OryxUpdate", 0, 0, 100_000)[len(start):]
    JaxInProc.reset_all()

    assert deltas == {"jax": 1, "port": 1}  # generation 2 took the delta path
    # generation 1 cold-starts (no previous factors); generation 2 aligns
    assert aligned.count(jax_batch.__name__) >= 1
    assert aligned.count(port_batch.__name__) >= 1
    assert sweeps["port"] == sweeps["jax"] >= 2
    jax_recs, port_recs = published["jax"], published["port"]
    assert [r[1] for r in port_recs] == [r[1] for r in jax_recs]
    (jm,), (pm,) = ([json.loads(m) for _, key, m in recs if key == "MODEL"]
                    for recs in (jax_recs, port_recs))
    _same_quality_profile(jm, pm)
    assert pm == jm
    jup = [json.loads(m) for _, key, m in jax_recs if key == "UP"]
    pup = [json.loads(m) for _, key, m in port_recs if key == "UP"]
    assert len(pup) == len(jup) > 0
    for a, b in zip(pup, jup):
        assert a[0] == b[0] and a[1] == b[1] and a[3:] == b[3:]
    assert any(r[1] == "i-new0" for r in pup)
    for kind in ("X", "Y"):
        pa = np.asarray([r[2] for r in pup if r[0] == kind])
        ja = np.asarray([r[2] for r in jup if r[0] == kind])
        np.testing.assert_allclose(pa, ja, rtol=1e-3,
                                   atol=1e-3 * np.abs(ja).max())
