"""The wordcount example app in the port (apps/example, the /distinct and
/add routes), held to tests/test_example_app.py: the co-occurrence count,
the speed manager's deltas, and the whole slice through real layers
loaded from config by class name; then both packages on the same lines:
the same published MODEL, the same speed UP rows, the same answers.
Exact throughout (the app is host code on strings and integers).
"""

from __future__ import annotations

import importlib
import json
import time

import pytest

from e2e_common import http_request as _http
from oryx_tpu_torch.apps.example.batch import (
    ExampleBatchLayerUpdate,
    count_distinct_other_words,
)
from oryx_tpu_torch.apps.example.speed import ExampleSpeedModelManager
from oryx_tpu_torch.apps.spi import app_overlay
from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.bus.broker import get_broker, topics
from oryx_tpu_torch.bus.inproc import InProcBroker
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.ioutil import choose_free_port
from oryx_tpu_torch.layers import BatchLayer, SpeedLayer
from oryx_tpu_torch.serving.server import ServingLayer

LINES = ["cat dog", "cat fish", "dog bird fish", "solo", "a b c a", "ü é ü"]


@pytest.fixture(autouse=True)
def _fresh():
    InProcBroker.reset_all()
    importlib.import_module("oryx_tpu.bus.inproc").InProcBroker.reset_all()
    yield
    InProcBroker.reset_all()


def _cfg(tmp_path, port=0, root="oryx_tpu_torch", bus="mem://wc"):
    spi = importlib.import_module(f"{root}.apps.spi")
    overlay = dict(spi.app_overlay("example"))
    overlay.update({
        "oryx.id": "wc",
        "oryx.input-topic.broker": bus,
        "oryx.update-topic.broker": bus,
        "oryx.batch.storage.data-dir": str(tmp_path / root / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / root / "model"),
        "oryx.monitoring.flight.dir": str(tmp_path / root / "flight"),
        "oryx.serving.api.port": port,
    })
    return importlib.import_module(f"{root}.common.config").load_config(overlay=overlay)


def test_count_distinct_other_words():
    assert count_distinct_other_words(["a b c", "a b", "a a"]) == {"a": 2, "b": 2, "c": 2}
    assert count_distinct_other_words(["solo"]) == {}


def test_speed_manager_accumulates_deltas():
    mgr = ExampleSpeedModelManager()
    mgr.consume_key_message("MODEL", json.dumps({"a": 5}))
    assert set(mgr.build_updates([KeyMessage(None, "a b")])) == {("UP", "a,6"), ("UP", "b,1")}
    mgr.consume_key_message("UP", "a,6")  # ignored
    assert set(mgr.build_updates([KeyMessage(None, "a c")])) == {("UP", "a,7"), ("UP", "c,1")}


def _wait_status(url, want=200, limit=20):
    deadline = time.time() + limit
    while time.time() < deadline:
        status, body = _http("GET", url)
        if status == want:
            return body
        time.sleep(0.1)
    raise AssertionError(f"{url} never answered {want}")


def test_wordcount_end_to_end(tmp_path):
    port = choose_free_port()
    cfg = _cfg(tmp_path, port)
    assert cfg.get_string("oryx.batch.update-class") == (
        "oryx_tpu_torch.apps.example.batch.ExampleBatchLayerUpdate")
    topics.maybe_create("mem://wc", "OryxInput", 1)
    topics.maybe_create("mem://wc", "OryxUpdate", 1)
    broker = get_broker("mem://wc")
    serving = ServingLayer(cfg)  # manager loaded from config by class name
    serving.start()
    base = f"http://127.0.0.1:{port}"
    try:
        status, _ = _http("POST", f"{base}/add", b"cat dog\ncat fish\n")
        assert status == 200
        batch = BatchLayer(cfg)
        assert isinstance(batch.update, ExampleBatchLayerUpdate)
        batch.ensure_streams()
        batch._consumer._fetch_pos = {p: 0 for p in batch._consumer._fetch_pos}
        assert batch.run_generation(timestamp_ms=1_700_000_000_000) == 2
        batch.close()
        recs = broker.read("OryxUpdate", 0, 0, 10)
        assert recs and recs[0][1] == "MODEL"
        assert json.loads(recs[0][2]) == {"cat": 2, "dog": 1, "fish": 1}

        assert json.loads(_wait_status(f"{base}/distinct/cat")) == 2
        status, body = _http("GET", f"{base}/distinct")
        assert status == 200 and json.loads(body) == {"cat": 2, "dog": 1, "fish": 1}
        assert _http("GET", f"{base}/distinct/nope")[0] == 400

        speed = SpeedLayer(cfg)
        speed.ensure_streams()
        speed.start()
        try:
            deadline = time.time() + 20
            while time.time() < deadline and not speed.manager._words:
                time.sleep(0.1)
            assert speed.manager._words.get("cat") == 2
            ups = speed.manager.build_updates([KeyMessage(None, "cat bird")])
            assert set(ups) == {("UP", "cat,3"), ("UP", "bird,1")}
            for key, u in ups:
                broker.send("OryxUpdate", key, u)
            assert json.loads(_wait_status(f"{base}/distinct/bird")) == 1
        finally:
            speed.close()
    finally:
        serving.close()


def test_both_packages_publish_the_same_model(tmp_path):
    """The same lines through each package's batch layer give the same
    MODEL JSON, and each speed manager then emits the same UP rows."""
    models, ups = {}, {}
    for root in ("oryx_tpu", "oryx_tpu_torch"):
        bus = f"mem://wc-{root}"
        broker = importlib.import_module(f"{root}.bus.broker")
        broker.topics.maybe_create(bus, "OryxInput", 2)
        broker.topics.maybe_create(bus, "OryxUpdate", 1)
        cfg = _cfg(tmp_path, root=root, bus=bus)
        layers = importlib.import_module(f"{root}.layers")
        batch = layers.BatchLayer(cfg)
        batch.ensure_streams()
        api = importlib.import_module(f"{root}.bus.api")
        api.TopicProducer(broker.get_broker(bus), "OryxInput").send_batch(
            (None, ln) for ln in LINES)
        assert batch.run_generation(timestamp_ms=1_700_000_000_000) == len(LINES)
        batch.close()
        [(_, key, msg)] = broker.get_broker(bus).read("OryxUpdate", 0, 0, 10)
        assert key == "MODEL"
        models[root] = json.loads(msg)
        speed = importlib.import_module(f"{root}.apps.example.speed")
        mgr = speed.ExampleSpeedModelManager()
        mgr.consume_key_message("MODEL", msg)
        ups[root] = sorted(mgr.build_updates(
            [api.KeyMessage(None, "cat ü new"), api.KeyMessage("k", "dog solo")]))
    assert models["oryx_tpu"] == models["oryx_tpu_torch"]
    assert models["oryx_tpu_torch"] == count_distinct_other_words(LINES)
    assert ups["oryx_tpu"] == ups["oryx_tpu_torch"]
    assert app_overlay("example")["oryx.speed.model-manager-class"].startswith(
        "oryx_tpu_torch.")
    assert load_config(overlay=app_overlay("example")).get_list(
        "oryx.serving.application-resources")[-1] == "oryx_tpu_torch.serving.resources.example"
