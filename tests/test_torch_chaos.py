"""Chaos suite: every injected fault class driven end-to-end (tier-1).

One fast scenario per fault class —
bus produce failure mid-generation, snapshot-rename crash (the
datastore-level half lives in test_datastore_crash.py), poison record,
device-transfer error, batcher overload — asserting convergence with no
lost committed records, replayable quarantined records, and no 5xx other
than deliberate 503 sheds. Plus the degraded-readiness surface: stale
model Warning + /healthz flip, wedged-layer visibility.

Port twin of tests/test_chaos.py: the same fault sites (``faults.fire``)
on port objects on the CPU. The device-transfer case asserts the port's
contract: a failed dispatch fails its group, and no host path runs.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from oryx_tpu_torch.api import AbstractSpeedModelManager
from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.bus.broker import get_broker, topics
from oryx_tpu_torch.bus.inproc import InProcBroker
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.faults import get_injector
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.quarantine import load_quarantined, quarantine_files
from oryx_tpu_torch.layers.speed import SpeedLayer


@pytest.fixture(autouse=True)
def _fresh():
    InProcBroker.reset_all()
    get_injector().disarm()
    yield
    get_injector().disarm()
    InProcBroker.reset_all()


def _cfg(tmp_path, name, **extra):
    overlay = {
        "oryx.id": name,
        "oryx.input-topic.broker": f"mem://{name}",
        "oryx.update-topic.broker": f"mem://{name}",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.batch.streaming.generation-interval-sec": 1,
        "oryx.speed.streaming.generation-interval-sec": 1,
        "oryx.monitoring.quarantine.dir": str(tmp_path / "quarantine"),
        "oryx.monitoring.retry.base-ms": 1,
        "oryx.monitoring.retry.max-ms": 5,
    }
    overlay.update(extra)
    cfg = load_config(overlay=overlay)
    topics.maybe_create(
        f"mem://{name}", cfg.get_string("oryx.input-topic.message.topic"), 2
    )
    topics.maybe_create(
        f"mem://{name}", cfg.get_string("oryx.update-topic.message.topic"), 1
    )
    return cfg


class _EchoManager(AbstractSpeedModelManager):
    """Speed manager that emits one UP per record; raises on 'poison'."""

    def __init__(self):
        self.builds = 0

    def consume_key_message(self, key, message):
        pass

    def build_updates(self, new_data):
        self.builds += 1
        for km in new_data:
            if km.message == "poison":
                raise ValueError("poison record broke the fold-in")
        return [("UP", km.message) for km in new_data]


def _update_messages(name, cfg):
    broker = get_broker(f"mem://{name}")
    topic = cfg.get_string("oryx.update-topic.message.topic")
    out = []
    for p in range(broker.num_partitions(topic)):
        out.extend(m for _, _, m in broker.read(topic, p, 0, 10_000))
    return out


# ---- fault class 1: bus produce failure mid-generation --------------------

def test_bus_produce_failure_recovers_with_no_loss(tmp_path):
    """Two injected produce failures mid-micro-batch: the bounded retry
    absorbs them, every update lands on the topic exactly once, the
    window commits, and the rewind path never fires."""
    cfg = _cfg(tmp_path, "chaos-bus")
    layer = SpeedLayer(cfg, manager=_EchoManager())
    layer.ensure_streams()
    broker = get_broker("mem://chaos-bus")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    for i in range(5):
        broker.send(in_topic, None, f"rec-{i}")
    failures_before = layer._m_failures.value()
    retries = get_registry().counter("oryx_retry_total")
    r0 = retries.value(site="bus.produce", outcome="recovered")

    get_injector().arm("bus.produce", kind="error", count=2)
    assert layer.run_batch() == 5

    ups = [m for m in _update_messages("chaos-bus", cfg)]
    assert sorted(ups) == [f"rec-{i}" for i in range(5)]
    assert layer._m_failures.value() == failures_before  # no rewind
    assert retries.value(site="bus.produce", outcome="recovered") == r0 + 1
    # committed: a rerun sees nothing new
    assert layer.run_batch() == 0
    layer.close()


# ---- fault class 2: window-persist / snapshot-rename faults ---------------

def test_batch_generation_survives_datastore_save_fault(tmp_path):
    """The batch tier's half of the crash class: an injected transient
    failure during window persist is absorbed by the retry, the window
    lands in history, and offsets commit — zero lost committed records.
    (The kill-between-stage-and-rename half is test_datastore_crash.py.)"""
    from oryx_tpu_torch.api import BatchLayerUpdate
    from oryx_tpu_torch.layers.batch import BatchLayer
    from oryx_tpu_torch.layers.datastore import load_all_data

    class Recording(BatchLayerUpdate):
        def __init__(self):
            self.calls = []

        def run_update(self, ts, new_data, past_data, model_dir, producer):
            self.calls.append((len(new_data), len(past_data)))

    cfg = _cfg(tmp_path, "chaos-ds")
    layer = BatchLayer(cfg, update=Recording())
    layer.ensure_streams()
    broker = get_broker("mem://chaos-ds")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    for i in range(3):
        broker.send(in_topic, None, f"w-{i}")

    get_injector().arm("datastore.save_window", kind="error", count=1)
    assert layer.run_generation(timestamp_ms=1000) == 3
    assert sorted(
        km.message for km in load_all_data(str(tmp_path / "data"))
    ) == ["w-0", "w-1", "w-2"]
    # committed: the next generation re-reads nothing
    assert layer.run_generation(timestamp_ms=2000) == 0
    layer.close()


# ---- fault class 3: poison record -----------------------------------------

def test_poison_record_quarantined_and_stream_converges(tmp_path):
    """A record that deterministically breaks the speed build: the window
    rewinds its bounded max-attempts, then the bisect isolates exactly
    the poison record into the dead-letter store, the survivors' updates
    publish, the stream commits past the window, and the dead letter
    replays byte-identical."""
    cfg = _cfg(tmp_path, "chaos-poison",
               **{"oryx.monitoring.quarantine.max-attempts": 1})
    mgr = _EchoManager()
    layer = SpeedLayer(cfg, manager=mgr)
    layer.ensure_streams()
    broker = get_broker("mem://chaos-poison")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    for m in ("good-a", "poison", "good-b"):
        broker.send(in_topic, m, m)  # keyed: spread across partitions

    # attempt 1: fails, rewinds (the bounded-retry window)
    assert layer.run_batch() == 3
    assert layer._m_failures.value() >= 1
    assert quarantine_files(str(tmp_path / "quarantine")) == []
    # attempt 2: retries exhausted -> bisect isolates, quarantines, commits
    assert layer.run_batch() == 3
    files = quarantine_files(str(tmp_path / "quarantine"), "speed")
    assert len(files) == 1
    dead = load_quarantined(files[0])
    assert [km.message for km in dead] == ["poison"]
    assert dead[0].key == "poison"  # replayable with its key intact
    ups = _update_messages("chaos-poison", cfg)
    assert sorted(ups) == ["good-a", "good-b"]
    q = get_registry().counter("oryx_quarantined_records_total")
    assert q.value(layer="speed") >= 1

    # converged: stream moves on, later windows process normally
    broker.send(in_topic, None, "good-c")
    assert layer.run_batch() == 1
    assert "good-c" in _update_messages("chaos-poison", cfg)
    layer.close()


def test_malformed_record_diverted_before_build(tmp_path):
    """Deserialize-poison: the ALS speed manager's validate_record sweeps
    unparseable lines into the dead-letter store BEFORE the build — they
    are counted and replayable instead of silently skipped."""
    from oryx_tpu_torch.apps.als.speed import ALSSpeedModelManager

    cfg = _cfg(tmp_path, "chaos-parse")
    layer = SpeedLayer(cfg, manager=ALSSpeedModelManager(cfg, device="cpu"))
    layer.ensure_streams()
    broker = get_broker("mem://chaos-parse")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    broker.send(in_topic, None, "u1,i1,3.0")       # valid
    broker.send(in_topic, None, "singletoken")     # unparseable: no item
    broker.send(in_topic, None, "u2,i2,notafloat")  # unparseable strength
    # returns records PROCESSED (the diverted two don't count as processed)
    assert layer.run_batch() == 1
    files = quarantine_files(str(tmp_path / "quarantine"), "speed")
    assert len(files) == 1
    assert sorted(km.message for km in load_quarantined(files[0])) == [
        "singletoken", "u2,i2,notafloat",
    ]
    assert layer.run_batch() == 0  # committed past the whole window
    layer.close()


def test_batch_tier_malformed_record_never_enters_history(tmp_path):
    """The batch half: a quarantined record must not reach persisted
    history, where every later from-scratch rebuild would re-read it."""
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.layers.batch import BatchLayer
    from oryx_tpu_torch.layers.datastore import load_all_data

    cfg = _cfg(tmp_path, "chaos-bparse", **{
        "oryx.als.hyperparams.features": 2,
        "oryx.als.hyperparams.iterations": 1,
        "oryx.ml.eval.test-fraction": 0.0,
    })
    layer = BatchLayer(cfg, update=ALSUpdate(cfg, device="cpu"))
    layer.ensure_streams()
    broker = get_broker("mem://chaos-bparse")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    for m in ("u1,i1,1", "garbage-no-comma", "u2,i2,2"):
        broker.send(in_topic, None, m)
    layer.run_generation(timestamp_ms=1000)
    persisted = [km.message for km in load_all_data(str(tmp_path / "data"))]
    assert sorted(persisted) == ["u1,i1,1", "u2,i2,2"]
    files = quarantine_files(str(tmp_path / "quarantine"), "batch")
    assert len(files) == 1
    assert [km.message for km in load_quarantined(files[0])] == [
        "garbage-no-comma"
    ]
    layer.close()


def test_mixed_invalid_and_poison_window_no_duplicate_dead_letters(tmp_path):
    """Regression: invalid records divert on the COMMIT path
    only — a window that also holds build-poison rewinds first, and each
    rewind must NOT write a fresh dead-letter copy of the same invalid
    record."""

    class Picky(_EchoManager):
        def validate_record(self, km):
            return km.message != "unparseable"

    cfg = _cfg(tmp_path, "chaos-mixed",
               **{"oryx.monitoring.quarantine.max-attempts": 1})
    layer = SpeedLayer(cfg, manager=Picky())
    layer.ensure_streams()
    broker = get_broker("mem://chaos-mixed")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    for m in ("good-a", "unparseable", "poison"):
        broker.send(in_topic, m, m)
    layer.run_batch()  # attempt 1: build fails, rewinds — no divert yet
    assert quarantine_files(str(tmp_path / "quarantine")) == []
    layer.run_batch()  # attempt 2: isolate + divert both, commit
    dead = [
        km.message
        for f in quarantine_files(str(tmp_path / "quarantine"), "speed")
        for km in load_quarantined(f)
    ]
    assert sorted(dead) == ["poison", "unparseable"]  # exactly once each
    assert "good-a" in _update_messages("chaos-mixed", cfg)
    assert layer.run_batch() == 0  # converged
    layer.close()


def test_environmental_outage_is_not_bulk_quarantined(tmp_path):
    """Regression: when EVERY record of a multi-record window
    fails in isolation (an outage, not poison), the bisect must refuse
    to bulk-divert the window — it keeps rewinding until the environment
    heals, then processes normally with zero dead letters."""

    class Outage(_EchoManager):
        def __init__(self):
            super().__init__()
            self.down = True

        def build_updates(self, new_data):
            if self.down:
                raise RuntimeError("device unavailable")
            return super().build_updates(new_data)

    cfg = _cfg(tmp_path, "chaos-outage",
               **{"oryx.monitoring.quarantine.max-attempts": 1})
    mgr = Outage()
    layer = SpeedLayer(cfg, manager=mgr)
    layer.ensure_streams()
    broker = get_broker("mem://chaos-outage")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    for m in ("live-a", "live-b", "live-c"):
        broker.send(in_topic, m, m)
    layer.run_batch()  # fails, rewinds
    layer.run_batch()  # attempts exhausted -> bisect -> ALL fail -> rewind
    assert quarantine_files(str(tmp_path / "quarantine")) == []  # no divert
    mgr.down = False   # outage heals
    assert layer.run_batch() == 3
    assert sorted(_update_messages("chaos-outage", cfg)) == [
        "live-a", "live-b", "live-c",
    ]
    layer.close()


def test_partial_multipartition_send_batch_retry_no_duplicates(tmp_path):
    """Regression: the produce retry unit is one partition — a
    transient failure after some partitions already appended must not
    re-append them on retry."""
    from oryx_tpu_torch.bus.api import TopicProducer

    class FlakyOnce:
        """Broker wrapper: the first send_batch against partition 1
        raises AFTER partition 0's records already landed."""

        def __init__(self, inner):
            self._inner = inner
            self.failed = False

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def send_batch(self, topic, records, partition=None):
            if partition == 1 and not self.failed:
                self.failed = True
                raise OSError("transient partition-1 failure")
            self._inner.send_batch(topic, records, partition)

    broker = get_broker("mem://chaos-sendbatch")
    broker.create_topic("T", 2)
    flaky = FlakyOnce(broker)
    producer = TopicProducer(flaky, "T")
    # keys spanning both partitions
    recs = [(f"k{i}", f"m{i}") for i in range(8)]
    producer.send_batch(recs)
    assert flaky.failed  # the fault actually fired
    got = []
    for p in range(2):
        got.extend(m for _, _, m in broker.read("T", p, 0, 1000))
    assert sorted(got) == sorted(m for _, m in recs)  # exactly once each


def test_valid_event_lines_matches_per_line_validator():
    """The batched sweep (one native parse per window) must agree with
    the per-line validator on every class of line."""
    from oryx_tpu_torch.apps.als.common import valid_event_line, valid_event_lines

    lines = [
        "u1,i1,3.0",            # canonical CSV
        '["u2","i2",2,5]',      # JSON-array form (native rejects, valid)
        "u3,i3",                # no strength: valid
        "singletoken",          # invalid
        "u4,i4,notafloat",      # invalid strength
        "",                     # invalid
        "u5,i5,1.5,99",         # with timestamp
        "u6,i6,1.5,1e400",      # float-overflow ts: False, never a raise
    ]
    assert valid_event_lines(lines) == [valid_event_line(l) for l in lines]
    assert valid_event_line("u6,i6,1.5,1e400") is False


def _seq_model_message(n_items: int = 6, dim: int = 8) -> str:
    """A small loadable seq MODEL message — the ONE constructor the chaos
    CLI scenario also uses, so the test and the scenario cannot drift on
    what 'a loadable seq model' means."""
    from tools.chaos import _seq_model_message as build

    return build(n_items=n_items, dim=dim)


def test_seq_poison_quarantined_via_spi_hooks(tmp_path):
    """The containment is app-generic, proven on the fourth app with
    the REAL SeqSpeedModelManager: malformed session events are swept by
    the SPI validate_records hook into the dead-letter store on the
    commit path, a line that passes the cheap deserialize sweep but
    deterministically breaks the build (int64 timestamp overflow at
    array construction) is isolated by BISECTION, both are replayable,
    the survivors' fold-in updates publish, and the stream converges."""
    from oryx_tpu_torch.apps.seq.speed import SeqSpeedModelManager

    cfg = _cfg(tmp_path, "chaos-seq",
               **{"oryx.monitoring.quarantine.max-attempts": 1})
    mgr = SeqSpeedModelManager(cfg, device="cpu")
    mgr.consume_key_message("MODEL", _seq_model_message())
    assert mgr.state.fraction_loaded() == 1.0
    layer = SpeedLayer(cfg, manager=mgr)
    layer.ensure_streams()
    broker = get_broker("mem://chaos-seq")
    in_topic = cfg.get_string("oryx.input-topic.message.topic")

    malformed = ["u1,s0,i0", "u1,s0,,2000", "u1,s0,i1,not-a-ts"]
    poison = "u1,s9,i0,1e300"  # cheap sweep passes; int64 overflow in build
    good = ["u1,s2,i0,1000", "u1,s2,i1,1001"]
    for m in malformed + [poison] + good:
        broker.send(in_topic, m, m)

    layer.run_batch()  # attempt 1: build raises, window rewinds
    assert layer._m_failures.value() >= 1
    assert quarantine_files(str(tmp_path / "quarantine")) == []
    layer.run_batch()  # attempt 2: bisect + divert both classes + commit
    files = quarantine_files(str(tmp_path / "quarantine"), "speed")
    by_reason = {}
    for f in files:
        for km in load_quarantined(f):
            by_reason.setdefault(
                "validate" if km.message in malformed else "bisect", []
            ).append(km.message)
    assert sorted(by_reason.get("validate", [])) == sorted(malformed)
    assert by_reason.get("bisect") == [poison]
    # the survivors' transition folded: exactly one delta-sized UP row
    ups = _update_messages("chaos-seq", cfg)
    assert len(ups) == 1 and ups[0].startswith('["E",')
    # converged: a later window processes normally
    broker.send(in_topic, None, "u1,s2,i2,1002")
    assert layer.run_batch() == 1
    assert len(_update_messages("chaos-seq", cfg)) == 2
    layer.close()


def test_seq_valid_session_lines_matches_parse():
    """The seq validate hook must stay in lockstep with what
    parse_session_events would ingest, line-class by line-class."""
    from oryx_tpu_torch.apps.seq.common import (
        parse_session_events, valid_session_line, valid_session_lines,
    )

    lines = [
        "u1,s1,i1,1000",        # canonical
        '["u2","s2","i2",5]',   # JSON-array form
        "u3,s3,i3",             # missing ts: invalid
        "u4,s4,,1000",          # empty item: invalid
        "u5,s5,i5,notats",      # bad ts: invalid
        # float-overflow ts: must return False, never RAISE — a raising
        # validate hook would bypass the layers' quarantine sweep
        "u6,s6,i6,1e400",
        "",                     # invalid
    ]
    assert valid_session_lines(lines) == [valid_session_line(l) for l in lines]
    kept = [l for l in lines if valid_session_line(l)]
    users, sess, items, tss = parse_session_events(lines)
    assert len(tss) == len(kept)


# ---- fault class 4: device-transfer error ---------------------------------

def test_device_transfer_error_fails_over_to_host(tmp_path):
    """An injected device dispatch error, held to the port's contract
    (no host failover by design): the group's future fails with the
    injected error, no host path runs (no host-fallback family exists and
    the batcher has no host matrix to score), the error is not a wedge (no
    failover counted, the card is not marked down), and the device path
    serves the very next request exactly. The name is the JAX twin's."""
    import torch

    from oryx_tpu_torch.common.faults import InjectedFault
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    host = np.asarray(
        [[1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [2.0, 1.0]], dtype=np.float32
    )
    y = torch.from_numpy(host)
    vec = np.asarray([1.0, 2.0], dtype=np.float32)
    b = TopKBatcher()
    try:
        b.register_gauges()
        get_injector().arm("serving.device", kind="error", count=1)
        fut = b.submit_nowait(vec, 2, y)
        with pytest.raises(InjectedFault):
            fut.result(timeout=30)
        # no host path ran, and no wedge was declared
        assert "oryx_device_fallback_dispatches" not in \
            get_registry().render_prometheus()
        assert get_registry().gauge("oryx_topk_device_failovers").value() == 0.0
        assert not hasattr(b, "host_fallbacks")
        assert not b._device_down.is_set()  # an error, not a wedge
        # the device path serves the next request, exactly
        vals2, idx2 = b.submit(vec, 2, y)
        scores = host @ vec
        want = np.argsort(-scores, kind="stable")[:2]
        assert list(idx2) == list(want)
        np.testing.assert_allclose(vals2, scores[want], rtol=1e-6)
        assert b.device_failovers == 0
    finally:
        b.close()
        TopKBatcher.shared().register_gauges()


# ---- fault class 5: batcher overload --------------------------------------

def test_saturated_batcher_sheds_with_retry_after(tmp_path):
    """Queue at max-queue: the next submit sheds (ShedLoad -> 503 +
    Retry-After at the app boundary) instead of queueing without bound,
    and the shed counter separates it from real 5xx."""
    from oryx_tpu_torch.serving.app import ShedLoad
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    b = TopKBatcher(max_queue=1)
    b._ensure_thread = lambda: None  # freeze the dispatcher: queue only
    b._ensure_watchdog = lambda: None
    shed = get_registry().counter("oryx_serving_shed_total")
    before = shed.value()
    y = np.zeros((4, 2), dtype=np.float32)
    try:
        b.submit_nowait(np.zeros(2), 1, y)  # fills the queue
        with pytest.raises(ShedLoad) as ei:
            b.submit_nowait(np.zeros(2), 1, y)
        assert ei.value.status == 503
        assert ("Retry-After", "1") in ei.value.headers
        assert shed.value() == before + 1
    finally:
        b._closed = True


def test_shed_renders_503_with_retry_after_on_the_wire(tmp_path):
    """Full plumbing: a handler that sheds renders 503 with the
    Retry-After header over real HTTP on the async frontend."""
    import http.client

    from oryx_tpu_torch.api import ServingModelManager
    from oryx_tpu_torch.serving.app import Request, ServingApp, ShedLoad
    from oryx_tpu_torch.serving.aserver import AsyncHTTPServer

    class Manager(ServingModelManager):
        def __init__(self, config):
            self.config = config

        def consume(self, it):
            pass

        def get_model(self):
            return None

    cfg = load_config(overlay={
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common"
        ],
    })
    app = ServingApp(cfg, Manager(cfg))

    @app.route("GET", "/shedme")
    def shedme(a: ServingApp, req: Request):
        raise ShedLoad("saturated", retry_after_sec=3)

    srv = AsyncHTTPServer(app, None, 0, workers=2, loops=1)
    srv.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("GET", "/shedme")
        r = conn.getresponse()
        body = r.read()
        assert r.status == 503
        assert r.getheader("Retry-After") == "3"
        assert json.loads(body)["error"] == "saturated"
        conn.close()
    finally:
        srv.close()


# ---- degraded readiness: stale model + wedged layers ----------------------

def _freshness_backup():
    from oryx_tpu_torch.common.freshness import model_freshness

    f = model_freshness()
    return f, (f.generation, f.published_ms, f.loaded_ms)


def test_stale_model_serves_with_warning_and_flips_healthz(tmp_path):
    from oryx_tpu_torch.apps.example.serving import ExampleServingModelManager
    from oryx_tpu_torch.serving.app import Request, ServingApp

    cfg = load_config(overlay={
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common"
        ],
        "oryx.serving.api.max-staleness-sec": 5,
    })
    app = ServingApp(cfg, ExampleServingModelManager(cfg))

    @app.route("GET", "/model-backed")
    def model_backed(a: ServingApp, req: Request):
        a.get_serving_model()
        return 200, {"ok": True}

    f, saved = _freshness_backup()
    try:
        # fresh (no stamp yet): healthy, no Warning
        f.published_ms = None
        req = Request("GET", "/healthz", {}, {}, b"", {})
        status, body, _ = app.dispatch(req)
        assert status == 200 and json.loads(body)["status"] == "up"

        # model 60s past a 5s bound: degraded but still serving
        f.published_ms = time.time() * 1000 - 60_000
        req = Request("GET", "/model-backed", {}, {}, b"", {})
        status, body, _ = app.dispatch(req)
        assert status == 200  # stale answers beat no answers
        warnings = [v for k, v in req.response_headers if k == "Warning"]
        assert len(warnings) == 1 and warnings[0].startswith('110 - "stale')

        req = Request("GET", "/healthz", {}, {}, b"", {})
        status, body, _ = app.dispatch(req)
        health = json.loads(body)
        assert status == 503 and health["status"] == "degraded"
        assert "model-stale" in health["degraded"]

        # HEAD stays pure liveness even while degraded
        req = Request("HEAD", "/healthz", {}, {}, b"", {})
        status, _, _ = app.dispatch(req)
        assert status == 200
    finally:
        f.generation, f.published_ms, f.loaded_ms = saved


def test_wedged_layer_exported_as_state_and_readiness(tmp_path):
    """Satellite: the wedge watchdog exports a `wedged` flag and the
    oryx_wedged{layer} gauge, visible to wedged_layers() (and therefore
    /healthz) — then self-heals when the work completes."""
    import logging

    from oryx_tpu_torch.layers import watchdog

    class FakeLayer:
        def __init__(self):
            self._stop = threading.Event()
            self.watchdog_limit_sec = 0.05
            self.watchdog_poll_sec = 0.01
            self._busy = time.monotonic() - 10.0  # stuck for "10s" already

    layer = FakeLayer()
    t = watchdog.start_wedge_watchdog(
        layer, "_busy", "test work", logging.getLogger("test"),
        "test-watchdog", label="testlayer",
    )
    try:
        deadline = time.monotonic() + 5
        while not layer.wedged and time.monotonic() < deadline:
            time.sleep(0.01)
        assert layer.wedged
        assert "testlayer" in watchdog.wedged_layers()
        g = get_registry().gauge("oryx_wedged")
        assert g.value(layer="testlayer") == 1.0
        # work completes: the flag clears without a restart
        layer._busy = None
        deadline = time.monotonic() + 5
        while layer.wedged and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not layer.wedged
        assert "testlayer" not in watchdog.wedged_layers()
    finally:
        layer._stop.set()
        t.join(timeout=5)
        with watchdog._watched_lock:
            watchdog._watched.pop("testlayer", None)
