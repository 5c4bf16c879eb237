"""The bus's copied modules, held to the same cases in both packages: the
mem:// and file:// brokers, the producer and the blocking consumer (with
its lag), the bounded retry and the fault harness around them. A file://
topic is shared across packages both ways, which shows that the two
write and read one wire format (filelog.encode_record)."""

from __future__ import annotations

import importlib
import threading
import time

import pytest

PKGS = ("oryx_tpu", "oryx_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def _broker(pkg, uri):
    return mod(pkg, "bus.broker").get_broker(uri)


def _uri(pkg, scheme, tmp_path, name):
    return (f"mem://bus-{pkg}-{name}" if scheme == "mem"
            else f"file://{tmp_path / name}")


@pytest.mark.parametrize("scheme", ["mem", "file"])
def test_produce_and_consume_from_earliest(pkg, scheme, tmp_path):
    api = mod(pkg, "bus.api")
    b = _broker(pkg, _uri(pkg, scheme, tmp_path, "earliest"))
    b.create_topic("T", 2)
    prod = api.TopicProducer(b, "T")
    for j in range(6):
        prod.send(f"k{j}", f"m{j}")
    prod.send_batch([(None, "n0"), ("k1", "n1")])
    with api.ConsumeDataIterator(b, "T", group="g", start="earliest") as it:
        got = it.poll_available()
    assert sorted(km.message for km in got) == sorted(
        [f"m{j}" for j in range(6)] + ["n0", "n1"])
    assert all(isinstance(km, api.KeyMessage) for km in got)
    assert it.lag() == 0


@pytest.mark.parametrize("scheme", ["mem", "file"])
def test_latest_committed_and_lag(pkg, scheme, tmp_path):
    api = mod(pkg, "bus.api")
    b = _broker(pkg, _uri(pkg, scheme, tmp_path, "committed"))
    b.create_topic("T", 1)
    prod = api.TopicProducer(b, "T")
    prod.send(None, "old")
    latest = api.ConsumeDataIterator(b, "T", group="g", start="latest")
    prod.send(None, "a")
    prod.send(None, "b")
    assert latest.lag() == 2
    assert next(latest).message == "a"
    latest.commit()
    resumed = api.ConsumeDataIterator(b, "T", group="g", start="committed")
    assert [km.message for km in resumed.poll_available()] == ["b"]
    assert b.end_offsets("T") == [3]


def test_blocking_iteration_wakes_on_close(pkg):
    api = mod(pkg, "bus.api")
    b = _broker(pkg, f"mem://bus-{pkg}-blocking")
    b.create_topic("T", 1)
    it = api.ConsumeDataIterator(b, "T", start="earliest")
    seen = []

    def consume():
        for km in it:
            seen.append(km.message)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    api.TopicProducer(b, "T").send("MODEL", "x")
    deadline = time.monotonic() + 30
    while not seen and time.monotonic() < deadline:
        time.sleep(0.01)
    it.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen == ["x"]


def test_topic_admin(pkg, tmp_path):
    broker = mod(pkg, "bus.broker")
    uri = f"file://{tmp_path / 'admin'}"
    assert not broker.topics.exists(uri, "T")
    broker.topics.maybe_create(uri, "T", 3)
    broker.topics.maybe_create(uri, "T", 3)  # a second create is a no-op
    assert broker.get_broker(uri).num_partitions("T") == 3
    broker.topics.delete(uri, "T")
    assert not broker.topics.exists(uri, "T")


@pytest.mark.parametrize("writer,reader", [
    ("oryx_tpu", "oryx_tpu_torch"), ("oryx_tpu_torch", "oryx_tpu")])
def test_file_topic_is_shared_across_packages(writer, reader, tmp_path):
    uri = f"file://{tmp_path / 'shared'}"
    wb = _broker(writer, uri)
    wb.create_topic("OryxUpdate", 1)
    records = [("MODEL-REF", "/models/0001"), ("UP", '["Y", "i1", [0.5]]'),
               (None, "ü, utf-8 & a null key")]
    mod(writer, "bus.api").TopicProducer(wb, "OryxUpdate").send_batch(records)
    rb = _broker(reader, uri)
    it = mod(reader, "bus.api").ConsumeDataIterator(
        rb, "OryxUpdate", start="earliest")
    assert [(km.key, km.message) for km in it.poll_available()] == records
    # one wire format: the same records encode to the same bytes
    for key, msg in records:
        assert (mod("oryx_tpu", "bus.filelog").encode_record(key, msg)
                == mod("oryx_tpu_torch", "bus.filelog").encode_record(key, msg))
    log = (tmp_path / "shared" / "OryxUpdate" / "p0.log").read_bytes()
    enc = mod(reader, "bus.filelog").encode_record
    assert log == b"".join(enc(k, m) for k, m in records)


def test_port_refuses_kafka():
    """The port resolves kafka:// to its own client (one per cluster URI,
    no connection made until first use) and refuses a kafka:// URI it
    cannot parse."""
    broker = mod("oryx_tpu_torch", "bus.broker")
    kafka = mod("oryx_tpu_torch", "bus.kafka")
    b = broker.get_broker("kafka://localhost:9092,localhost:9093")
    assert isinstance(b, kafka.KafkaBroker)
    assert b._bootstrap == [("localhost", 9092), ("localhost", 9093)]
    assert broker.get_broker("kafka://localhost:9092,localhost:9093") is b
    with pytest.raises(ValueError):
        broker.get_broker("kafka://localhost:not-a-port")


def test_oversized_message_is_refused(pkg, tmp_path):
    b = _broker(pkg, f"file://{tmp_path / 'big'}")
    b.create_topic("T", 1, max_message_bytes=16)
    with pytest.raises(ValueError):
        b.send("T", None, "x" * 17)


# -- retry and fault injection around the bus ----------------------------------

def test_retry_absorbs_transient_failures(pkg):
    retry = mod(pkg, "common.retry")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    policy = retry.RetryPolicy(attempts=4, base_s=0.001, max_s=0.002)
    assert retry.retry_call("t.site", flaky, policy=policy) == "ok"
    assert len(calls) == 3
    with pytest.raises(ValueError):  # not transient: no retry
        retry.retry_call("t.site", lambda: (_ for _ in ()).throw(
            ValueError("bad")), policy=policy)


def test_injected_produce_faults_are_retried(pkg):
    api = mod(pkg, "bus.api")
    faults = mod(pkg, "common.faults")
    retry = mod(pkg, "common.retry")
    config = mod(pkg, "common.config")
    b = _broker(pkg, f"mem://bus-{pkg}-faults")
    b.create_topic("T", 1)
    retry.configure_retry(config.load_config(overlay={
        "oryx.monitoring.retry.base-ms": 1}))
    inj = faults.get_injector()
    try:
        spec = inj.arm("bus.produce", kind="error", count=2)
        api.TopicProducer(b, "T").send(None, "survives")
        assert spec.fired == 2
        assert [r[2] for r in b.read("T", 0, 0, 10)] == ["survives"]
        inj.arm("bus.produce", kind="error", count=-1)
        with pytest.raises(faults.InjectedFault):
            api.TopicProducer(b, "T").send(None, "lost")
    finally:
        inj.disarm()
        retry.configure_retry(config.load_config())


def test_trace_stamps_feed_freshness_and_never_reach_the_handler(pkg):
    """A MODEL followed by its TRACE publish stamp on the update topic:
    the handler sees the model only, and the freshness tracker adopts the
    stamp's generation (api.py _dispatch_update)."""
    import json
    import time

    api = mod(pkg, "api")
    freshness = mod(pkg, "common.freshness")
    seen = []
    km = mod(pkg, "bus.api").KeyMessage
    stamp = json.dumps({"published_ms": int(time.time() * 1000) - 5000,
                        "generation": 4242})
    api._dispatch_update(lambda k, m: seen.append((k, m)), km("MODEL", "{}"))
    api._dispatch_update(lambda k, m: seen.append((k, m)), km("TRACE", stamp))
    assert seen == [("MODEL", "{}")]
    f = freshness.model_freshness()
    assert f.generation == 4242
    assert f._staleness() >= 5.0
