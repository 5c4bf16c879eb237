"""The kafka:// bus in both packages: the contract of tests/test_kafka.py
(admin, keyed produce and fetch, group offsets, the consumer, large and
unicode payloads, retention truncation, compressed foreign batches,
coordinator movement, injected errors, throttling, the system codecs, the
native CRC-32C tier) run as the same cases against the JAX package's
client on its test broker and the port's client on its copy of it
(tests/torch_kafka_testbroker.py); then each client against the OTHER
package's broker, one package's producer against the other's consumer
and layers, and the lambda slice over kafka:// with the port's ALS
classes on ``device="cpu"``. The bus is exact: every comparison is
equality.
"""

from __future__ import annotations

import gzip
import importlib
import json
import os
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest

from e2e_common import http_request as _http

PKGS = {"jax": "oryx_tpu", "port": "oryx_tpu_torch"}
_TESTBROKERS = {"oryx_tpu": "tests.kafka_testbroker",
                "oryx_tpu_torch": "tests.torch_kafka_testbroker"}


def _ns(root: str) -> SimpleNamespace:
    m = lambda rel: importlib.import_module(f"{root}.{rel}")  # noqa: E731
    return SimpleNamespace(
        root=root, api=m("bus.api"), broker=m("bus.broker"),
        kafka=m("bus.kafka"), wire=m("bus.kafkawire"), compress=m("bus.compress"),
        testbroker=importlib.import_module(_TESTBROKERS[root]),
    )


@pytest.fixture(params=list(PKGS.values()), ids=list(PKGS))
def pkg(request):
    return _ns(request.param)


@pytest.fixture
def kafka(pkg):
    with pkg.testbroker.LocalKafkaTestBroker() as server:
        broker = pkg.kafka.KafkaBroker([(server.host, server.port)])
        broker._test_server = server  # fidelity knobs for the fault tests
        yield broker
        broker.close()


# -- contract over TCP, each package's client on its own test broker ---------

def test_parse_bootstrap(pkg):
    pb = pkg.kafka.parse_bootstrap
    assert pb("kafka://h1:9092") == [("h1", 9092)]
    assert pb("kafka://h1:9092,h2:9093") == [("h1", 9092), ("h2", 9093)]
    assert pb("kafka://justhost") == [("justhost", 9092)]


def test_admin_roundtrip(kafka):
    assert not kafka.topic_exists("T")
    kafka.create_topic("T", partitions=3)
    assert kafka.topic_exists("T")
    assert kafka.num_partitions("T") == 3
    with pytest.raises(ValueError):
        kafka.create_topic("T")
    kafka.delete_topic("T")
    assert not kafka.topic_exists("T")


def test_produce_fetch_keyed_partitioning(pkg, kafka):
    kafka.create_topic("T", partitions=4)
    for i in range(40):
        kafka.send("T", f"k{i}", f"m{i}")
    seen = {}
    for p in range(4):
        for off, key, msg in kafka.read("T", p, 0, 1000):
            assert pkg.broker.partition_for(key, 4) == p
            seen[key] = (p, off, msg)
    assert len(seen) == 40
    assert seen["k7"][2] == "m7"
    ends = kafka.end_offsets("T")
    assert sum(ends) == 40
    for p in range(4):
        offs = [o for o, _, _ in kafka.read("T", p, 0, 1000)]
        assert offs == list(range(ends[p]))


def test_read_from_mid_offset_and_max_records(kafka):
    kafka.create_topic("T", partitions=1)
    kafka.send_batch("T", [(None, f"m{i}") for i in range(10)])
    recs = kafka.read("T", 0, 4, 3)
    assert [(o, m) for o, _, m in recs] == [(4, "m4"), (5, "m5"), (6, "m6")]
    assert kafka.read("T", 0, 10, 5) == []  # at end: empty, not error


def test_group_offsets(kafka):
    kafka.create_topic("T", partitions=2)
    assert kafka.get_offsets("g1", "T") == {}
    kafka.commit_offsets("g1", "T", {0: 5, 1: 7})
    assert kafka.get_offsets("g1", "T") == {0: 5, 1: 7}
    kafka.commit_offsets("g1", "T", {0: 6})
    assert kafka.get_offsets("g1", "T")[0] == 6
    assert kafka.get_offsets("g2", "T") == {}  # groups isolated


def test_consume_iterator_over_kafka(pkg, kafka):
    kafka.create_topic("T", partitions=2)
    prod = pkg.api.TopicProducer(kafka, "T")
    for i in range(6):
        prod.send(f"k{i}", f"m{i}")
    with pkg.api.ConsumeDataIterator(kafka, "T", group="g", start="earliest") as it:
        got = {next(it).message for _ in range(6)}
        assert got == {f"m{i}" for i in range(6)}
        it.commit()
    prod.send("k9", "m9")
    with pkg.api.ConsumeDataIterator(kafka, "T", group="g", start="committed") as it2:
        assert next(it2) == pkg.api.KeyMessage("k9", "m9")


def test_get_broker_resolves_and_caches_kafka_uri(pkg):
    with pkg.testbroker.LocalKafkaTestBroker() as server:
        a = pkg.broker.get_broker(server.uri)
        b = pkg.broker.get_broker(server.uri)
        assert a is b
        assert isinstance(a, pkg.kafka.KafkaBroker)
        a.create_topic("X", partitions=1)
        a.send("X", None, "hello")
        assert a.read("X", 0, 0, 10)[0][2] == "hello"


def test_large_message_roundtrip(kafka):
    kafka.create_topic("T", partitions=1, max_message_bytes=32 << 20)
    big = "x" * (5 << 20)
    kafka.send("T", "MODEL", big)
    recs = kafka.read("T", 0, 0, 1)
    assert recs[0][1] == "MODEL" and recs[0][2] == big


def test_unicode_and_empty_payloads(kafka):
    kafka.create_topic("T", partitions=1)
    kafka.send("T", "clé", "värde-☃")
    kafka.send("T", None, "")
    recs = kafka.read("T", 0, 0, 10)
    assert recs[0][1] == "clé" and recs[0][2] == "värde-☃"
    assert recs[1][1] is None and recs[1][2] == ""


def test_truncated_log_reset(pkg):
    """A consumer starting at offset 0 on a retention-truncated partition
    resumes from the earliest retained offset."""
    with pkg.testbroker.LocalKafkaTestBroker() as server:
        broker = pkg.kafka.KafkaBroker([(server.host, server.port)])
        broker.create_topic("T", partitions=1)
        broker.send_batch("T", [(None, f"a{i}") for i in range(5)])
        broker.send_batch("T", [(None, f"b{i}") for i in range(5)])
        server.truncate("T", 0, 5)
        recs = broker.read("T", 0, 0, 100)
        assert [m for _, _, m in recs] == [f"b{i}" for i in range(5)]
        assert recs[0][0] == 5  # real offsets, post-truncation
        broker.close()


def _foreign_batch(wire, records, codec: int, payload_transform) -> bytes:
    """A record batch as a FOREIGN producer builds it (tests/test_kafka.py
    _foreign_batch): compressed records payload, codec in attributes
    bits 0-2, CRC over attributes..end."""
    Writer, crc32c = wire.Writer, wire.crc32c
    body = Writer()
    for i, (key, value) in enumerate(records):
        rec = Writer()
        rec.i8(0)
        rec.varint(i * 17)
        rec.varint(i)
        if key is None:
            rec.varint(-1)
        else:
            rec.varint(len(key)).raw(key)
        rec.varint(len(value)).raw(value)
        rec.varint(0)
        rb = rec.done()
        body.varint(len(rb)).raw(rb)
    payload = payload_transform(body.done())
    crced = (
        Writer()
        .i16(codec)
        .i32(len(records) - 1)
        .i64(1_700_000_000_000)
        .i64(1_700_000_000_000 + (len(records) - 1) * 17)
        .i64(-1).i16(-1).i32(-1)
        .i32(len(records))
        .raw(payload)
        .done()
    )
    after_len = Writer().i32(-1).i8(2).u32(crc32c(crced)).raw(crced).done()
    return Writer().i64(0).i32(len(after_len)).raw(after_len).done()


def _snappy_compress_literals(data: bytes) -> bytes:
    """Minimal VALID snappy: uvarint length + literal-only elements."""
    out = bytearray()
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 60]
        out.append((len(chunk) - 1) << 2)
        out += chunk
        pos += len(chunk)
    return bytes(out)


def _xerial(data: bytes) -> bytes:
    blk = _snappy_compress_literals(data)
    return (b"\x82SNAPPY\x00" + struct.pack(">ii", 1, 1)
            + struct.pack(">i", len(blk)) + blk)


def _codec(pkg, name):
    """(codec id, compressor) of a foreign producer; lz4 and zstd through
    the canonical system libraries."""
    return {
        "gzip": (1, gzip.compress),
        "snappy_raw": (2, _snappy_compress_literals),
        "snappy_xerial": (2, _xerial),
        "lz4": (3, pkg.compress.lz4f_compress),
        "zstd": (4, pkg.compress.zstd_compress),
    }[name]


@pytest.mark.parametrize(
    "codec_name", ["gzip", "snappy_raw", "snappy_xerial", "lz4", "zstd"]
)
def test_compressed_foreign_batches_decode(pkg, kafka, codec_name):
    topic = "FOREIGN-" + codec_name
    kafka.create_topic(topic, 1)
    recs = [(b"k0", b"v0"), (None, "vé".encode()), (b"k2", b"x" * 500)]
    codec, compress = _codec(pkg, codec_name)
    try:
        batch = _foreign_batch(pkg.wire, recs, codec, compress)
    except pkg.compress.CodecUnavailable:
        pytest.skip(f"{codec_name} library not on this host")
    kafka.send(topic, "pre", "existing")
    kafka._test_server.append_raw_batch(topic, 0, batch)
    got = kafka.read(topic, 0, 0, 100)
    assert got[0] == (0, "pre", "existing")
    assert got[1:] == [(1, "k0", "v0"), (2, None, "vé"), (3, "k2", "x" * 500)]
    kafka.send(topic, "post", "after")
    assert kafka.read(topic, 0, 4, 10) == [(4, "post", "after")]


def test_missing_codec_library_raises(pkg, kafka, monkeypatch):
    """A batch whose codec's system library is missing fails the read with
    CodecUnavailable; the batch is never skipped silently."""
    kafka.create_topic("NOLIB", 1)
    try:
        batch = _foreign_batch(pkg.wire, [(b"k", b"v")], 4, pkg.compress.zstd_compress)
    except pkg.compress.CodecUnavailable:
        pytest.skip("libzstd not on this host")
    kafka._test_server.append_raw_batch("NOLIB", 0, batch)
    monkeypatch.setattr(pkg.compress.ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(pkg.compress, "_zstd", None)
    with pytest.raises(pkg.compress.CodecUnavailable):
        kafka.read("NOLIB", 0, 0, 10)


def test_coordinator_movement_mid_session(pkg):
    with pkg.testbroker.LocalKafkaTestBroker() as node_a:
        node_b = pkg.testbroker.LocalKafkaTestBroker(shared_from=node_a).start()
        try:
            broker = pkg.kafka.KafkaBroker([(node_a.host, node_a.port)])
            broker.create_topic("COORD", 1)
            broker.commit_offsets("g1", "COORD", {0: 5})
            assert broker.get_offsets("g1", "COORD") == {0: 5}
            node_a.move_coordinator(node_b.host, node_b.port)
            broker.commit_offsets("g1", "COORD", {0: 9})
            assert broker.get_offsets("g1", "COORD") == {0: 9}
            assert node_b._group_offsets[("g1", "COORD")] == {0: 9}
            broker.close()
        finally:
            node_b.close()


def test_injected_coordinator_errors_retry(pkg, kafka):
    kafka.create_topic("CERR", 1)
    server = kafka._test_server
    server.inject_error(pkg.wire.API_OFFSET_COMMIT, 16, times=1)
    kafka.commit_offsets("g2", "CERR", {0: 3})
    server.inject_error(pkg.wire.API_OFFSET_FETCH, 15, times=1)
    assert kafka.get_offsets("g2", "CERR") == {0: 3}
    server.inject_error(pkg.wire.API_OFFSET_COMMIT, 16, times=10)
    with pytest.raises(pkg.kafka.KafkaError):
        kafka.commit_offsets("g2", "CERR", {0: 4})
    server._injected.clear()


def test_injected_produce_leader_error_retries(pkg, kafka):
    kafka.create_topic("PERR", 1)
    kafka._test_server.inject_error(pkg.wire.API_PRODUCE, 6, times=1)
    kafka.send("PERR", "k", "survived")
    assert kafka.read("PERR", 0, 0, 10) == [(0, "k", "survived")]


def test_nonzero_throttle_is_tolerated(kafka):
    kafka.create_topic("THR", 1)
    kafka._test_server.throttle_ms = 125
    kafka.send("THR", "k", "v")
    assert kafka.read("THR", 0, 0, 10) == [(0, "k", "v")]
    kafka._test_server.throttle_ms = 0


def test_lz4_zstd_bindings_edge_cases(pkg):
    """Multi-block lz4 frames and a 4MB-block frame from the canonical
    library; a hostile zstd declared size fails cleanly."""
    import ctypes
    import ctypes.util

    c = pkg.compress
    try:
        blob = bytes(range(256)) * 12_000
        assert c.lz4f_decompress(c.lz4f_compress(blob)) == blob
        assert c.zstd_decompress(c.zstd_compress(blob)) == blob
    except c.CodecUnavailable:
        pytest.skip("system codec libraries absent")
    lib = ctypes.CDLL(ctypes.util.find_library("lz4"))

    class Prefs(ctypes.Structure):
        _fields_ = [
            ("blockSizeID", ctypes.c_int), ("blockMode", ctypes.c_int),
            ("contentChecksumFlag", ctypes.c_int), ("frameType", ctypes.c_int),
            ("contentSize", ctypes.c_ulonglong), ("dictID", ctypes.c_uint),
            ("blockChecksumFlag", ctypes.c_int),
            ("compressionLevel", ctypes.c_int), ("autoFlush", ctypes.c_uint),
            ("favorDecSpeed", ctypes.c_uint), ("reserved", ctypes.c_uint * 3),
        ]

    prefs = Prefs()
    prefs.blockSizeID = 7
    data = b"xy" * 700_000
    lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    cap = lib.LZ4F_compressFrameBound(len(data), ctypes.byref(prefs))
    dst = ctypes.create_string_buffer(cap)
    lib.LZ4F_compressFrame.restype = ctypes.c_size_t
    n = lib.LZ4F_compressFrame(dst, cap, data, len(data), ctypes.byref(prefs))
    assert c.lz4f_decompress(dst.raw[:n]) == data
    with pytest.raises(ValueError):
        c.zstd_decompress(b"\x28\xb5\x2f\xfd" + b"\x64" + b"\xff" * 8)


def test_native_crc32c_tier(pkg, monkeypatch):
    """Without google_crc32c, crc32c resolves to the native SSE4.2
    implementation (oryxbus_crc32c) and agrees with the pure-python
    reference, chained crcs included."""
    import builtins
    import sys as _sys

    real_import = builtins.__import__

    def no_gcrc(name, *a, **k):
        if name == "google_crc32c":
            raise ImportError("masked for test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_gcrc)
    monkeypatch.delitem(_sys.modules, "google_crc32c", raising=False)
    fn = pkg.wire._resolve_crc32c()
    if fn.__name__ == "_crc32c_py":
        pytest.skip("native library unavailable on this host")
    assert fn.__name__ == "crc32c_native"
    assert fn(b"123456789") == 0xE3069283
    blob = os.urandom(5000)
    assert fn(blob) == pkg.wire._crc32c_py(blob)
    assert fn(blob[100:], fn(blob[:100])) == pkg.wire._crc32c_py(blob)


# -- the port's fetch buffer ---------------------------------------------------

def test_reads_inside_the_last_fetch_need_no_round_trip():
    """The port's client keeps the records of its newest fetch per
    partition: a read that ends inside them is answered without a Fetch (a
    consumer taking max_poll records a read would otherwise re-fetch and
    re-decode the partition's whole remaining log each time); a read that
    reaches past them fetches and sees what arrived since, and a recreated
    topic drops them."""
    port = _ns("oryx_tpu_torch")
    with port.testbroker.LocalKafkaTestBroker() as server:
        b = port.kafka.KafkaBroker([(server.host, server.port)])
        fetches = []
        real = server._fetch
        server._fetch = lambda *a: (fetches.append(a), real(*a))[1]
        b.create_topic("BUF", 1)
        b.send_batch("BUF", [(None, f"m{i}") for i in range(1000)])
        got = []
        off = 0
        while True:
            recs = b.read("BUF", 0, off, 100)
            if not recs:
                break
            got.extend(recs)
            off = recs[-1][0] + 1
        assert [m for _, _, m in got] == [f"m{i}" for i in range(1000)]
        assert [o for o, _, _ in got] == list(range(1000))
        assert len(fetches) == 2  # the whole log, then the empty tail
        b.send("BUF", None, "late")
        assert b.read("BUF", 0, 1000, 10) == [(1000, None, "late")]
        assert len(fetches) == 3
        assert b.read("BUF", 0, 995, 10)[-1] == (1000, None, "late")
        assert b.read("BUF", 0, 0, 5) == [(j, None, f"m{j}") for j in range(5)]
        b.delete_topic("BUF")
        b.create_topic("BUF", 1)
        b.send("BUF", None, "fresh")
        assert b.read("BUF", 0, 0, 10) == [(0, None, "fresh")]
        b.close()


# -- across packages -----------------------------------------------------------

@pytest.mark.parametrize("client,server", [
    ("oryx_tpu_torch", "oryx_tpu"), ("oryx_tpu", "oryx_tpu_torch")],
    ids=["port-client-jax-broker", "jax-client-port-broker"])
def test_client_against_the_other_packages_broker(client, server):
    """Each package's client speaks to the other package's test broker:
    admin, keyed produce and fetch, group offsets and a compressed foreign
    batch, with the same answers."""
    c, s = _ns(client), _ns(server)
    with s.testbroker.LocalKafkaTestBroker() as srv:
        b = c.kafka.KafkaBroker([(srv.host, srv.port)])
        b.create_topic("X", partitions=4)
        assert b.topic_exists("X") and b.num_partitions("X") == 4
        b.send_batch("X", [(f"k{i}", f"m{i}") for i in range(40)])
        for p in range(4):
            recs = b.read("X", p, 0, 100)
            assert all(c.broker.partition_for(k, 4) == p for _, k, _ in recs)
            assert [o for o, _, _ in recs] == list(range(len(recs)))
        assert sum(b.end_offsets("X")) == 40
        b.commit_offsets("g", "X", {0: 3, 2: 1})
        assert b.get_offsets("g", "X") == {0: 3, 2: 1}
        b.create_topic("Z", 1)
        srv.append_raw_batch("Z", 0, _foreign_batch(
            s.wire, [(b"k", b"gz")], 1, gzip.compress))
        assert b.read("Z", 0, 0, 10) == [(0, "k", "gz")]
        b.delete_topic("X")
        assert not b.topic_exists("X")
        b.close()


def test_record_batches_are_the_same_bytes():
    """encode_record_batch of both packages gives the same bytes for the
    same records and base timestamp, and each package decodes the
    other's batches."""
    jw, pw = _ns("oryx_tpu").wire, _ns("oryx_tpu_torch").wire
    rng = np.random.default_rng(5)
    for n in (1, 3, 200):
        recs = [(None if j % 7 == 3 else f"k{j}".encode(),
                 None if j % 11 == 5 else bytes(rng.integers(0, 256, j % 300,
                                                             dtype=np.uint8)))
                for j in range(n)]
        jb = jw.encode_record_batch(recs, 1_700_000_000_123)
        pb = pw.encode_record_batch(recs, 1_700_000_000_123)
        assert jb == pb
        want = [(j, k, v) for j, (k, v) in enumerate(recs)]
        assert pw.decode_record_batches(jb) == want
        assert jw.decode_record_batches(pb) == want
    assert jw.crc32c(jb) == pw.crc32c(jb) == pw._crc32c_py(jb)
    assert jw.encode_request(3, 1, 7, "c", b"x") == pw.encode_request(3, 1, 7, "c", b"x")


@pytest.mark.parametrize("writer,reader", [
    ("oryx_tpu", "oryx_tpu_torch"), ("oryx_tpu_torch", "oryx_tpu")])
def test_topic_written_by_one_package_is_read_by_the_other(writer, reader):
    """A producer of one package and a consumer of the other on one
    kafka:// topic: the same records at the same offsets, keyed records in
    the same partitions."""
    w, r = _ns(writer), _ns(reader)
    with r.testbroker.LocalKafkaTestBroker() as srv:
        wb = w.kafka.KafkaBroker([(srv.host, srv.port)])
        rb = r.kafka.KafkaBroker([(srv.host, srv.port)])
        wb.create_topic("OryxInput", 4)
        records = [(f"u{j}", f"u{j},i{j % 7},1,{1000 + j}") for j in range(60)]
        records += [(None, "ü, utf-8 & a null key"), ("MODEL-REF", "/m/0001")]
        w.api.TopicProducer(wb, "OryxInput").send_batch(records)
        with r.api.ConsumeDataIterator(rb, "OryxInput", start="earliest") as it:
            got = it.poll_available()
        assert sorted((km.key or "", km.message) for km in got) == sorted(
            (k or "", m) for k, m in records)
        for p in range(4):
            rows = rb.read("OryxInput", p, 0, 1000)
            keyed = [k for _, k, _ in rows if k is not None]
            assert all(w.broker.partition_for(k, 4) == p for k in keyed)
            assert all(r.broker.partition_for(k, 4) == p for k in keyed)
            assert rows == wb.read("OryxInput", p, 0, 1000)
        wb.close()
        rb.close()


def _example_overlay(root: str, uri: str, tmp) -> dict:
    return {
        "oryx.id": "wc-kafka",
        "oryx.input-topic.broker": uri, "oryx.update-topic.broker": uri,
        "oryx.batch.storage.data-dir": str(tmp / "data"),
        "oryx.batch.storage.model-dir": str(tmp / "model"),
        "oryx.batch.update-class": f"{root}.apps.example.batch.ExampleBatchLayerUpdate",
    }


@pytest.mark.parametrize("writer,reader", [
    ("oryx_tpu", "oryx_tpu_torch"), ("oryx_tpu_torch", "oryx_tpu")])
def test_one_packages_producer_feeds_the_others_batch_layer(writer, reader, tmp_path):
    """Lines a producer of one package writes to a kafka:// input topic go
    through a batch layer of the other package (the wordcount app): its
    MODEL is the count of those lines."""
    w, r = _ns(writer), _ns(reader)
    layers = importlib.import_module(f"{reader}.layers")
    config = importlib.import_module(f"{reader}.common.config")
    lines = ["cat dog", "cat fish", "dog bird fish", "solo"]
    with w.testbroker.LocalKafkaTestBroker() as srv:
        wb = w.broker.get_broker(srv.uri)
        wb.create_topic("OryxInput", 2)
        wb.create_topic("OryxUpdate", 1)
        cfg = config.load_config(overlay=_example_overlay(reader, srv.uri, tmp_path))
        batch = layers.BatchLayer(cfg)
        batch.ensure_streams()
        w.api.TopicProducer(wb, "OryxInput").send_batch((None, ln) for ln in lines)
        assert batch.run_generation(timestamp_ms=1_700_000_000_000) == len(lines)
        batch.close()
        recs = wb.read("OryxUpdate", 0, 0, 10)
        assert recs[0][1] == "MODEL"
        assert json.loads(recs[0][2]) == {"cat": 2, "dog": 3, "fish": 3,
                                          "bird": 2}


# -- the lambda slice over kafka:// in the port --------------------------------

def _wait(pred, what, limit=30):
    deadline = time.time() + limit
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.2)
    raise AssertionError(what)


def test_e2e_batch_to_serving_over_kafka(tmp_path):
    """The port's batch layer trains and publishes over a kafka:// update
    topic; its serving layer replays it and answers /recommend."""
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus.api import TopicProducer
    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.layers import BatchLayer
    from oryx_tpu_torch.serving.server import ServingLayer
    from tests.torch_kafka_testbroker import LocalKafkaTestBroker

    RandomManager.use_test_seed(11)
    with LocalKafkaTestBroker() as server:
        uri = server.uri
        overlay = dict(app_overlay("als"))
        overlay.update({
            "oryx.id": "kafka-e2e",
            "oryx.input-topic.broker": uri,
            "oryx.update-topic.broker": uri,
            "oryx.batch.storage.data-dir": str(tmp_path / "data"),
            "oryx.batch.storage.model-dir": str(tmp_path / "model"),
            "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
            "oryx.serving.api.port": 0,
            "oryx.als.hyperparams.features": 4,
            "oryx.als.hyperparams.iterations": 4,
            "oryx.ml.eval.test-fraction": 0.1,
            "oryx.serving.min-model-load-fraction": 0.8,
        })
        cfg = load_config(overlay=overlay)
        topics.maybe_create(uri, "OryxInput", partitions=2)
        topics.maybe_create(uri, "OryxUpdate", partitions=1)
        broker = get_broker(uri)
        rng = np.random.default_rng(0)
        prod = TopicProducer(broker, "OryxInput")
        for u in range(24):
            for i in rng.choice(16, 4, replace=False):
                prod.send(f"u{u}", f"u{u},i{i},1,{1000 + int(i)}")

        batch = BatchLayer(cfg, update=ALSUpdate(cfg, device="cpu"))
        batch.ensure_streams()
        batch._consumer.seek({p: 0 for p in batch._consumer.positions()})
        assert batch.run_generation(timestamp_ms=1_700_000_000_000) == 24 * 4
        batch.close()

        serving = ServingLayer(cfg, model_manager=ALSServingModelManager(cfg, device="cpu"))
        serving.start()
        try:
            base = f"http://127.0.0.1:{serving.port}"
            _wait(lambda: _http("GET", f"{base}/ready")[0] == 200,
                  "serving never ready over kafka")
            status, body = _http("GET", f"{base}/recommend/u5?howMany=3")
            assert status == 200 and len(json.loads(body)) == 3
        finally:
            serving.close()


def test_speed_layer_folds_over_kafka():
    """The port's speed tier over kafka://: replay the model from the
    update topic, fold a fresh interaction from the input topic, and
    publish the UP rows back."""
    from oryx_tpu_torch.apps.als.common import x_update_message, y_update_message
    from oryx_tpu_torch.apps.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.bus.api import TopicProducer
    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.layers import SpeedLayer
    from tests.torch_kafka_testbroker import LocalKafkaTestBroker

    RandomManager.use_test_seed(21)
    with LocalKafkaTestBroker() as server:
        uri = server.uri
        cfg = load_config(overlay={
            "oryx.id": "kafka-speed",
            "oryx.input-topic.broker": uri,
            "oryx.update-topic.broker": uri,
            "oryx.speed.streaming.generation-interval-sec": 1,
            "oryx.speed.min-model-load-fraction": 0.8,
            "oryx.als.hyperparams.features": 4,
        })
        topics.maybe_create(uri, "OryxInput", partitions=2)
        topics.maybe_create(uri, "OryxUpdate", partitions=1)
        broker = get_broker(uri)
        rng = np.random.default_rng(5)
        prod = TopicProducer(broker, "OryxUpdate")
        prod.send("MODEL", json.dumps(
            {"app": "als", "extensions": {"features": "4"}, "content": {}}))
        for u in range(6):
            prod.send(*x_update_message(f"u{u}", rng.standard_normal(4), [f"i{u}"]))
        for i in range(8):
            prod.send(*y_update_message(f"i{i}", rng.standard_normal(4)))

        speed = SpeedLayer(cfg, manager=ALSSpeedModelManager(cfg, device="cpu"))
        speed.start()
        try:
            _wait(lambda: speed.manager.state is not None
                  and speed.manager.state.fraction_loaded() >= 0.8,
                  "speed model never loaded over kafka")
            TopicProducer(broker, "OryxInput").send("u1", "u1,i2,3,99")

            def folded():
                rows = [json.loads(m) for _, k, m in broker.read("OryxUpdate", 0, 0, 200)
                        if k == "UP"]
                got = [g for g in rows if g[1] in ("u1", "i2")]
                return got if len(got) >= 4 else None

            got = _wait(folded, "no fold-in rows published")
            kinds = {(g[0], g[1]) for g in got}
            assert ("X", "u1") in kinds and ("Y", "i2") in kinds, got
        finally:
            speed.close()


def test_speed_layer_folds_a_compressed_foreign_batch(tmp_path):
    """Events that reach the input topic inside gzip and snappy batches of
    a foreign producer are folded like any others."""
    from oryx_tpu_torch.apps.als.common import x_update_message, y_update_message
    from oryx_tpu_torch.apps.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.bus import kafkawire
    from oryx_tpu_torch.bus.api import TopicProducer
    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.layers import SpeedLayer
    from tests.torch_kafka_testbroker import LocalKafkaTestBroker

    with LocalKafkaTestBroker() as server:
        uri = server.uri
        cfg = load_config(overlay={
            "oryx.id": "kafka-speed-codec",
            "oryx.input-topic.broker": uri, "oryx.update-topic.broker": uri,
            "oryx.speed.min-model-load-fraction": 1.0,
            "oryx.speed.streaming.generation-interval-sec": 3600,
            "oryx.als.hyperparams.features": 4,
        })
        topics.maybe_create(uri, "OryxInput", partitions=1)
        topics.maybe_create(uri, "OryxUpdate", partitions=1)
        broker = get_broker(uri)
        rng = np.random.default_rng(9)
        prod = TopicProducer(broker, "OryxUpdate")
        prod.send("MODEL", json.dumps(
            {"app": "als", "extensions": {"features": "4"}, "content": {}}))
        for u in range(4):
            prod.send(*x_update_message(f"u{u}", rng.standard_normal(4), []))
        for i in range(4):
            prod.send(*y_update_message(f"i{i}", rng.standard_normal(4)))
        speed = SpeedLayer(cfg, manager=ALSSpeedModelManager(cfg, device="cpu"))
        speed.start()
        try:
            _wait(lambda: speed.manager.state is not None
                  and speed.manager.state.fraction_loaded() >= 1.0,
                  "speed model never loaded")
            for codec, compress, user in ((1, gzip.compress, "u-gzip"),
                                          (2, _snappy_compress_literals, "u-snappy")):
                server.append_raw_batch("OryxInput", 0, _foreign_batch(
                    kafkawire, [(None, f"{user},i1,2,5".encode())], codec, compress))
            assert speed.run_batch() == 2
            rows = [json.loads(m) for _, k, m in broker.read("OryxUpdate", 0, 0, 100)
                    if k == "UP"]
            assert {"u-gzip", "u-snappy"} <= {r[1] for r in rows if r[0] == "X"}
        finally:
            speed.close()
