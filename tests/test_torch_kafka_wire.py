"""The Kafka wire codec and client of both packages against bytes no oryx
code made: the codec units of tests/test_kafka.py, the partial-frame
contract of tests/test_wire_frames.py, and the golden-transcript replay of
tests/test_kafka_transcripts.py (tests/data/kafka_transcripts.json served
by that file's dumb byte replayer, the client's produce bytes checked by
tools/kafka_transcripts.py's independent decoder). Each case runs against
the JAX package and the port; the answers are compared exactly.
"""

from __future__ import annotations

import gzip
import importlib
import os
import random
import struct
from types import SimpleNamespace

import pytest

from tests.test_kafka_transcripts import BY_KEY, EDGES, TOPIC, Replayer, indep

PKGS = {"jax": "oryx_tpu", "port": "oryx_tpu_torch"}

needs_edges = pytest.mark.skipif(
    not EDGES, reason="transcript has no edge_exchanges (live recording)"
)


@pytest.fixture(params=list(PKGS.values()), ids=list(PKGS))
def pkg(request):
    m = lambda rel: importlib.import_module(f"{request.param}.{rel}")  # noqa: E731
    return SimpleNamespace(wire=m("bus.kafkawire"), kafka=m("bus.kafka"),
                           api=m("bus.api"))


# -- codec units ----------------------------------------------------------------

def test_crc32c_check_value(pkg):
    for fn in (pkg.wire.crc32c, pkg.wire._crc32c_py):
        assert fn(b"123456789") == 0xE3069283
        assert fn(b"") == 0
    for n in (1, 7, 8, 9, 255, 1024, 4097):
        blob = os.urandom(n)
        assert pkg.wire.crc32c(blob) == pkg.wire._crc32c_py(blob)


def test_record_batch_roundtrip(pkg):
    recs = [(b"k1", b"v1"), (None, b"v2"), (b"k3", None), (b"", b"")]
    batch = pkg.wire.encode_record_batch(recs, base_timestamp_ms=1234)
    assert struct.unpack_from(">q", batch, 0)[0] == 0  # baseOffset
    assert batch[16] == 2  # magic v2
    assert pkg.wire.decode_record_batches(batch) == [
        (0, b"k1", b"v1"), (1, None, b"v2"), (2, b"k3", None), (3, b"", b"")]


def test_decode_after_base_offset_rewrite(pkg):
    batch = pkg.wire.encode_record_batch([(b"a", b"1"), (b"b", b"2")], 0)
    rewritten = struct.pack(">q", 100) + batch[8:]
    assert [o for o, _, _ in pkg.wire.decode_record_batches(rewritten)] == [100, 101]


def _snappy_literals(data: bytes) -> bytes:
    out = bytearray()
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    for pos in range(0, len(data), 60):
        chunk = data[pos:pos + 60]
        out.append((len(chunk) - 1) << 2)
        out += chunk
    return bytes(out)


def test_snappy_decoder_property_roundtrip(pkg):
    """Literal-only compression roundtrips arbitrary payloads, raw and
    xerial-framed; hand-built copy elements (overlapping runs too) decode
    per the format; corruption is an error."""
    block, framed = pkg.wire._snappy_block_decompress, pkg.wire.snappy_decompress
    rng = random.Random(42)
    for _ in range(50):
        n = rng.randrange(0, 5000)
        data = bytes(rng.randrange(256) for _ in range(min(n, 300))) * (
            1 if n <= 300 else n // 300)
        blk = _snappy_literals(data)
        assert block(blk) == data
        assert framed(b"\x82SNAPPY\x00" + struct.pack(">ii", 1, 1)
                      + struct.pack(">i", len(blk)) + blk) == data
    lit = bytes([8, 3 << 2]) + b"abcd"
    assert block(lit + bytes([((4 - 1) << 2) | 2]) + struct.pack("<H", 4)) == b"abcdabcd"
    assert block(lit + bytes([((4 - 1) << 2) | 3]) + struct.pack("<I", 4)) == b"abcdabcd"
    assert block(lit + bytes([1, 4])) == b"abcdabcd"
    run = bytes([8, 1 << 2]) + b"ab" + bytes([((6 - 1) << 2) | 2]) + struct.pack("<H", 1)
    assert block(run) == b"abbbbbbb"
    with pytest.raises(ValueError):
        block(bytes([200, 0 << 2]) + b"x")
    with pytest.raises(ValueError):
        block(bytes([4, ((4 - 1) << 2) | 2]) + struct.pack("<H", 9))


# -- partial and corrupt frames (tests/test_wire_frames.py) --------------------

def _batch(wire, n=3, base_ts=1000):
    return wire.encode_record_batch(
        [(f"k{i}".encode(), f"value-{i}".encode()) for i in range(n)], base_ts)


_ATTRS_AT = 8 + 4 + 4 + 1 + 4  # baseOffset len leaderEpoch magic crc


def test_wire_frame_baseline_and_partial_tail(pkg):
    """A complete batch decodes; a trailing batch cut by the fetch-size
    boundary is dropped silently (the next fetch re-reads it)."""
    w = pkg.wire
    out = w.decode_record_batches(_batch(w))
    assert [(o, k) for o, k, _ in out] == [(0, b"k0"), (1, b"k1"), (2, b"k2")]
    partial = _batch(w, 3)
    assert len(w.decode_record_batches(_batch(w, 2) + partial[: len(partial) // 2])) == 2
    one = w.encode_record_batch([(b"a", b"b")], 0)
    assert w.decode_record_batches(one + one[: len(one) // 2]) == [(0, b"a", b"b")]


def test_mid_frame_cut_raises_with_its_offset(pkg):
    raw = bytearray(_batch(pkg.wire, 3))
    for i in range(len(raw) - len(raw) // 3, len(raw)):
        raw[i] = 0
    with pytest.raises(pkg.wire.WireDecodeError, match="base offset 0"):
        pkg.wire.decode_record_batches(bytes(raw))


def test_corrupt_batch_after_good_batch_raises(pkg):
    good = _batch(pkg.wire, 2, base_ts=1)
    bad = bytearray(_batch(pkg.wire, 2, base_ts=2))
    for i in range(len(bad) - 8, len(bad)):
        bad[i] = 0xFF
    with pytest.raises(pkg.wire.WireDecodeError):
        pkg.wire.decode_record_batches(good + bytes(bad))


def test_record_count_beyond_payload_rejected(pkg):
    raw = bytearray(_batch(pkg.wire, 1))
    count_at = 8 + 4 + 4 + 1 + 4 + 2 + 4 + 16 + 8 + 2 + 4
    raw[count_at:count_at + 4] = (99).to_bytes(4, "big")
    with pytest.raises(pkg.wire.WireDecodeError):
        pkg.wire.decode_record_batches(bytes(raw))


def test_corrupt_gzip_payloads_map_to_wire_decode_error(pkg):
    """A claimed-complete batch whose compressed payload is not gzip, or
    is a truncated gzip stream, raises WireDecodeError (never a bare
    OSError the consume retry would replay)."""
    raw = bytearray(_batch(pkg.wire, 2))
    raw[_ATTRS_AT:_ATTRS_AT + 2] = (1).to_bytes(2, "big")
    with pytest.raises(pkg.wire.WireDecodeError, match="base offset 0"):
        pkg.wire.decode_record_batches(bytes(raw))
    payload = gzip.compress(b"x" * 256)[:40]
    raw = bytearray(_batch(pkg.wire, 1))
    raw[_ATTRS_AT:_ATTRS_AT + 2] = (1).to_bytes(2, "big")
    head = bytes(raw[: _ATTRS_AT + 2 + 4 + 16 + 8 + 2 + 4 + 4])
    body = head[12:] + payload
    framed = raw[:8] + len(body).to_bytes(4, "big") + body
    with pytest.raises(pkg.wire.WireDecodeError):
        pkg.wire.decode_record_batches(bytes(framed))


def test_unbounded_varint_rejected(pkg):
    with pytest.raises(pkg.wire.WireDecodeError, match="varint"):
        pkg.wire.Reader(b"\xff" * 16).varint()


def test_consume_fails_once_then_stream_recovers(pkg):
    """A read that hits a corrupt frame fails THAT consume with the decode
    error; the next read against healthy bytes proceeds."""
    err = pkg.wire.WireDecodeError

    class FlakyBroker:
        reads = 0

        def num_partitions(self, topic):
            return 1

        def end_offsets(self, topic):
            return [0]

        def get_offsets(self, group, topic):
            return {}

        def commit_offsets(self, group, topic, offsets):
            pass

        def read(self, topic, p, off, n):
            self.reads += 1
            if self.reads == 1:
                raise err("corrupt record batch at base offset 5")
            return [(off, None, "fine")] if off == 0 else []

    it = pkg.api.ConsumeDataIterator(FlakyBroker(), "t", start="earliest")
    with pytest.raises(err):
        it.poll_available()
    assert [km.message for km in it.poll_available()] == ["fine"]
    it.close()


# -- golden transcripts (tests/test_kafka_transcripts.py) ----------------------

@pytest.fixture()
def replay(pkg):
    r = Replayer()
    b = pkg.kafka.KafkaBroker([("127.0.0.1", r.port)])
    yield r, b
    b.close()
    r.close()


def test_metadata_topology_decode(replay):
    r, b = replay
    assert b.topic_exists(TOPIC)
    assert b.num_partitions(TOPIC) == 2
    keys = [k for k, *_ in r.requests]
    assert keys and keys[0] == 18 and all(k in (18, 3) for k in keys)


def test_fetch_decodes_recorded_batches(replay):
    _, b = replay
    assert b.read(TOPIC, 0, 5, 100) == [tuple(e) for e in BY_KEY[1]["expect"]]
    assert [o for o, _, _ in b.read(TOPIC, 0, 7, 100)] == [7, 8, 9]
    assert len(b.read(TOPIC, 0, 5, 2)) == 2


def test_produce_emits_valid_record_batch(replay):
    """The client's own produce bytes through the independent decoder:
    framing, varints and CRC-32C all verify."""
    r, b = replay
    b.send_batch(TOPIC, [(None, "v-five"), ("k6", "v-six"), ("k7", "v-seven")],
                 partition=0)
    produce = [rest for k, _, _, rest in r.requests if k == 0]
    assert len(produce) == 1
    body, pos = produce[0], 0
    (tlen,) = struct.unpack_from(">h", body, pos)
    pos += 2 + max(0, tlen)
    acks, _timeout = struct.unpack_from(">hi", body, pos)
    assert acks == 1
    pos += 6
    assert struct.unpack_from(">i", body, pos)[0] == 1
    pos += 4
    (nlen,) = struct.unpack_from(">h", body, pos)
    assert body[pos + 2: pos + 2 + nlen].decode() == TOPIC
    pos += 2 + nlen
    assert struct.unpack_from(">i", body, pos)[0] == 1
    pos += 4
    pidx, blen = struct.unpack_from(">ii", body, pos)
    assert pidx == 0
    pos += 8
    decoded = indep.decode_record_batches_indep(body[pos: pos + blen])
    assert [(k, v) for _, k, v in decoded] == [
        (None, b"v-five"), (b"k6", b"v-six"), (b"k7", b"v-seven")]
    assert [o for o, _, _ in decoded] == [0, 1, 2]


def test_end_offsets_via_list_offsets(replay):
    r, b = replay
    assert b.end_offsets(TOPIC) == [10, 10]
    assert (2, 1) in [(k, v) for k, v, _, _ in r.requests]


def test_offset_commit_and_fetch_roundtrip(replay):
    r, b = replay
    b.commit_offsets("oryx-golden-g", TOPIC, {0: 41, 1: 7})
    got = b.get_offsets("oryx-golden-g", TOPIC)
    assert got == {int(k): v for k, v in BY_KEY[9]["expect"].items()}
    assert {10, 8, 9} <= {k for k, *_ in r.requests}


def test_create_and_delete_topic(replay):
    r, b = replay
    b.create_topic(TOPIC, partitions=2)
    b.delete_topic(TOPIC)
    keys = [k for k, *_ in r.requests]
    assert 19 in keys and 20 in keys


def test_client_id_and_header_framing(replay):
    r, b = replay
    b.topic_exists(TOPIC)
    key, ver, cid, _ = r.requests[0]
    assert key == 18 and ver == 0
    assert cid
    key, ver, cid2, _ = r.requests[1]
    assert key == 3 and ver == 1 and cid2 == cid


def _edge_broker(pkg, *names: str):
    r = Replayer(overrides={EDGES[n]["api_key"]: EDGES[n] for n in names})
    return r, pkg.kafka.KafkaBroker([("127.0.0.1", r.port)])


@needs_edges
def test_fetch_offset_out_of_range_resumes_from_earliest(pkg):
    r, b = _edge_broker(pkg, "fetch_offset_out_of_range", "list_offsets_earliest_8")
    try:
        recs = b.read(TOPIC, 0, 5, 100)
        assert recs == [tuple(e) for e in EDGES["fetch_offset_out_of_range"]["expect"]]
        keys = [k for k, *_ in r.requests]
        assert keys.count(1) == 2
        assert 2 in keys
    finally:
        b.close()
        r.close()


@needs_edges
def test_fetch_not_leader_refreshes_and_recovers(pkg):
    r, b = _edge_broker(pkg, "fetch_not_leader")
    try:
        assert b.read(TOPIC, 0, 5, 100) == []
        meta_after_first = [k for k, *_ in r.requests].count(3)
        recs = b.read(TOPIC, 0, 5, 100)
        assert recs == [tuple(e) for e in EDGES["fetch_not_leader"]["expect"]]
        assert meta_after_first >= 2
    finally:
        b.close()
        r.close()


@needs_edges
def test_metadata_unknown_topic(pkg):
    r, b = _edge_broker(pkg, "metadata_unknown_topic")
    try:
        assert b.topic_exists(TOPIC) is False
        with pytest.raises(Exception) as ei:
            b.num_partitions(TOPIC)
        assert "3" in str(ei.value) or "UNKNOWN" in str(ei.value).upper()
    finally:
        b.close()
        r.close()


@needs_edges
@pytest.mark.parametrize("edge", ["fetch_truncated", "fetch_codecs"])
def test_fetch_edge_transcripts(pkg, edge):
    """A record set cut mid-batch at the max_bytes boundary, and one batch
    per codec (gzip and snappy from the independent tool's encoders,
    lz4-frame and zstd from its own bindings)."""
    r, b = _edge_broker(pkg, edge)
    try:
        offset = 10 if edge == "fetch_codecs" else 5
        assert b.read(TOPIC, 0, offset, 100) == [tuple(e) for e in EDGES[edge]["expect"]]
    finally:
        b.close()
        r.close()


@needs_edges
def test_api_versions_rejects_broker_without_fetch_v4(pkg):
    r, b = _edge_broker(pkg, "api_versions_no_fetch_v4")
    try:
        with pytest.raises((pkg.kafka.KafkaError, ConnectionError)) as ei:
            b.topic_exists(TOPIC)
        assert "35" in str(ei.value) or "support" in str(ei.value)
    finally:
        b.close()
        r.close()


def test_both_clients_send_the_same_produce_body(monkeypatch):
    """The two packages' clients put the same bytes on the wire for the
    same produce (apart from the timestamp, fixed here, and the header's
    client id)."""
    import time

    bodies = {}
    for root in PKGS.values():
        kafka = importlib.import_module(f"{root}.bus.kafka")
        monkeypatch.setattr(kafka, "time", SimpleNamespace(
            time=lambda: 1_700_000_000.123, monotonic=time.monotonic,
            sleep=time.sleep))
        r = Replayer()
        b = kafka.KafkaBroker([("127.0.0.1", r.port)])
        try:
            b.send_batch(TOPIC, [(None, "a"), ("k", "b")], partition=1)
        finally:
            b.close()
            r.close()
        bodies[root] = [rest for k, _, _, rest in r.requests if k == 0]
    assert len(bodies["oryx_tpu"]) == 1
    assert bodies["oryx_tpu"] == bodies["oryx_tpu_torch"]
