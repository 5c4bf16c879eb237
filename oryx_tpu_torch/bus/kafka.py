"""kafka:// Broker backend — a dependency-free Kafka protocol client (the
port's copy of oryx_tpu/bus/kafka.py).

Parity target: the reference's entire inter-process data plane is a real
Kafka cluster — topic admin in KafkaUtils (framework/kafka-util
.../kafka/util/KafkaUtils.java:49-140) and the consumer iterator
(ConsumeDataIterator.java:36-70). This backend speaks the Kafka wire
protocol directly over TCP (no kafka-python/confluent dependency, which the
deployment image may not carry), implementing the same Broker ABC the
mem:// and file:// backends do, so every layer runs unchanged against a
production cluster: `oryx.*-topic.broker = "kafka://host:9092"`.

Group offsets are committed through the group coordinator (the modern
replacement for the reference's ZooKeeper offset store). API versions are
pinned pre-flexible: Produce v3 / Fetch v4 (record batch v2, the format all
brokers >= 0.11 speak and modern brokers require), Metadata v1,
ListOffsets v1, CreateTopics v0, DeleteTopics v0, FindCoordinator v0,
OffsetCommit v2, OffsetFetch v1. Every fresh connection starts with an
ApiVersions v0 handshake (KIP-35) that checks the pinned versions against
the broker's advertised ranges, so an incompatible broker fails loudly at
connect time.
"""

from __future__ import annotations

import bisect
import logging
import socket
import struct
import threading
import time
from typing import Mapping

from oryx_tpu_torch.bus.broker import Broker, partition_for
from oryx_tpu_torch.bus.kafkawire import (
    API_API_VERSIONS,
    API_CREATE_TOPICS,
    API_DELETE_TOPICS,
    API_FETCH,
    API_FIND_COORDINATOR,
    API_LIST_OFFSETS,
    API_METADATA,
    API_OFFSET_COMMIT,
    API_OFFSET_FETCH,
    API_PRODUCE,
    ERR_NONE,
    ERR_TOPIC_ALREADY_EXISTS,
    ERR_UNKNOWN_TOPIC_OR_PARTITION,
    ERROR_NAMES,
    Reader,
    WireDecodeError,
    Writer,
    decode_record_batches,
    encode_record_batch,
    encode_request,
)

log = logging.getLogger(__name__)

_CLIENT_ID = "oryx-tpu-torch"
_SOCKET_TIMEOUT_S = 30.0
_FETCH_MAX_WAIT_MS = 100
_MAX_PARTITION_BYTES = 32 << 20  # fits an oversized MODEL message

# every api+version this client speaks (module docstring); checked against
# the broker's advertised ranges in the per-connection ApiVersions
# handshake so an incompatible broker fails loudly at connect, not
# mid-consume with a garbled response
_PINNED_VERSIONS: dict[int, int] = {
    API_PRODUCE: 3,
    API_FETCH: 4,
    API_LIST_OFFSETS: 1,
    API_METADATA: 1,
    API_OFFSET_COMMIT: 2,
    API_OFFSET_FETCH: 1,
    API_FIND_COORDINATOR: 0,
    API_CREATE_TOPICS: 0,
    API_DELETE_TOPICS: 0,
}


class KafkaError(RuntimeError):
    def __init__(self, code: int, where: str):
        super().__init__(f"kafka error {code} ({ERROR_NAMES.get(code, '?')}) in {where}")
        self.code = code


class _Conn:
    """One broker TCP connection; a lock serializes request/response pairs
    (the bus is used from producer + listener threads concurrently)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._corr = 0
        self._negotiated = False

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port), timeout=_SOCKET_TIMEOUT_S)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            try:
                self._negotiate(s)
            except Exception:
                self.close_nolock()
                raise
        return self._sock

    def _negotiate(self, sock: socket.socket) -> None:
        """ApiVersions v0 handshake on a fresh connection (KIP-35): verify
        every api+version this client pins sits inside the broker's
        advertised [min, max]. Per-connection, like real clients — version
        support can differ across brokers in a rolling upgrade. Callers
        hold self._lock (the only entry is _connect)."""
        if self._negotiated:
            return
        self._corr += 1
        corr = self._corr
        sock.sendall(encode_request(API_API_VERSIONS, 0, corr, _CLIENT_ID, b""))
        r = Reader(self._read_response(sock))
        if r.i32() != corr:
            raise KafkaError(-1, "correlation mismatch in ApiVersions")
        err = r.i16()
        if err != ERR_NONE:
            raise KafkaError(err, "ApiVersions")
        ranges = {}
        for _ in range(r.i32()):
            key, lo, hi = r.i16(), r.i16(), r.i16()
            ranges[key] = (lo, hi)
        for key, ver in _PINNED_VERSIONS.items():
            adv = ranges.get(key)
            if adv is None or not (adv[0] <= ver <= adv[1]):
                raise KafkaError(
                    35,  # UNSUPPORTED_VERSION
                    f"broker {self.host}:{self.port} does not support "
                    f"api {key} v{ver} (advertises {adv})",
                )
        self._negotiated = True

    def request(self, api_key: int, api_version: int, body: bytes) -> Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            try:
                sock = self._connect()
                sock.sendall(
                    encode_request(api_key, api_version, corr, _CLIENT_ID, body)
                )
                resp = self._read_response(sock)
            except (OSError, EOFError):
                # one reconnect attempt: brokers drop idle connections
                self.close_nolock()
                sock = self._connect()
                sock.sendall(
                    encode_request(api_key, api_version, corr, _CLIENT_ID, body)
                )
                resp = self._read_response(sock)
        r = Reader(resp)
        got_corr = r.i32()
        if got_corr != corr:
            raise KafkaError(-1, f"correlation mismatch {got_corr} != {corr}")
        return r

    def _read_response(self, sock: socket.socket) -> bytes:
        hdr = self._recv_exact(sock, 4)
        (n,) = struct.unpack(">i", hdr)
        return self._recv_exact(sock, n)

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("connection closed by broker")
            buf.extend(chunk)
        return bytes(buf)

    def close_nolock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._negotiated = False  # re-handshake on the next connection

    def close(self) -> None:
        with self._lock:
            self.close_nolock()


class KafkaBroker(Broker):
    """Broker ABC over a real Kafka cluster."""

    def __init__(self, bootstrap: list[tuple[str, int]]):
        if not bootstrap:
            raise ValueError("no bootstrap servers")
        self._bootstrap = bootstrap
        self._conns: dict[tuple[str, int], _Conn] = {}
        self._meta_lock = threading.Lock()
        # topic -> [leader (host,port) per partition]
        self._leaders: dict[str, list[tuple[str, int]]] = {}
        # (topic, partition) -> (offsets, records) of the newest fetch: a
        # slice of an append-only log, so a read that ends inside it needs
        # no round trip (a real consumer's fetch buffer). Without it a
        # consumer taking max_poll records a read re-fetches and re-decodes
        # the partition's whole remaining log every time.
        self._fetched: dict[tuple[str, int], tuple[list[int], list]] = {}

    # -- plumbing ----------------------------------------------------------

    def _conn(self, addr: tuple[str, int]) -> _Conn:
        with self._meta_lock:
            c = self._conns.get(addr)
            if c is None:
                c = self._conns[addr] = _Conn(*addr)
            return c

    def _any_conn(self) -> _Conn:
        last: Exception | None = None
        for addr in self._bootstrap:
            try:
                c = self._conn(addr)
                with c._lock:  # _connect (incl. the handshake) shares the
                    c._connect()  # socket with concurrent request() calls
                return c
            except KafkaError as e:
                if e.code == 35:  # UNSUPPORTED_VERSION: a broker that
                    raise  # genuinely can't serve this client — fail loud
                last = e  # other handshake failures: try the next broker
            except (OSError, EOFError) as e:
                # a half-dead listener (accepts TCP, drops the handshake)
                # must not mask a healthy broker later in the list
                last = e
        raise ConnectionError(f"no reachable kafka broker in {self._bootstrap}: {last}")

    def _metadata(self, topic: str | None = None) -> dict:
        body = Writer().array([topic] if topic else None, Writer.string).done()
        r = self._any_conn().request(API_METADATA, 1, body)
        brokers = r.array(
            lambda r: (r.i32(), r.string(), r.i32(), r.string())  # id, host, port, rack
        )
        r.i32()  # controller id
        node = {b[0]: (b[1], b[2]) for b in brokers}
        topics = {}
        for _ in range(r.i32()):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            parts = {}
            for _ in range(r.i32()):
                r.i16()  # partition error
                idx = r.i32()
                leader = r.i32()
                r.array(Reader.i32)  # replicas
                r.array(Reader.i32)  # isr
                parts[idx] = leader
            topics[name] = (err, parts)
        with self._meta_lock:
            for name, (err, parts) in topics.items():
                if err == ERR_NONE and parts:
                    self._leaders[name] = [
                        node[parts[i]] for i in sorted(parts)
                    ]
        return topics

    def _leader(self, topic: str, partition: int, refresh: bool = False) -> _Conn:
        if refresh or topic not in self._leaders:
            self._metadata(topic)
        leaders = self._leaders.get(topic)
        if not leaders or partition >= len(leaders):
            raise KafkaError(ERR_UNKNOWN_TOPIC_OR_PARTITION, f"{topic}/{partition}")
        return self._conn(leaders[partition])

    def _coordinator(self, group: str) -> _Conn:
        body = Writer().string(group).done()
        r = self._any_conn().request(API_FIND_COORDINATOR, 0, body)
        err = r.i16()
        if err != ERR_NONE:
            raise KafkaError(err, "find_coordinator")
        r.i32()  # node id
        host, port = r.string(), r.i32()
        return self._conn((host, port))

    # -- admin (KafkaUtils parity) ----------------------------------------

    def create_topic(self, topic: str, partitions: int = 1, max_message_bytes: int = 1 << 24) -> None:
        def one(w: Writer, _):
            w.string(topic).i32(partitions).i16(1)
            w.array([], lambda w2, x: None)  # assignments
            w.array(
                [("max.message.bytes", str(max_message_bytes))],
                lambda w2, kv: w2.string(kv[0]).string(kv[1]),
            )

        body = Writer().array([None], one).i32(30_000).done()
        with self._meta_lock:
            self._forget_fetched(topic)
        r = self._any_conn().request(API_CREATE_TOPICS, 0, body)
        for _ in range(r.i32()):
            r.string()
            err = r.i16()
            if err == ERR_TOPIC_ALREADY_EXISTS:
                raise ValueError(f"topic exists: {topic}")
            if err != ERR_NONE:
                raise KafkaError(err, "create_topic")
        # metadata propagation: wait until the leader map shows up
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if self._metadata(topic).get(topic, (1, {}))[0] == ERR_NONE:
                return
            time.sleep(0.1)
        raise TimeoutError(f"topic {topic} not visible after create")

    def topic_exists(self, topic: str) -> bool:
        meta = self._metadata(topic).get(topic)
        return meta is not None and meta[0] == ERR_NONE and bool(meta[1])

    def delete_topic(self, topic: str) -> None:
        body = Writer().array([topic], Writer.string).i32(30_000).done()
        r = self._any_conn().request(API_DELETE_TOPICS, 0, body)
        for _ in range(r.i32()):
            r.string()
            err = r.i16()
            if err not in (ERR_NONE, ERR_UNKNOWN_TOPIC_OR_PARTITION):
                raise KafkaError(err, "delete_topic")
        with self._meta_lock:
            self._leaders.pop(topic, None)
            self._forget_fetched(topic)

    def _forget_fetched(self, topic: str) -> None:
        """Drop the fetch buffers of ``topic`` (a recreated topic reuses
        its offsets). Callers hold _meta_lock."""
        for key in [k for k in self._fetched if k[0] == topic]:
            del self._fetched[key]

    def num_partitions(self, topic: str) -> int:
        # leader cache first: send() calls this per batch and partition
        # counts don't change under the framework's usage
        with self._meta_lock:
            leaders = self._leaders.get(topic)
        if leaders:
            return len(leaders)
        meta = self._metadata(topic).get(topic)
        if meta is None or meta[0] != ERR_NONE:
            raise KafkaError(ERR_UNKNOWN_TOPIC_OR_PARTITION, topic)
        return len(meta[1])

    # -- data plane --------------------------------------------------------

    def send(self, topic: str, key: str | None, message: str, partition: int | None = None) -> None:
        self.send_batch(topic, [(key, message)], partition)

    def send_batch(self, topic: str, records, partition: int | None = None) -> None:
        records = list(records)
        if not records:
            return
        n_parts = self.num_partitions(topic)
        by_part: dict[int, list[tuple[bytes | None, bytes | None]]] = {}
        for key, message in records:
            p = partition if partition is not None else partition_for(key, n_parts)
            by_part.setdefault(p, []).append(
                (key.encode() if key is not None else None, message.encode())
            )
        now_ms = int(time.time() * 1000)
        for p, recs in by_part.items():
            batch = encode_record_batch(recs, now_ms)
            self._produce(topic, p, batch)

    def _produce(self, topic: str, partition: int, batch: bytes, retry: bool = True) -> None:
        body = (
            Writer()
            .string(None)  # transactional_id
            .i16(1)  # acks = leader
            .i32(30_000)
            .array(
                [None],
                lambda w, _: w.string(topic).array(
                    [None], lambda w2, __: w2.i32(partition).bytes_(batch)
                ),
            )
            .done()
        )
        r = self._leader(topic, partition).request(API_PRODUCE, 3, body)
        err = ERR_NONE
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()  # partition index
                err = r.i16()
                r.i64()  # base offset
                r.i64()  # log append time
        if err != ERR_NONE:
            if retry:
                # stale leader cache: refresh metadata, try once more
                self._leader(topic, partition, refresh=True)
                return self._produce(topic, partition, batch, retry=False)
            raise KafkaError(err, "produce")

    def read(self, topic: str, partition: int, offset: int, max_records: int) -> list[tuple[int, str | None, str]]:
        with self._meta_lock:
            offsets, recs = self._fetched.get((topic, partition), ((), ()))
        if offsets and offsets[0] <= offset <= offsets[-1]:
            at = bisect.bisect_left(offsets, offset)
            if at + max_records <= len(recs):
                # a read that ends inside the buffer; one that reaches its
                # end fetches, so it sees what arrived since
                return recs[at:at + max_records]
        recs = self._fetch(topic, partition, offset)
        if recs:
            with self._meta_lock:
                self._fetched[(topic, partition)] = ([o for o, _, _ in recs], recs)
        return recs[:max_records]

    def _fetch(self, topic: str, partition: int, offset: int) -> list[tuple[int, str | None, str]]:
        """Every record at or past ``offset`` that one Fetch returns."""
        body = (
            Writer()
            .i32(-1)  # replica_id
            .i32(_FETCH_MAX_WAIT_MS)
            .i32(1)  # min_bytes
            .i32(_MAX_PARTITION_BYTES)  # max_bytes
            .i8(0)  # isolation: read_uncommitted
            .array(
                [None],
                lambda w, _: w.string(topic).array(
                    [None],
                    lambda w2, __: w2.i32(partition).i64(offset).i32(_MAX_PARTITION_BYTES),
                ),
            )
            .done()
        )
        r = self._leader(topic, partition).request(API_FETCH, 4, body)
        r.i32()  # throttle
        records_bytes = b""
        err = ERR_NONE
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()  # partition index
                err = r.i16()
                r.i64()  # high watermark
                r.i64()  # last stable offset
                aborted = r.i32()
                for _ in range(max(0, aborted)):
                    r.i64()
                    r.i64()
                rb = r.bytes_()
                if rb:
                    records_bytes = rb
        if err == 1:  # OFFSET_OUT_OF_RANGE
            # log truncated by retention: resume from the earliest retained
            # offset (what auto.offset.reset=earliest does) — returning []
            # forever would stall every replay-from-earliest consumer
            earliest = self._earliest_offset(topic, partition)
            if earliest > offset:
                return self._fetch(topic, partition, earliest)
            return []
        if err != ERR_NONE:
            if err in (5, 6):  # leader moved: refresh for the next poll
                self._leader(topic, partition, refresh=True)
                return []
            raise KafkaError(err, "fetch")
        if not records_bytes:
            return []
        try:
            decoded = decode_record_batches(records_bytes)
        except WireDecodeError as e:
            # fail THIS consume with full context; the connection itself is
            # healthy (the response frame arrived complete), so later
            # fetches proceed — no desync, no reconnect storm
            raise WireDecodeError(
                f"{topic}/p{partition} fetch at offset {offset}: {e}"
            ) from e
        out = []
        for abs_off, key, value in decoded:
            if abs_off < offset:
                continue  # batch containing our offset may start earlier
            out.append(
                (
                    abs_off,
                    key.decode("utf-8") if key is not None else None,
                    value.decode("utf-8") if value is not None else "",
                )
            )
        return out

    def _list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        """ListOffsets for one partition: -1 = log end, -2 = earliest."""
        body = (
            Writer()
            .i32(-1)
            .array(
                [None],
                lambda w, _: w.string(topic).array(
                    [None], lambda w2, __: w2.i32(partition).i64(timestamp)
                ),
            )
            .done()
        )
        r = self._leader(topic, partition).request(API_LIST_OFFSETS, 1, body)
        off = 0
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                r.i64()  # timestamp
                off = r.i64()
                if err != ERR_NONE:
                    raise KafkaError(err, "list_offsets")
        return off

    def _earliest_offset(self, topic: str, partition: int) -> int:
        return self._list_offset(topic, partition, -2)

    def end_offsets(self, topic: str) -> list[int]:
        return [
            self._list_offset(topic, p, -1)
            for p in range(self.num_partitions(topic))
        ]

    # -- group offsets (the ZooKeeper-store analogue) ----------------------

    # the group coordinator can move between brokers mid-session (broker
    # restart, __consumer_offsets partition leadership change); the old
    # node answers 16 NOT_COORDINATOR / 15 COORDINATOR_NOT_AVAILABLE /
    # 14 LOAD_IN_PROGRESS until rediscovery
    _COORD_RETRY_ERRS = frozenset({14, 15, 16})

    def _coordinator_retry(self, attempt, tries: int = 3):
        """Run attempt(); on a coordinator-movement error re-resolve (the
        FindCoordinator in _coordinator() runs fresh each call) and retry
        with a short backoff."""
        for i in range(tries):
            try:
                return attempt()
            except KafkaError as e:
                if e.code not in self._COORD_RETRY_ERRS or i == tries - 1:
                    raise
                time.sleep(0.05 * (i + 1))

    def commit_offsets(self, group: str, topic: str, offsets: Mapping[int, int]) -> None:
        body = (
            Writer()
            .string(group)
            .i32(-1)  # generation (simple client: no group membership)
            .string("")  # member id
            .i64(-1)  # retention
            .array(
                [None],
                lambda w, _: w.string(topic).array(
                    sorted(offsets.items()),
                    lambda w2, po: w2.i32(po[0]).i64(po[1]).string(None),
                ),
            )
            .done()
        )
        def attempt() -> None:
            r = self._coordinator(group).request(API_OFFSET_COMMIT, 2, body)
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    err = r.i16()
                    if err != ERR_NONE:
                        raise KafkaError(err, "offset_commit")

        self._coordinator_retry(attempt)

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        n_parts = self.num_partitions(topic)
        body = (
            Writer()
            .string(group)
            .array(
                [None],
                lambda w, _: w.string(topic).array(
                    list(range(n_parts)), Writer.i32
                ),
            )
            .done()
        )
        def attempt() -> dict[int, int]:
            r = self._coordinator(group).request(API_OFFSET_FETCH, 1, body)
            out: dict[int, int] = {}
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    p = r.i32()
                    off = r.i64()
                    r.string()  # metadata
                    err = r.i16()
                    if err != ERR_NONE:
                        # a transient coordinator error must NOT read as "no
                        # committed offset" — start='committed' consumers would
                        # silently skip to the log end and drop the gap
                        raise KafkaError(err, "offset_fetch")
                    if off >= 0:
                        out[p] = off
            return out

        return self._coordinator_retry(attempt)

    def close(self) -> None:
        with self._meta_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()


def parse_bootstrap(uri: str) -> list[tuple[str, int]]:
    """kafka://h1:p1[,h2:p2,...] -> [(host, port), ...]"""
    rest = uri[len("kafka://") :]
    out = []
    for part in rest.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host:
            host, port = part, "9092"
        out.append((host, int(port)))
    return out
