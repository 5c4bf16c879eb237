"""In-process single-node Kafka protocol server for integration tests.

A copy of tests/kafka_testbroker.py with its imports re-pointed to the
PyTorch port (oryx_tpu_torch), so that a process without the JAX package
(chip_smoke.py's kafka phase) can run it; it holds nothing the original
lacks. The cross-package tests drive both brokers with both clients.

The analogue of the reference booting a real broker inside the test JVM
(framework/kafka-util src/test .../LocalKafkaBroker.java:44-60): the
kafka:// client in oryx_tpu_torch/bus/kafka.py is exercised over real TCP sockets
speaking the real wire format (request framing, header v1, record batch v2
with baseOffset rewrite on append — what an actual broker does), so the
bus semantics (keyed partitioning, offset commit/fetch, earliest/latest
replay) are tested end-to-end without a JVM in the image.

Supports the API (key, version) pairs the client pins. Single node, no
replication, logs in memory.
"""

from __future__ import annotations

import socket
import struct
import threading

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
    Reader,
    Writer,
)

_NODE_ID = 0

# record-batch v2 header layout constants (offsets within a batch blob)
_LAST_OFFSET_DELTA_AT = 23
_RECORD_COUNT_AT = 57


class _Partition:
    def __init__(self):
        # [(base_offset, last_offset, raw_batch_bytes)]
        self.batches: list[tuple[int, int, bytes]] = []
        self.end_offset = 0
        self.log_start = 0  # first retained offset (retention truncation)


class LocalKafkaTestBroker:
    """listen() -> serve on a free port until close().

    Fidelity knobs beyond the happy path (round-2 verdict: the protocol
    fake must be able to exercise what a real cluster throws at clients):

    - ``shared_from=other``: a second "node" sharing the first's log and
      group store — a 2-node cluster as far as coordinator movement is
      concerned.
    - ``move_coordinator(host, port)``: FindCoordinator now points there,
      and THIS node answers OffsetCommit/OffsetFetch with
      16 NOT_COORDINATOR until the client rediscovers.
    - ``inject_error(api_key, err, times)``: the next `times` requests of
      that API fail with `err` (per-partition where the API has them).
    - ``throttle_ms``: nonzero throttle_time_ms in produce/fetch
      responses (clients must parse and carry on).
    - ``append_raw_batch``: splice a foreign producer's record batch
      (e.g. gzip/snappy compressed) into the log verbatim.
    """

    def __init__(self, shared_from: "LocalKafkaTestBroker | None" = None):
        if shared_from is not None:
            self._topics = shared_from._topics
            self._group_offsets = shared_from._group_offsets
            self._lock = shared_from._lock
        else:
            self._topics: dict[str, list[_Partition]] = {}
            self._group_offsets: dict[tuple[str, str], dict[int, int]] = {}
            self._lock = threading.Lock()
        self._server: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._closed = False
        self.host = "127.0.0.1"
        self.port = 0
        self.throttle_ms = 0
        self._coordinator_addr: tuple[str, int] | None = None  # None = self
        self._injected: dict[int, list[int]] = {}  # api_key -> pending errs

    # -- fidelity knobs ----------------------------------------------------

    def move_coordinator(self, host: str, port: int) -> None:
        self._coordinator_addr = (host, port)

    def inject_error(self, api_key: int, err: int, times: int = 1) -> None:
        self._injected.setdefault(api_key, []).extend([err] * times)

    def _take_injected(self, api_key: int) -> int | None:
        errs = self._injected.get(api_key)
        if errs:
            return errs.pop(0)
        return None

    def append_raw_batch(self, topic: str, pidx: int, batch: bytes) -> int:
        """Append a foreign producer's wire batch verbatim (offsets
        rewritten like a real broker's log append). Returns base offset."""
        err, base = self._append(topic, pidx, batch)
        if err != ERR_NONE:
            raise RuntimeError(f"append failed: {err}")
        return base

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "LocalKafkaTestBroker":
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self.host, 0))
        self.port = self._server.getsockname()[1]
        self._server.listen(32)
        t = threading.Thread(target=self._accept_loop, daemon=True, name="kafka-test-accept")
        t.start()
        self._threads.append(t)
        return self

    @property
    def uri(self) -> str:
        return f"kafka://{self.host}:{self.port}"

    def close(self) -> None:
        self._closed = True
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- networking --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True, name="kafka-test-conn"
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closed:
                hdr = self._recv_exact(conn, 4)
                if hdr is None:
                    return
                (n,) = struct.unpack(">i", hdr)
                payload = self._recv_exact(conn, n)
                if payload is None:
                    return
                r = Reader(payload)
                api_key = r.i16()
                api_version = r.i16()
                corr = r.i32()
                r.string()  # client id
                body = self._dispatch(api_key, api_version, r)
                out = Writer().i32(corr).raw(body).done()
                conn.sendall(Writer().i32(len(out)).raw(out).done())
        except (OSError, EOFError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, api_key: int, version: int, r: Reader) -> bytes:
        handlers = {
            API_METADATA: self._h_metadata,
            API_PRODUCE: self._h_produce,
            API_FETCH: self._h_fetch,
            API_LIST_OFFSETS: self._h_list_offsets,
            API_CREATE_TOPICS: self._h_create_topics,
            API_DELETE_TOPICS: self._h_delete_topics,
            API_FIND_COORDINATOR: self._h_find_coordinator,
            API_OFFSET_COMMIT: self._h_offset_commit,
            API_OFFSET_FETCH: self._h_offset_fetch,
            API_API_VERSIONS: self._h_api_versions,
        }
        h = handlers.get(api_key)
        if h is None:
            raise ValueError(f"unsupported api {api_key}")
        return h(version, r)

    # -- handlers (response bodies must match the versions the client pins) -

    def _h_api_versions(self, version: int, r: Reader) -> bytes:
        w = Writer().i16(ERR_NONE)
        apis = [(k, 0, 10) for k in (0, 1, 2, 3, 8, 9, 10, 18, 19, 20)]
        return w.array(apis, lambda w2, a: w2.i16(a[0]).i16(a[1]).i16(a[2])).done()

    def _h_metadata(self, version: int, r: Reader) -> bytes:
        wanted = r.array(Reader.string)
        with self._lock:
            names = list(self._topics) if wanted is None else [t for t in wanted]
            w = Writer()
            w.array(
                [(_NODE_ID, self.host, self.port, None)],
                lambda w2, b: w2.i32(b[0]).string(b[1]).i32(b[2]).string(b[3]),
            )
            w.i32(_NODE_ID)  # controller
            w.i32(len(names))
            for name in names:
                parts = self._topics.get(name)
                w.i16(ERR_NONE if parts else ERR_UNKNOWN_TOPIC_OR_PARTITION)
                w.string(name)
                w.i8(0)  # is_internal
                w.i32(len(parts) if parts else 0)
                for i in range(len(parts) if parts else 0):
                    w.i16(ERR_NONE).i32(i).i32(_NODE_ID)
                    w.array([_NODE_ID], Writer.i32)  # replicas
                    w.array([_NODE_ID], Writer.i32)  # isr
            return w.done()

    def _h_create_topics(self, version: int, r: Reader) -> bytes:
        n = r.i32()
        results = []
        with self._lock:
            for _ in range(n):
                name = r.string()
                partitions = r.i32()
                r.i16()  # replication factor
                na = r.i32()  # assignments
                for _ in range(max(0, na)):
                    r.i32()
                    r.array(Reader.i32)
                nc = r.i32()  # configs
                for _ in range(max(0, nc)):
                    r.string()
                    r.string()
                if name in self._topics:
                    results.append((name, ERR_TOPIC_ALREADY_EXISTS))
                else:
                    self._topics[name] = [_Partition() for _ in range(max(1, partitions))]
                    results.append((name, ERR_NONE))
        r.i32()  # timeout
        return Writer().array(results, lambda w, t: w.string(t[0]).i16(t[1])).done()

    def _h_delete_topics(self, version: int, r: Reader) -> bytes:
        names = r.array(Reader.string) or []
        r.i32()  # timeout
        results = []
        with self._lock:
            for name in names:
                if name in self._topics:
                    del self._topics[name]
                    results.append((name, ERR_NONE))
                else:
                    results.append((name, ERR_UNKNOWN_TOPIC_OR_PARTITION))
        return Writer().array(results, lambda w, t: w.string(t[0]).i16(t[1])).done()

    def _h_produce(self, version: int, r: Reader) -> bytes:
        r.string()  # transactional id
        r.i16()  # acks
        r.i32()  # timeout
        n_topics = r.i32()
        responses = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            part_resps = []
            for _ in range(n_parts):
                pidx = r.i32()
                batch = r.bytes_()
                inj = self._take_injected(API_PRODUCE)
                if inj is not None:
                    part_resps.append((pidx, inj, -1))
                    continue
                err, base = self._append(topic, pidx, batch)
                part_resps.append((pidx, err, base))
            responses.append((topic, part_resps))
        w = Writer()
        w.i32(len(responses))
        for topic, part_resps in responses:
            w.string(topic)
            w.array(
                part_resps,
                lambda w2, pr: w2.i32(pr[0]).i16(pr[1]).i64(pr[2]).i64(-1),
            )
        w.i32(self.throttle_ms)  # throttle
        return w.done()

    def _append(self, topic: str, pidx: int, batch: bytes | None) -> tuple[int, int]:
        with self._lock:
            parts = self._topics.get(topic)
            if parts is None or pidx >= len(parts):
                return ERR_UNKNOWN_TOPIC_OR_PARTITION, -1
            part = parts[pidx]
            if not batch:
                return ERR_NONE, part.end_offset
            # a real broker assigns offsets by rewriting baseOffset in the
            # batch header, then stores the blob verbatim
            (last_delta,) = struct.unpack_from(">i", batch, _LAST_OFFSET_DELTA_AT)
            base = part.end_offset
            rewritten = struct.pack(">q", base) + batch[8:]
            part.batches.append((base, base + last_delta, rewritten))
            part.end_offset = base + last_delta + 1
            return ERR_NONE, base

    def _h_fetch(self, version: int, r: Reader) -> bytes:
        r.i32()  # replica
        r.i32()  # max wait
        r.i32()  # min bytes
        r.i32()  # max bytes
        r.i8()  # isolation
        n_topics = r.i32()
        out_topics = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            parts_out = []
            for _ in range(n_parts):
                pidx = r.i32()
                fetch_offset = r.i64()
                r.i32()  # partition max bytes
                inj = self._take_injected(API_FETCH)
                if inj is not None:
                    parts_out.append((pidx, inj, -1, b""))
                    continue
                parts_out.append((pidx, *self._fetch(topic, pidx, fetch_offset)))
            out_topics.append((topic, parts_out))
        w = Writer().i32(self.throttle_ms)  # throttle
        w.i32(len(out_topics))
        for topic, parts_out in out_topics:
            w.string(topic)
            w.i32(len(parts_out))
            for pidx, err, hw, blob in parts_out:
                w.i32(pidx).i16(err).i64(hw).i64(hw)
                w.i32(0)  # aborted txns (empty array)
                w.bytes_(blob if blob else None)
        return w.done()

    def _fetch(self, topic: str, pidx: int, offset: int) -> tuple[int, int, bytes]:
        with self._lock:
            parts = self._topics.get(topic)
            if parts is None or pidx >= len(parts):
                return ERR_UNKNOWN_TOPIC_OR_PARTITION, -1, b""
            part = parts[pidx]
            if offset < part.log_start:
                return 1, part.end_offset, b""  # OFFSET_OUT_OF_RANGE
            blobs = [
                raw
                for base, last, raw in part.batches
                if last >= offset
            ]
            return ERR_NONE, part.end_offset, b"".join(blobs)

    def truncate(self, topic: str, pidx: int, new_start: int) -> None:
        """Simulate retention: drop batches wholly below new_start."""
        with self._lock:
            part = self._topics[topic][pidx]
            part.log_start = max(part.log_start, new_start)
            part.batches = [
                (b, l, raw) for b, l, raw in part.batches if l >= part.log_start
            ]

    def _h_list_offsets(self, version: int, r: Reader) -> bytes:
        r.i32()  # replica
        n_topics = r.i32()
        out = []
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            parts = []
            for _ in range(n_parts):
                pidx = r.i32()
                ts = r.i64()
                with self._lock:
                    plist = self._topics.get(topic)
                    if plist is None or pidx >= len(plist):
                        parts.append((pidx, ERR_UNKNOWN_TOPIC_OR_PARTITION, -1))
                    else:
                        off = plist[pidx].log_start if ts == -2 else plist[pidx].end_offset
                        parts.append((pidx, ERR_NONE, off))
            out.append((topic, parts))
        w = Writer()
        w.i32(len(out))
        for topic, parts in out:
            w.string(topic)
            w.array(
                parts, lambda w2, p: w2.i32(p[0]).i16(p[1]).i64(-1).i64(p[2])
            )
        return w.done()

    def _h_find_coordinator(self, version: int, r: Reader) -> bytes:
        r.string()  # group
        inj = self._take_injected(API_FIND_COORDINATOR)
        if inj is not None:
            return Writer().i16(inj).i32(-1).string(None).i32(-1).done()
        host, port = self._coordinator_addr or (self.host, self.port)
        return Writer().i16(ERR_NONE).i32(_NODE_ID).string(host).i32(port).done()

    def _h_offset_commit(self, version: int, r: Reader) -> bytes:
        group = r.string()
        r.i32()  # generation
        r.string()  # member
        r.i64()  # retention
        n_topics = r.i32()
        # a demoted node refuses commits until the client rediscovers
        refuse = self._take_injected(API_OFFSET_COMMIT)
        if refuse is None and self._coordinator_addr is not None:
            refuse = 16  # NOT_COORDINATOR
        out = []
        with self._lock:
            for _ in range(n_topics):
                topic = r.string()
                n_parts = r.i32()
                parts = []
                store = self._group_offsets.setdefault((group, topic), {})
                for _ in range(n_parts):
                    pidx = r.i32()
                    off = r.i64()
                    r.string()  # metadata
                    if refuse is not None:
                        parts.append((pidx, refuse))
                        continue
                    store[pidx] = off
                    parts.append((pidx, ERR_NONE))
                out.append((topic, parts))
        w = Writer()
        w.i32(len(out))
        for topic, parts in out:
            w.string(topic)
            w.array(parts, lambda w2, p: w2.i32(p[0]).i16(p[1]))
        return w.done()

    def _h_offset_fetch(self, version: int, r: Reader) -> bytes:
        group = r.string()
        n_topics = r.i32()
        refuse = self._take_injected(API_OFFSET_FETCH)
        if refuse is None and self._coordinator_addr is not None:
            refuse = 16  # NOT_COORDINATOR
        out = []
        with self._lock:
            for _ in range(n_topics):
                topic = r.string()
                pidxs = r.array(Reader.i32) or []
                store = self._group_offsets.get((group, topic), {})
                out.append(
                    (topic, [(p, store.get(p, -1)) for p in pidxs])
                )
        w = Writer()
        w.i32(len(out))
        for topic, parts in out:
            w.string(topic)
            w.array(
                parts,
                lambda w2, p: w2.i32(p[0])
                .i64(-1 if refuse is not None else p[1])
                .string(None)
                .i16(refuse if refuse is not None else ERR_NONE),
            )
        return w.done()
