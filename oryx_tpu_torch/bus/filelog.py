"""Durable file-backed log broker: multi-process pub/sub over a shared
filesystem (the port's copy of oryx_tpu/bus/filelog.py; the bytes are the
same, so both packages share a topic).

This is the production data plane standing in for a Kafka cluster on a
single host / shared filesystem: each topic partition is an append-only
record log; producers append under an exclusive flock; consumers poll by
watching the file grow, so separate batch/speed/serving *processes* meet at
`file://<dir>` exactly like the reference's layers meet at a broker.

Record wire format (shared with the native C++ appender in native/oryxbus):

    [i32 key_len | -1 if null][key utf-8][u32 msg_len][msg utf-8]

little-endian, concatenated; the record offset index is rebuilt by scanning
on open and extended incrementally as the file grows.
"""

from __future__ import annotations

import fcntl
import json
import os
import struct
import threading
from pathlib import Path
from typing import Mapping

from oryx_tpu_torch.bus.broker import Broker, partition_for
from oryx_tpu_torch.common.ioutil import delete_recursively, mkdirs

_META = "meta.json"
_I32 = struct.Struct("<i")
_U32 = struct.Struct("<I")


def encode_record(key: str | None, message: str) -> bytes:
    mb = message.encode("utf-8")
    if key is None:
        return _I32.pack(-1) + _U32.pack(len(mb)) + mb
    kb = key.encode("utf-8")
    return _I32.pack(len(kb)) + kb + _U32.pack(len(mb)) + mb


class _PartitionIndex:
    """Byte positions of each record in one partition log, extended lazily.
    Guarded by its own lock so independent partitions scan concurrently."""

    def __init__(self, path: Path, native=None):
        self.path = path
        self.positions: list[int] = []
        self.scanned_to = 0
        self.native = native
        self.lock = threading.Lock()

    def _refresh_locked(self) -> None:
        try:
            size = self.path.stat().st_size
        except FileNotFoundError:
            return
        if size < self.scanned_to:
            # the file shrank (a writer rolled back a torn append we may
            # have indexed mid-flight): rebuild the index from scratch
            self.positions = []
            self.scanned_to = 0
            size = self.path.stat().st_size
        if size <= self.scanned_to:
            return
        if self.native is not None:
            pos_arr, scanned = self.native.scan(str(self.path), self.scanned_to)
            self.positions.extend(int(p) for p in pos_arr)
            self.scanned_to = scanned
            return
        with open(self.path, "rb") as f:
            # shared lock: don't scan through a writer's in-flight append or
            # its rollback window
            fcntl.flock(f.fileno(), fcntl.LOCK_SH)
            try:
                f.seek(self.scanned_to)
                pos = self.scanned_to
                while pos < size:
                    head = f.read(4)
                    if len(head) < 4:
                        break  # torn write in progress; stop at last full record
                    (klen,) = _I32.unpack(head)
                    skip = max(0, klen)
                    f.seek(skip, os.SEEK_CUR)
                    mhead = f.read(4)
                    if len(mhead) < 4:
                        break
                    (mlen,) = _U32.unpack(mhead)
                    end = pos + 4 + skip + 4 + mlen
                    if end > size:
                        break
                    f.seek(mlen, os.SEEK_CUR)
                    self.positions.append(pos)
                    pos = end
                self.scanned_to = pos
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    def end_offset(self) -> int:
        with self.lock:
            self._refresh_locked()
            return len(self.positions)

    def read(self, offset: int, max_records: int) -> list[tuple[int, str | None, str]]:
        with self.lock:
            self._refresh_locked()
            if offset >= len(self.positions):
                return []
            span = self.positions[offset : offset + max_records]
            out = []
            with open(self.path, "rb") as f:
                for i, pos in zip(range(offset, offset + len(span)), span):
                    f.seek(pos)
                    (klen,) = _I32.unpack(f.read(4))
                    key = f.read(klen).decode("utf-8") if klen >= 0 else None
                    (mlen,) = _U32.unpack(f.read(4))
                    msg = f.read(mlen).decode("utf-8")
                    out.append((i, key, msg))
            return out


class FileLogBroker(Broker):
    def __init__(self, root: str):
        self.root = mkdirs(root)
        self._lock = threading.Lock()
        self._indexes: dict[tuple[str, int], _PartitionIndex] = {}
        # (mtime, meta) per topic: keeps read+parse off the per-send hot
        # path while noticing cross-process recreation via mtime
        self._meta_cache: dict[str, tuple[int, dict]] = {}
        self._native = _maybe_native()

    # -- admin -------------------------------------------------------------

    def _topic_dir(self, topic: str) -> Path:
        if "/" in topic or topic.startswith("_"):
            raise ValueError(f"bad topic name: {topic!r}")
        return self.root / topic

    def create_topic(self, topic: str, partitions: int = 1, max_message_bytes: int = 1 << 24) -> None:
        d = self._topic_dir(topic)
        if (d / _META).exists():
            raise ValueError(f"topic exists: {topic}")
        mkdirs(d)
        for p in range(max(1, partitions)):
            (d / f"p{p}.log").touch()
        # pid-unique tmp + atomic replace: concurrent creators race benignly
        # (same content wins either way); the exists-check above is advisory
        tmp = d / f"{_META}.tmp{os.getpid()}"
        tmp.write_text(json.dumps({"partitions": max(1, partitions), "max_bytes": max_message_bytes}))
        os.replace(tmp, d / _META)

    def topic_exists(self, topic: str) -> bool:
        return (self._topic_dir(topic) / _META).exists()

    def delete_topic(self, topic: str) -> None:
        delete_recursively(self._topic_dir(topic))
        with self._lock:
            self._meta_cache.pop(topic, None)
            for k in [k for k in self._indexes if k[0] == topic]:
                del self._indexes[k]

    def _meta(self, topic: str) -> dict:
        path = self._topic_dir(topic) / _META
        try:
            mtime = path.stat().st_mtime_ns
        except FileNotFoundError:
            with self._lock:
                self._meta_cache.pop(topic, None)
            raise KeyError(f"no such topic: {topic}") from None
        cached = self._meta_cache.get(topic)
        # revalidate on mtime so a delete+recreate by another process (e.g.
        # with a different partition count) is noticed — a stat per send
        # instead of a read+parse per send
        if cached is not None and cached[0] == mtime:
            return cached[1]
        meta = json.loads(path.read_text())
        with self._lock:
            if topic in self._meta_cache:
                # topic was recreated by another process: cached partition
                # indexes point into the old logs — drop them
                for k in [k for k in self._indexes if k[0] == topic]:
                    del self._indexes[k]
            self._meta_cache[topic] = (mtime, meta)
        return meta

    def num_partitions(self, topic: str) -> int:
        return int(self._meta(topic)["partitions"])

    # -- data --------------------------------------------------------------

    def send(self, topic: str, key: str | None, message: str, partition: int | None = None) -> None:
        meta = self._meta(topic)
        if len(message.encode("utf-8")) > meta["max_bytes"]:
            raise ValueError(f"message exceeds max size for {topic}")
        p = partition if partition is not None else partition_for(key, meta["partitions"])
        path = self._topic_dir(topic) / f"p{p}.log"
        if self._native is not None:
            self._native.append(str(path), key, message)
        else:
            self._append_raw(path, encode_record(key, message))

    @staticmethod
    def _append_raw(path: Path, rec: bytes) -> None:
        # Unbuffered os.write under O_APPEND + flock: a buffered file object
        # would re-flush leftover bytes at close() after a failed write,
        # appending garbage past our rollback. One raw write, and on a short
        # write roll back to the pre-append size while still holding the
        # lock — a torn record mid-log would stall every scanner forever.
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                pre = os.fstat(fd).st_size
                try:
                    wrote = os.write(fd, rec)
                except OSError:
                    os.ftruncate(fd, pre)
                    raise
                if wrote != len(rec):
                    os.ftruncate(fd, pre)
                    raise OSError(f"short append to {path}")
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)

    def send_batch(self, topic: str, records, partition: int | None = None) -> None:
        """Append many (key, message) records with one lock acquisition per
        partition — the path for high-volume publishes like streaming every
        ALS factor row to the update topic."""
        meta = self._meta(topic)
        by_part: dict[int, list[bytes]] = {}
        for key, message in records:
            if len(message.encode("utf-8")) > meta["max_bytes"]:
                raise ValueError(f"message exceeds max size for {topic}")
            p = partition if partition is not None else partition_for(key, meta["partitions"])
            by_part.setdefault(p, []).append(encode_record(key, message))
        for p, recs in by_part.items():
            path = self._topic_dir(topic) / f"p{p}.log"
            blob = b"".join(recs)
            if self._native is not None:
                self._native.append_batch(str(path), blob)
            else:
                self._append_raw(path, blob)

    def _index(self, topic: str, partition: int) -> _PartitionIndex:
        with self._lock:
            k = (topic, partition)
            if k not in self._indexes:
                self._indexes[k] = _PartitionIndex(
                    self._topic_dir(topic) / f"p{partition}.log", self._native
                )
            return self._indexes[k]

    def read(self, topic: str, partition: int, offset: int, max_records: int) -> list[tuple[int, str | None, str]]:
        self._meta(topic)
        return self._index(topic, partition).read(offset, max_records)

    def end_offsets(self, topic: str) -> list[int]:
        n = self.num_partitions(topic)
        return [self._index(topic, p).end_offset() for p in range(n)]

    # -- offsets -----------------------------------------------------------

    def _offsets_path(self, group: str, topic: str) -> Path:
        from urllib.parse import quote

        d = mkdirs(self.root / "_offsets")
        # percent-encode each part: '@' can't appear in quoted output, so
        # distinct (group, topic) pairs can't collide on one file
        return d / f"{quote(group, safe='')}@{quote(topic, safe='')}.json"

    def commit_offsets(self, group: str, topic: str, offsets: Mapping[int, int]) -> None:
        path = self._offsets_path(group, topic)
        # flock a sidecar so concurrent committers in one group merge rather
        # than overwrite each other's partition offsets
        lock_path = path.with_suffix(".lock")
        with open(lock_path, "w") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                cur = self.get_offsets(group, topic)
                cur.update({int(k): int(v) for k, v in offsets.items()})
                tmp = path.with_suffix(f".tmp{os.getpid()}")
                tmp.write_text(json.dumps({str(k): v for k, v in cur.items()}))
                os.replace(tmp, path)
            finally:
                fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        try:
            raw = json.loads(self._offsets_path(group, topic).read_text())
        except FileNotFoundError:
            return {}
        return {int(k): int(v) for k, v in raw.items()}


_NATIVE_CACHE: object | None = None
_NATIVE_TRIED = False


def _maybe_native():
    """Load the C++ appender (native/oryxbus) if built; else pure Python."""
    global _NATIVE_CACHE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            from oryx_tpu_torch.bus.native import NativeAppender

            _NATIVE_CACHE = NativeAppender.load()
        except Exception:
            _NATIVE_CACHE = None
    return _NATIVE_CACHE
