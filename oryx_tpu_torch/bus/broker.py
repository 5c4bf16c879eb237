"""Broker interface + URI resolution + topic admin helpers (the port's
copy of oryx_tpu/bus/broker.py).

The admin surface mirrors the reference's KafkaUtils
(framework/kafka-util .../kafka/util/KafkaUtils.java:49-140):
maybe_create_topic / topic_exists / delete_topic / set_offsets, with the
offset store folded into the broker (the ZooKeeper analogue).
"""

from __future__ import annotations

import threading
import zlib
from abc import ABC, abstractmethod
from typing import Mapping


def partition_for(key: str | None, num_partitions: int) -> int:
    """Stable key->partition mapping (the input topic is keyed by message
    hash, AbstractOryxResource.java:65-69). crc32 not Python hash(): must be
    stable across processes and runs."""
    if num_partitions <= 1:
        return 0
    if key is None:
        return 0
    return zlib.crc32(key.encode("utf-8")) % num_partitions


class Broker(ABC):
    """Partitioned append-only message log + consumer-group offset store."""

    # -- admin -------------------------------------------------------------

    @abstractmethod
    def create_topic(self, topic: str, partitions: int = 1, max_message_bytes: int = 1 << 24) -> None: ...

    @abstractmethod
    def topic_exists(self, topic: str) -> bool: ...

    @abstractmethod
    def delete_topic(self, topic: str) -> None: ...

    @abstractmethod
    def num_partitions(self, topic: str) -> int: ...

    # -- data plane --------------------------------------------------------

    @abstractmethod
    def send(self, topic: str, key: str | None, message: str, partition: int | None = None) -> None: ...

    def send_batch(self, topic: str, records, partition: int | None = None) -> None:
        """Append many (key, message) records; brokers override to batch
        under one lock. Default just loops send()."""
        for key, message in records:
            self.send(topic, key, message, partition)

    @abstractmethod
    def read(self, topic: str, partition: int, offset: int, max_records: int) -> list[tuple[int, str | None, str]]:
        """Records at [offset, offset+max_records) as (offset, key, message);
        empty list if none available yet."""

    @abstractmethod
    def end_offsets(self, topic: str) -> list[int]:
        """Next-write offset per partition."""

    # -- offset store (ZooKeeper analogue) ---------------------------------

    @abstractmethod
    def commit_offsets(self, group: str, topic: str, offsets: Mapping[int, int]) -> None: ...

    @abstractmethod
    def get_offsets(self, group: str, topic: str) -> dict[int, int]: ...

    def close(self) -> None:
        pass


_kafka_brokers: dict[str, "Broker"] = {}
_kafka_lock = threading.Lock()


def get_broker(uri: str) -> Broker:
    """Resolve a broker URI: mem://<name>, file://<dir> / file:/<dir>, a
    bare path, or kafka://host:port[,host:port...] (a real cluster)."""
    if uri.startswith("mem://"):
        from oryx_tpu_torch.bus.inproc import InProcBroker

        return InProcBroker.named(uri[len("mem://") :] or "default")
    if uri.startswith("kafka://"):
        from oryx_tpu_torch.bus.kafka import KafkaBroker, parse_bootstrap

        # one client (connection pool) per cluster URI
        with _kafka_lock:
            b = _kafka_brokers.get(uri)
            if b is None:
                b = _kafka_brokers[uri] = KafkaBroker(parse_bootstrap(uri))
            return b
    if uri.startswith("file:") or uri.startswith("/") or uri.startswith("."):
        from oryx_tpu_torch.common.ioutil import strip_scheme
        from oryx_tpu_torch.bus.filelog import FileLogBroker

        return FileLogBroker(strip_scheme(uri))
    raise ValueError(f"unsupported broker URI: {uri!r}")


class topics:
    """KafkaUtils-style static admin helpers over a broker URI."""

    @staticmethod
    def maybe_create(uri: str, topic: str, partitions: int = 1, max_message_bytes: int = 1 << 24) -> None:
        b = get_broker(uri)
        if not b.topic_exists(topic):
            try:
                b.create_topic(topic, partitions, max_message_bytes)
            except ValueError:
                # lost a cross-process create race — the topic now exists,
                # which is all "maybe" promises
                pass

    @staticmethod
    def exists(uri: str, topic: str) -> bool:
        return get_broker(uri).topic_exists(topic)

    @staticmethod
    def delete(uri: str, topic: str) -> None:
        b = get_broker(uri)
        if b.topic_exists(topic):
            b.delete_topic(topic)
