"""In-process broker: the test-fixture backbone.

The reference's tests boot a real single-node Kafka broker inside the JVM
(framework/kafka-util src/test LocalKafkaBroker.java:44-60); this broker
plays that role in-process — a full implementation of the Broker contract
(partitions, offsets, groups), just backed by lists under a lock, shared by
name so producer and consumer code in different threads meet at `mem://x`.
"""

from __future__ import annotations

import threading
from typing import Mapping

from oryx_tpu_torch.bus.broker import Broker, partition_for


class InProcBroker(Broker):
    _registry: dict[str, "InProcBroker"] = {}
    _registry_lock = threading.Lock()

    @classmethod
    def named(cls, name: str) -> "InProcBroker":
        with cls._registry_lock:
            if name not in cls._registry:
                cls._registry[name] = InProcBroker()
            return cls._registry[name]

    @classmethod
    def reset_all(cls) -> None:
        with cls._registry_lock:
            cls._registry.clear()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # topic -> list of partitions, each a list of (key, message)
        self._logs: dict[str, list[list[tuple[str | None, str]]]] = {}
        self._max_bytes: dict[str, int] = {}
        # (group, topic) -> {partition: offset}
        self._offsets: dict[tuple[str, str], dict[int, int]] = {}

    # -- admin -------------------------------------------------------------

    def create_topic(self, topic: str, partitions: int = 1, max_message_bytes: int = 1 << 24) -> None:
        with self._lock:
            if topic in self._logs:
                raise ValueError(f"topic exists: {topic}")
            self._logs[topic] = [[] for _ in range(max(1, partitions))]
            self._max_bytes[topic] = max_message_bytes

    def topic_exists(self, topic: str) -> bool:
        with self._lock:
            return topic in self._logs

    def delete_topic(self, topic: str) -> None:
        with self._lock:
            self._logs.pop(topic, None)
            self._max_bytes.pop(topic, None)
            for k in [k for k in self._offsets if k[1] == topic]:
                del self._offsets[k]

    def num_partitions(self, topic: str) -> int:
        with self._lock:
            self._check(topic)
            return len(self._logs[topic])

    # -- data --------------------------------------------------------------

    def send(self, topic: str, key: str | None, message: str, partition: int | None = None) -> None:
        with self._lock:
            self._check(topic)
            parts = self._logs[topic]
            if len(message.encode("utf-8")) > self._max_bytes[topic]:
                raise ValueError(f"message exceeds max size for {topic}")
            p = partition if partition is not None else partition_for(key, len(parts))
            parts[p].append((key, message))

    def read(self, topic: str, partition: int, offset: int, max_records: int) -> list[tuple[int, str | None, str]]:
        with self._lock:
            self._check(topic)
            log = self._logs[topic][partition]
            chunk = log[offset : offset + max_records]
            return [(offset + i, k, m) for i, (k, m) in enumerate(chunk)]

    def end_offsets(self, topic: str) -> list[int]:
        with self._lock:
            self._check(topic)
            return [len(p) for p in self._logs[topic]]

    # -- offsets -----------------------------------------------------------

    def commit_offsets(self, group: str, topic: str, offsets: Mapping[int, int]) -> None:
        with self._lock:
            self._offsets.setdefault((group, topic), {}).update(offsets)

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        with self._lock:
            return dict(self._offsets.get((group, topic), {}))

    def _check(self, topic: str) -> None:
        if topic not in self._logs:
            raise KeyError(f"no such topic: {topic}")
