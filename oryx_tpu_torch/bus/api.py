"""User-visible messaging types: KeyMessage, TopicProducer, blocking consumer.

Mirrors the reference SPI (framework/oryx-api .../api/KeyMessage.java,
TopicProducer.java) and kafka-util's ConsumeDataIterator
(.../kafka/util/ConsumeDataIterator.java:36-70): a blocking iterator over a
topic with exponential poll backoff and wakeup-on-close.
"""

from __future__ import annotations

import threading
from typing import Iterator, NamedTuple, TYPE_CHECKING

from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common.retry import retry_call

if TYPE_CHECKING:
    from oryx_tpu_torch.bus.broker import Broker


class KeyMessage(NamedTuple):
    key: str | None
    message: str


class TopicProducer:
    """Producer bound to one topic; partitions by key hash like the
    reference's TopicProducerImpl (framework/oryx-lambda
    .../lambda/TopicProducerImpl.java).

    Sends run under the shared bounded-retry contract (common/retry.py,
    site "bus.produce"): transient broker I/O failures are absorbed with
    backoff instead of failing the whole generation/micro-batch, and
    exhaustion propagates loudly. The fault harness injects here
    (faults.fire inside the retried closure, so chaos tests exercise the
    SAME recovery path a real flaky disk would take)."""

    def __init__(self, broker: "Broker", topic: str):
        self._broker = broker
        self._topic = topic

    @property
    def topic(self) -> str:
        return self._topic

    def send(self, key: str | None, message: str) -> None:
        def _do() -> None:
            faults.fire("bus.produce")
            self._broker.send(self._topic, key, message)

        retry_call("bus.produce", _do)

    def send_batch(self, records) -> None:
        """Batch append of (key, message) pairs — one lock round-trip per
        partition on file brokers; used for factor-row floods.

        The retry unit is ONE PARTITION, not the whole batch: retrying a
        whole multi-partition batch after a partial failure would
        re-append the partitions that already succeeded — duplicate
        records in persisted history. The file/mem brokers make the
        per-partition append exact (a single write rolled back on
        failure); kafka:// keeps Kafka's native at-least-once — an
        ambiguous failure (batch appended, response lost) can still
        duplicate within that one partition, exactly as any
        non-idempotent Kafka producer can. Grouping here uses the same
        partition_for the brokers use, so placement is unchanged."""
        from oryx_tpu_torch.bus.broker import partition_for

        records = list(records)
        if not records:
            return
        n_parts = self._broker.num_partitions(self._topic)
        by_part: dict[int, list] = {}
        for key, message in records:
            by_part.setdefault(partition_for(key, n_parts), []).append(
                (key, message)
            )
        for p, recs in by_part.items():

            def _do(p=p, recs=recs) -> None:
                faults.fire("bus.produce")
                self._broker.send_batch(self._topic, recs, partition=p)

            retry_call("bus.produce", _do)

    def close(self) -> None:
        pass


_POLL_BACKOFF_START_S = 0.001
_POLL_BACKOFF_MAX_S = 1.0


class ConsumeDataIterator(Iterator[KeyMessage]):
    """Blocking iterator over a topic for one consumer group.

    start: 'earliest' replays the whole log (how serving/speed rebuild
    models, ModelManagerListener.java:118-132), 'latest' tails new data,
    'committed' resumes from stored group offsets falling back to latest
    (the ZK-offset resume semantics of UpdateOffsetsFn.java:44-58).
    """

    def __init__(
        self,
        broker: "Broker",
        topic: str,
        group: str = "default",
        start: str = "latest",
        max_poll: int = 500,
    ):
        self._broker = broker
        self._topic = topic
        self._group = group
        self._max_poll = max_poll
        self._closed = threading.Event()
        # buffer of fetched-but-undelivered records: (partition, offset, km)
        self._buffer: list[tuple[int, int, KeyMessage]] = []
        self._buf_i = 0
        n_parts = broker.num_partitions(topic)
        if start == "earliest":
            self._fetch_pos = {p: 0 for p in range(n_parts)}
        elif start == "latest":
            self._fetch_pos = dict(enumerate(broker.end_offsets(topic)))
        elif start == "committed":
            committed = broker.get_offsets(group, topic)
            ends = broker.end_offsets(topic)
            self._fetch_pos = {p: committed.get(p, ends[p]) for p in range(n_parts)}
        else:
            raise ValueError(f"bad start: {start!r}")
        # delivered position trails the fetch position: commit() must record
        # only what the application has actually consumed, not what sits
        # prefetched in the buffer (Kafka position semantics)
        self._delivered_pos = dict(self._fetch_pos)

    def positions(self) -> dict[int, int]:
        """Next-to-deliver offset per partition (what commit() records)."""
        return dict(self._delivered_pos)

    def seek(self, positions: dict[int, int]) -> None:
        """Rewind/advance to explicit per-partition offsets, dropping any
        prefetched records — the recovery path when a window must be
        reprocessed after a failed build."""
        self._buffer = []
        self._buf_i = 0
        self._fetch_pos = dict(positions)
        self._delivered_pos = dict(positions)

    def commit(self, positions: dict[int, int] | None = None) -> None:
        """Record delivered positions durably. An explicit `positions`
        snapshot commits exactly that window edge — the batch layer's
        ingest-prefetch thread may have delivered records BEYOND the
        persisted window by commit time, and those must not be committed
        until their own generation persists them. Retried (site
        "bus.commit"): a transiently unwritable offset store must not
        fail a generation whose window is already persisted."""
        offsets = self._delivered_pos if positions is None else positions

        def _do() -> None:
            faults.fire("bus.commit")
            self._broker.commit_offsets(self._group, self._topic, offsets)

        retry_call("bus.commit", _do)

    def _read(self, partition: int, pos: int, n: int):
        """One broker read under the bounded-retry contract (site
        "bus.consume"): transient I/O is absorbed here; a persistent or
        deterministic failure (e.g. a corrupt wire frame,
        bus/kafkawire.WireDecodeError) propagates to fail that one
        consume with the original clear error."""

        def _do():
            faults.fire("bus.consume")
            return self._broker.read(self._topic, partition, pos, n)

        return retry_call("bus.consume", _do)

    def __next__(self) -> KeyMessage:
        while True:
            if self._buf_i < len(self._buffer):
                p, off, km = self._buffer[self._buf_i]
                self._buf_i += 1
                self._delivered_pos[p] = off + 1
                return km
            if self._closed.is_set():
                raise StopIteration
            self._buffer = []
            self._buf_i = 0
            backoff = _POLL_BACKOFF_START_S
            while not self._buffer:
                if self._closed.is_set():
                    raise StopIteration
                for p, pos in list(self._fetch_pos.items()):
                    recs = self._read(p, pos, self._max_poll)
                    if recs:
                        self._fetch_pos[p] = recs[-1][0] + 1
                        self._buffer.extend((p, o, KeyMessage(k, m)) for o, k, m in recs)
                if not self._buffer:
                    # exponential backoff 1ms -> 1s, the reference's poll loop
                    # (ConsumeDataIterator.java:52-62); wait() doubles as wakeup
                    if self._closed.wait(backoff):
                        raise StopIteration
                    backoff = min(backoff * 2, _POLL_BACKOFF_MAX_S)

    def end_offsets(self) -> dict[int, int]:
        """Current per-partition end offsets — the raw material for a
        pod-wide agreed generation window (layers/batch.py)."""
        return dict(enumerate(self._broker.end_offsets(self._topic)))

    def lag(self) -> int:
        """Records between this consumer's delivered positions and the
        topic's current end offsets — its backlog. The serving layer
        surfaces it on /healthz (``update_lag``) so a fleet front can see
        one replica falling behind model distribution while its siblings
        keep up, before the staleness bound ever trips."""
        ends = self._broker.end_offsets(self._topic)
        return sum(
            max(0, end - self._delivered_pos.get(p, 0))
            for p, end in enumerate(ends)
        )

    def poll_available(
        self, up_to: dict[int, int] | None = None
    ) -> list[KeyMessage]:
        """Non-blocking drain of everything currently in the log — the
        micro-batch read used by layer generation loops. Drained records
        count as delivered.

        up_to bounds the drain per partition (exclusive): records at or
        beyond the bound stay unconsumed for the next call. Pod members
        pass the leader's end-offset snapshot so every member's
        generation window holds the SAME records even though their
        timers fire at different moments."""
        out: list[KeyMessage] = []
        keep: list[tuple[int, int, KeyMessage]] = []
        for p, off, km in self._buffer[self._buf_i :]:
            if up_to is not None and off >= up_to.get(p, 0):
                keep.append((p, off, km))
                continue
            self._delivered_pos[p] = off + 1
            out.append(km)
        self._buffer = keep
        self._buf_i = 0
        for p in list(self._fetch_pos.keys()):
            limit = None if up_to is None else up_to.get(p, 0)
            while True:
                if limit is not None and self._fetch_pos[p] >= limit:
                    break
                n = self._max_poll
                if limit is not None:
                    n = min(n, limit - self._fetch_pos[p])
                recs = self._read(p, self._fetch_pos[p], n)
                if limit is not None:
                    # offsets may be sparse (compacted kafka logs): drop
                    # anything the window excludes and pin the position
                    past = [r for r in recs if r[0] >= limit]
                    recs = [r for r in recs if r[0] < limit]
                    if past and not recs:
                        self._fetch_pos[p] = limit
                        break
                if not recs:
                    break
                self._fetch_pos[p] = recs[-1][0] + 1
                self._delivered_pos[p] = recs[-1][0] + 1
                out.extend(KeyMessage(k, m) for _, k, m in recs)
        return out

    def close(self) -> None:
        self._closed.set()

    def __enter__(self) -> "ConsumeDataIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
