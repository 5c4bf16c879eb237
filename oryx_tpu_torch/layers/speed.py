"""Speed layer runtime: short-cadence incremental model updates (the
port's copy of oryx_tpu/layers/speed.py).

Mirrors the reference SpeedLayer (framework/oryx-lambda .../speed/
SpeedLayer.java:52-192 + SpeedLayerUpdate.java): a dedicated listener
thread replays the update topic from earliest into the user's
SpeedModelManager.consume() forever (so the in-memory model rebuilds on
restart), while the micro-batch loop drains the input topic every interval,
asks the manager for update messages (buildUpdates), and publishes them to
the update topic. The manager class comes from oryx.speed.model-manager-class.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref

from oryx_tpu_torch.api import SpeedModelManager
from oryx_tpu_torch.bus.api import ConsumeDataIterator, TopicProducer
from oryx_tpu_torch.bus.broker import get_broker
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common.classutil import load_instance_of
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.faults import configure_faults
from oryx_tpu_torch.common.metrics import MICROBATCH_BUCKETS, get_registry
from oryx_tpu_torch.common.quarantine import Quarantine
from oryx_tpu_torch.common.retry import configure_retry
from oryx_tpu_torch.common.tracing import configure_tracing, get_tracer
from oryx_tpu_torch.layers.watchdog import running_seconds, start_wedge_watchdog

log = logging.getLogger(__name__)


class SpeedLayer:
    def __init__(self, config: Config, manager: SpeedModelManager | None = None):
        self.config = config
        self.group = f"OryxGroup-{config.get_string('oryx.id', None) or 'speed'}-speed"
        self.input_uri = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.update_uri = config.get_string("oryx.update-topic.broker")
        self.update_topic = config.get_string("oryx.update-topic.message.topic")
        self.interval_sec = config.get_int("oryx.speed.streaming.generation-interval-sec", 10)
        if manager is not None:
            self.manager = manager
        else:
            cls_name = config.get_string("oryx.speed.model-manager-class")
            if not cls_name:
                raise ValueError("no oryx.speed.model-manager-class configured")
            self.manager = load_instance_of(cls_name, SpeedModelManager, config)

        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._input_consumer: ConsumeDataIterator | None = None
        self._update_consumer: ConsumeDataIterator | None = None
        self.batch_count = 0
        configure_tracing(config)
        configure_retry(config)
        configure_faults(config)
        # poison containment: a window whose build keeps failing rewinds
        # at most max-attempts times, then the layer bisects it to isolate
        # the records that deterministically break the build and diverts
        # them to the dead-letter store — the stream moves forward instead
        # of rewind-looping forever (the loop oryx_speed_failures_total
        # made visible). Deserialize-poison (records the app's cheap
        # validate_record rejects) is diverted before the build even runs.
        self.quarantine_max_attempts = config.get_int(
            "oryx.monitoring.quarantine.max-attempts", 2
        )
        self._quarantine = Quarantine(
            config.get_string(
                "oryx.monitoring.quarantine.dir", "/tmp/oryx_tpu/quarantine"
            ),
            "speed",
        )
        # sweep records only when the manager actually overrides a hook
        mcls = type(self.manager)
        self._validates = (
            mcls.validate_record is not SpeedModelManager.validate_record
            or mcls.validate_records is not SpeedModelManager.validate_records
        )
        self._window_attempts = 0
        self._failed_window: dict | None = None
        reg = get_registry()
        self._m_batches = reg.counter(
            "oryx_speed_batches_total", "Completed speed micro-batches"
        )
        self._m_records = reg.counter(
            "oryx_speed_input_records_total", "Input records consumed by the speed layer"
        )
        self._m_updates = reg.counter(
            "oryx_speed_updates_total", "Update messages published by the speed layer"
        )
        self._m_failures = reg.counter(
            "oryx_speed_failures_total",
            "Speed micro-batches whose update build raised (window rewound "
            "for reprocessing; a growing count is a rewind loop)",
        )
        self._m_duration = reg.histogram(
            "oryx_speed_batch_seconds",
            "Wall-clock per speed micro-batch",
            buckets=MICROBATCH_BUCKETS,
        )
        # wedge detection, same contract as the batch layer (layers/
        # batch.py): the fold-in kernels run on the device, a wedged
        # transport hangs them uncancellably — expose and log it
        self._batch_started: float | None = None
        self.watchdog_limit_sec = max(6.0 * self.interval_sec, 120.0)
        self.watchdog_poll_sec = 10.0
        ref = weakref.ref(self)
        reg.gauge(
            "oryx_speed_batch_running_seconds",
            "Seconds the in-flight speed micro-batch has been running (0 = idle)",
        ).set_function(lambda: running_seconds(ref, "_batch_started"))

    def ensure_streams(self) -> None:
        """Open consumers/producers now (otherwise lazily on first use).
        First-run consumers start at the live end of the input topic, like
        the reference's auto.offset.reset=latest direct stream. Idempotent:
        existing streams (and their positions) are kept."""
        if self._input_consumer is not None:
            return
        input_broker = get_broker(self.input_uri)
        update_broker = get_broker(self.update_uri)
        for broker, topic in ((input_broker, self.input_topic), (update_broker, self.update_topic)):
            if not broker.topic_exists(topic):
                raise RuntimeError(f"topic does not exist: {topic}")
        self._input_consumer = ConsumeDataIterator(
            input_broker, self.input_topic, group=self.group, start="committed"
        )
        # pin the start position durably: on a fresh group "committed" falls
        # back to the log END, so a crash before the first commit would
        # otherwise re-resolve to a later end and silently drop the gap
        self._input_consumer.commit()
        # model listener replays from earliest so the in-memory model
        # rebuilds after restart (SpeedLayer.java:99-110)
        self._update_consumer = ConsumeDataIterator(
            update_broker, self.update_topic, group=f"{self.group}-updates", start="earliest"
        )
        self._producer = TopicProducer(update_broker, self.update_topic)

    def run_batch(self) -> int:
        """One micro-batch synchronously: drain input, build updates,
        publish. Returns records processed. On failure the window is NOT
        committed — unlike the batch layer (which persists the window and
        retries over history), the speed tier keeps nothing, so committing
        past a failed build would silently drop those interactions; instead
        the consumer rewinds to the committed offsets and reprocesses."""
        if self._input_consumer is None:
            self.ensure_streams()
        tr = get_tracer()
        t_ingest = time.monotonic() if tr.enabled else 0.0
        window_start = self._input_consumer.positions()
        batch = self._input_consumer.poll_available()
        # deserialize-poison sweep: records the manager's validate hooks
        # reject are held aside and diverted on the COMMIT path below —
        # diverting before the build would write a fresh dead-letter copy
        # on every rewind attempt of a failing window
        bad: list = []
        if batch and self._validates:
            good, bad = [], []
            for km, ok in zip(batch, self.manager.validate_records(batch)):
                (good if ok else bad).append(km)
            batch = good
        if batch:
            # per-generation span tree: ingest -> build -> publish, so a
            # slow micro-batch shows WHERE the interval went (tf.data-style
            # stage attribution; empty polls record nothing)
            root = tr.start(
                "speed.batch", start=t_ingest or None, records=len(batch),
            )
            if root is not None and t_ingest:
                tr.record_interval("speed.ingest", t_ingest, parent=root)
            self._batch_started = time.monotonic()
            try:
                t_build = time.monotonic()
                with self._m_duration.time():
                    faults.fire("speed.build")
                    updates = list(self.manager.build_updates(batch))
                if root is not None:
                    tr.record_interval("speed.build", t_build, parent=root)
                t_pub = time.monotonic()
                if updates:
                    self._producer.send_batch(updates)
                if root is not None:
                    tr.record_interval("speed.publish", t_pub, parent=root)
                self._m_updates.inc(len(updates))
                self._window_attempts = 0
                self._failed_window = None
                tr.finish(root, updates=len(updates))
            except Exception as e:
                # rewind to where this window began (NOT the committed
                # offsets — on a fresh group those fall back to the log end,
                # which would silently drop the failed window)
                # a rewind loop would otherwise be invisible in /metrics:
                # neither batches nor records count on this path
                log.exception("speed update build failed; window will be reprocessed")
                self._m_failures.inc()
                tr.finish(root, error=True)
                if self._failed_window == window_start:
                    self._window_attempts += 1
                else:
                    self._window_attempts = 1
                    self._failed_window = dict(window_start)
                if self._window_attempts <= self.quarantine_max_attempts:
                    self._input_consumer.seek(window_start)
                    self.batch_count += 1
                    return len(batch)
                # bounded retries exhausted: the failure is deterministic
                # for this window. Bisect it to isolate the poison records,
                # divert them to the dead-letter store, publish what the
                # surviving records build, and move the stream forward.
                if not self._contain_poison(batch, window_start, e):
                    self.batch_count += 1
                    return len(batch)
            finally:
                self._batch_started = None
        if bad:
            # divert exactly once, on the path that commits past the
            # window. An unwritable quarantine dir rewinds the window and
            # propagates — quarantine must never silently drop data.
            try:
                self._quarantine.divert(bad, reason="validate_record rejected")
            except Exception:
                self._input_consumer.seek(window_start)
                raise
        self._input_consumer.commit()
        self.batch_count += 1
        self._m_batches.inc()
        self._m_records.inc(len(batch))
        return len(batch)

    def _contain_poison(self, batch, window_start, error: Exception) -> bool:
        """Last-resort containment for a window that failed its bounded
        retries: isolate and quarantine the poison records. Returns True
        when the stream may move past the window (caller then commits);
        False rewinds once more (isolation itself failed, e.g. the
        quarantine dir is unwritable — losing the dead letter would be
        silent data loss, so the window keeps its place in the stream)."""
        try:
            updates, poison = self._isolate_poison(batch)
            if len(poison) == len(batch) > 1:
                # EVERY record of a multi-record window "poison" is far
                # more likely an environmental outage (device down, OOM,
                # dead dependency) than N simultaneous poison records —
                # bulk-diverting live traffic would convert a transient
                # outage into silent data diversion. Keep rewinding (the
                # failure counter stays loud) and re-isolate once the
                # next attempt sees anything succeed. Single-record
                # windows still quarantine: blast radius one record,
                # and a bisect cannot distinguish further anyway.
                log.error(
                    "all %d records of the window fail in isolation — "
                    "treating as an environmental failure, not poison; "
                    "window will be reprocessed", len(batch),
                )
                self._input_consumer.seek(window_start)
                return False
            # publish BEFORE diverting: a publish failure rewinds the
            # window, and a dead letter already written would then be
            # re-written by the next bisect (duplicate quarantine entries
            # that replay re-ingests twice). The reverse risk — divert
            # failing after a successful publish — re-publishes updates
            # on the retry, which update-topic consumers must already
            # tolerate (they replay the topic from earliest on restart).
            if updates:
                self._producer.send_batch(updates)
            if poison:
                self._quarantine.divert(
                    poison, reason=f"speed build_updates raised: {error!r}"
                )
            self._m_updates.inc(len(updates))
        except Exception:
            log.exception(
                "poison isolation failed; window will be reprocessed"
            )
            self._input_consumer.seek(window_start)
            return False
        log.error(
            "window of %d record(s) contained after %d failed attempts: "
            "%d quarantined, %d update(s) published from the survivors",
            len(batch), self._window_attempts, len(poison), len(updates),
        )
        self._window_attempts = 0
        self._failed_window = None
        return True

    def _isolate_poison(self, batch):
        """Bisect the failed window down to the records whose singleton
        build still raises — O(P log N) builds for P poison records.
        Updates from the passing chunks are combined; chunk-boundary
        aggregation may differ slightly from the full-window build
        (honest degraded mode: the alternative was an infinite rewind)."""
        updates: list = []
        poison: list = []

        def walk(chunk) -> None:
            try:
                built = list(self.manager.build_updates(chunk))
            except Exception:
                if len(chunk) == 1:
                    poison.append(chunk[0])
                    return
                mid = len(chunk) // 2
                walk(chunk[:mid])
                walk(chunk[mid:])
                return
            updates.extend(built)

        walk(list(batch))
        return updates, poison

    def start(self) -> None:
        self.ensure_streams()

        def listen():
            try:
                self.manager.consume(self._update_consumer)
            except Exception:
                if not self._stop.is_set():
                    log.exception("speed model listener died")

        def loop():
            while not self._stop.wait(self.interval_sec):
                try:
                    self.run_batch()
                except Exception:
                    log.exception("speed micro-batch failed")

        t1 = threading.Thread(target=listen, name="oryx-speed-model-listener", daemon=True)
        t2 = threading.Thread(target=loop, name="oryx-speed", daemon=True)
        t1.start()
        t2.start()
        t3 = start_wedge_watchdog(
            self, "_batch_started", "speed micro-batch", log, "oryx-speed-watchdog"
        )
        self._threads = [t1, t2, t3]

    def await_termination(self) -> None:
        for t in self._threads:
            t.join()

    def close(self) -> None:
        self._stop.set()
        for c in (self._input_consumer, self._update_consumer):
            if c:
                c.close()
        self.manager.close()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
