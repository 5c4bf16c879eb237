"""Batch layer runtime: the long-cadence full-model rebuild loop (the
port's copy of oryx_tpu/layers/batch.py).

Mirrors the reference BatchLayer (framework/oryx-lambda .../batch/
BatchLayer.java:48-206 + BatchUpdateFunction.java:50-171): per generation —
drain the input-topic window, load ALL past data, invoke the user's update
(usually an MLUpdate) with a synchronous update-topic producer, persist the
window, commit consumer offsets, and enforce data/model TTLs. The user
update class is loaded reflectively from oryx.batch.update-class
(BatchLayer.java:172-204).

Pod members (``oryx.compute.distributed.*``, cli.py pod) agree each
generation's window pod-wide (``_pod_window``); only the leader (process
0) owns the canonical storage dirs and publishes.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref

from oryx_tpu_torch.api import BatchLayerUpdate
from oryx_tpu_torch.bus.api import ConsumeDataIterator, TopicProducer
from oryx_tpu_torch.bus.broker import get_broker
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common.classutil import load_instance_of
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.faults import configure_faults
from oryx_tpu_torch.common.ioutil import delete_older_than, strip_scheme
from oryx_tpu_torch.common.metrics import GENERATION_BUCKETS, get_registry, maybe_profile
from oryx_tpu_torch.common.quarantine import Quarantine
from oryx_tpu_torch.common.retry import configure_retry
from oryx_tpu_torch.common.tracing import configure_tracing, get_tracer, swap_current
from oryx_tpu_torch.layers.datastore import LazyPastData, save_generation
from oryx_tpu_torch.layers.watchdog import running_seconds, start_wedge_watchdog

log = logging.getLogger(__name__)


class _NullProducer:
    """Update-topic sink for non-leader pod members: they take part in the
    collective training but must not double-publish MODEL/UP messages
    (cli.py pod; see the leader note in BatchLayer.__init__)."""

    def __init__(self, topic: str):
        self._topic = topic

    @property
    def topic(self) -> str:
        return self._topic

    def send(self, key, message) -> None:
        pass

    def send_batch(self, records) -> None:
        pass

    def close(self) -> None:
        pass


class BatchLayer:
    def __init__(self, config: Config, update: BatchLayerUpdate | None = None):
        self.config = config
        self.group = f"OryxGroup-{config.get_string('oryx.id', None) or 'batch'}-batch"
        self.input_uri = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.update_uri = config.get_string("oryx.update-topic.broker")
        self.update_topic = config.get_string("oryx.update-topic.message.topic")
        self.interval_sec = config.get_int("oryx.batch.streaming.generation-interval-sec")
        self.data_dir = strip_scheme(config.get_string("oryx.batch.storage.data-dir"))
        self.model_dir = strip_scheme(config.get_string("oryx.batch.storage.model-dir"))
        # Pod members (cli.py pod): every compute process consumes the
        # FULL input stream (brokers here don't split partitions within a
        # group), so all members train the same data in lockstep and the
        # mesh collectives line up. Only the leader (process 0) owns the
        # canonical storage dirs and the update-topic publishes; the
        # others keep their writes in per-process subdirs and publish
        # nothing — the analogue of Spark executors computing while only
        # the job's coordinating process writes results.
        from oryx_tpu_torch.parallel.distributed import DistributedConfig

        dc = DistributedConfig.from_config(config)
        self.is_leader = dc.num_processes <= 1 or dc.process_id == 0
        self._pod_member = dc.num_processes > 1
        if not self.is_leader:
            import os as _os

            self.data_dir = _os.path.join(self.data_dir, f"proc-{dc.process_id}")
            self.model_dir = _os.path.join(self.model_dir, f"proc-{dc.process_id}")
            # own consumer group per non-leader: sharing the leader's
            # group would let a faster member's offset commit advance
            # past records the leader has not persisted yet (input loss
            # on restart), and on kafka:// a shared group would split
            # partitions when every member must see the full stream
            self.group = f"{self.group}-proc{dc.process_id}"
        self.max_age_data = config.get_int("oryx.batch.storage.max-age-data-hours", -1)
        self.max_age_model = config.get_int("oryx.batch.storage.max-age-model-hours", -1)
        if update is not None:
            self.update = update
        else:
            cls_name = config.get_string("oryx.batch.update-class")
            if not cls_name:
                raise ValueError("no oryx.batch.update-class configured")
            self.update = load_instance_of(cls_name, BatchLayerUpdate, config)

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        self._consumer: ConsumeDataIterator | None = None
        self.generation_count = 0
        # ingest/compute pipeline: while a model build holds the device, a
        # background thread keeps draining the input topic so the NEXT
        # generation starts with its window already read and decoded.
        # Disabled for pod members — the pod window is agreed from raw
        # consumer positions, which prefetch would skew. Commit safety:
        # run_generation commits the explicit pre-build window edge, so
        # prefetched records stay uncommitted until THEIR window persists.
        self.prefetch_enabled = (
            config.get_bool(
                "oryx.batch.storage.incremental.prefetch.enabled", True
            )
            and not self._pod_member
        )
        self.prefetch_max_records = config.get_int(
            "oryx.batch.storage.incremental.prefetch.max-records", 500_000
        )
        self._prefetched: list = []
        self._prefetch_stop: threading.Event | None = None
        self._prefetch_thread: threading.Thread | None = None
        configure_tracing(config)
        configure_retry(config)
        configure_faults(config)
        # deserialize-poison containment: a record that can never parse
        # must not enter persisted history, where every later from-scratch
        # rebuild would re-read it forever. When the update overrides
        # validate_record, each window is swept once before persisting and
        # rejects divert to the dead-letter store (common/quarantine.py).
        self._quarantine = Quarantine(
            config.get_string(
                "oryx.monitoring.quarantine.dir", "/tmp/oryx_tpu/quarantine"
            ),
            "batch",
        )
        ucls = type(self.update)
        self._validates = (
            ucls.validate_record is not BatchLayerUpdate.validate_record
            or ucls.validate_records is not BatchLayerUpdate.validate_records
        )
        self._profile_dir = config.get_string("oryx.monitoring.profile-dir", None)
        reg = get_registry()
        self._m_generations = reg.counter(
            "oryx_batch_generations_total", "Completed batch generations"
        )
        self._m_records = reg.counter(
            "oryx_batch_input_records_total", "Input records consumed by the batch layer"
        )
        self._m_failures = reg.counter(
            "oryx_batch_build_failures_total", "Batch generations whose model build raised"
        )
        self._m_duration = reg.histogram(
            "oryx_batch_generation_seconds",
            "Wall-clock per batch generation (model build)",
            buckets=GENERATION_BUCKETS,
        )
        # wedge detection: a device call inside a model build can hang
        # forever on a broken accelerator transport; the gauge lets a
        # scrape see a stuck generation, and the watchdog (start()) logs
        # it — in-process cancellation of a hung C call is impossible, so
        # detection + loud telemetry is the honest contract (the
        # reference leaned on the Spark UI for the same visibility)
        self._gen_started: float | None = None
        self.watchdog_limit_sec = max(2.0 * self.interval_sec, 600.0)
        self.watchdog_poll_sec = 30.0
        # weak ref + single read: the process-global registry must not pin
        # this layer alive (serving/app.py gauge pattern), and the running
        # generation can finish between a None-check and the subtraction
        ref = weakref.ref(self)
        reg.gauge(
            "oryx_batch_generation_running_seconds",
            "Seconds the in-flight batch generation has been running (0 = idle)",
        ).set_function(lambda: running_seconds(ref, "_gen_started"))

    def ensure_streams(self) -> None:
        """Open consumers/producers now (otherwise lazily on first use).
        First-run consumers start at the live end of the input topic, like
        the reference's auto.offset.reset=latest direct stream. Idempotent:
        existing streams (and their positions) are kept."""
        if self._consumer is not None:
            return
        input_broker = get_broker(self.input_uri)
        update_broker = get_broker(self.update_uri)
        # verify topics exist before starting, like AbstractSparkLayer's
        # pre-start check (AbstractSparkLayer.java:176-183)
        for broker, topic in ((input_broker, self.input_topic), (update_broker, self.update_topic)):
            if not broker.topic_exists(topic):
                raise RuntimeError(f"topic does not exist: {topic}")
        self._consumer = ConsumeDataIterator(
            input_broker, self.input_topic, group=self.group, start="committed"
        )
        # pin the start position durably: on a fresh group "committed" falls
        # back to the log END, so a crash before the first generation commit
        # would otherwise re-resolve to a LATER end and drop the gap
        self._consumer.commit()
        if self.is_leader:
            self._producer = TopicProducer(update_broker, self.update_topic)
        else:
            self._producer = _NullProducer(self.update_topic)

    def _pod_window(self, ts: int) -> tuple[int, "dict[int, int] | None"]:
        """Agree the generation boundary pod-wide — BOTH edges. Members'
        timers fire at different moments, and an unsynchronized
        poll_available() would hand each member a DIFFERENT record set —
        mismatched factor shapes under the pod mesh wedge the collectives.
        So every member allgathers (timestamp, start positions, end
        offsets) and adopts the leader's row: non-leaders seek() to the
        leader's positions (their own start='committed' resolves
        independently — to their own log END at their own startup instant
        on a fresh group, or to whatever their per-process group last
        committed), then every member drains to the leader's END. Same
        window, same split timestamp, everywhere. The allgather doubles as
        the generation barrier that aligns the members' cadence. The port's
        host_allgather carries int64 whole. Single process: no-op."""
        if not self._pod_member:
            return ts, None
        from oryx_tpu_torch.parallel.distributed import host_allgather, process_count

        if process_count() <= 1:
            return ts, None
        import numpy as np

        ends = self._consumer.end_offsets()
        starts = self._consumer.positions()
        parts = sorted(ends)
        vals = (
            [ts]
            + [starts.get(p, 0) for p in parts]
            + [ends[p] for p in parts]
        )
        agreed = [int(v) for v in host_allgather(np.asarray(vals, dtype=np.int64))[0]]
        n = len(parts)
        lead_starts = {p: agreed[1 + i] for i, p in enumerate(parts)}
        lead_ends = {p: agreed[1 + n + i] for i, p in enumerate(parts)}
        if not self.is_leader and starts != lead_starts:
            log.info(
                "pod member seeking to leader start positions %s", lead_starts
            )
            self._consumer.seek(lead_starts)
        return agreed[0], lead_ends

    def run_generation(self, timestamp_ms: int | None = None) -> int:
        """Execute one batch generation synchronously; returns the number of
        new records processed. Public so tests and manual/one-shot builds
        drive generations directly."""
        if self._consumer is None:
            self.ensure_streams()
        ts = timestamp_ms if timestamp_ms is not None else int(time.time() * 1000)
        ts, up_to = self._pod_window(ts)
        tr = get_tracer()
        t_ingest = time.monotonic() if tr.enabled else 0.0
        prefetched, self._prefetched = self._prefetched, []
        new_data = prefetched + self._consumer.poll_available(up_to=up_to)
        # the window edge to commit: positions BEFORE the build, so the
        # ingest-prefetch thread (running during the build) cannot push
        # unpersisted records past the committed offsets
        window_end = self._consumer.positions()
        if new_data and self._validates:
            new_data = self._divert_invalid(new_data)
        # history is handed over LAZILY: an incremental update (persistent
        # aggregate snapshot, ml/update.py) never reads it at all; the
        # from-scratch fallback pays the streamed read on first touch
        past_data = LazyPastData(self.data_dir)
        root = None
        if new_data or past_data:
            # per-generation span tree: ingest -> build -> persist. The
            # build span is installed as the thread-current span so
            # MLUpdate's publish stamp carries this generation's trace
            # context onto the update topic (common/freshness.py).
            root = tr.start(
                "batch.generation", start=t_ingest or None, generation=ts,
                new_records=len(new_data),
            )
            if root is not None and t_ingest:
                tr.record_interval("batch.ingest", t_ingest, parent=root)
            self._gen_started = time.monotonic()
            self._start_prefetch()
            try:
                t_build = time.monotonic()
                prev = swap_current(root) if root is not None else None
                try:
                    with self._m_duration.time(), maybe_profile(self._profile_dir, "batch-gen"):
                        faults.fire("batch.build")
                        self.update.run_update(
                            ts, new_data, past_data, self.model_dir, self._producer
                        )
                finally:
                    if root is not None:
                        swap_current(prev)
                        tr.record_interval("batch.build", t_build, parent=root)
                        if past_data.known_len() is not None:
                            root.attrs["past_records"] = past_data.known_len()
            except Exception:
                # a failed build must not lose the window: persist + commit
                # still run, and the next generation retries over history
                log.exception("model build failed at generation %d", ts)
                self._m_failures.inc()
                if root is not None:
                    root.attrs["error"] = True
            finally:
                self._stop_prefetch()
                self._gen_started = None
        else:
            log.info("generation %d: no data yet", ts)
        t_persist = time.monotonic() if root is not None else 0.0
        save_generation(self.data_dir, ts, new_data)
        self._consumer.commit(window_end)
        # window durable + offsets committed: state the update staged
        # during the build (aggregate snapshot) may now become visible
        self.update.finalize_generation(ts)
        if root is not None:
            tr.record_interval("batch.persist", t_persist, parent=root)
            tr.finish(root)
        delete_older_than(self.data_dir, self.max_age_data)
        delete_older_than(self.model_dir, self.max_age_model)
        self.generation_count += 1
        self._m_generations.inc()
        self._m_records.inc(len(new_data))
        return len(new_data)

    def _divert_invalid(self, records: list) -> list:
        """Deserialize-poison sweep, once per window before it persists:
        records the update's validate_record rejects go to the dead-letter
        store; the rest proceed into the build and persisted history. An
        unwritable quarantine dir re-queues the WHOLE window in front of
        the next generation (nothing may be dropped silently) and
        propagates — offsets stay uncommitted. Divert-before-commit is
        deliberate at-least-once: a crash between the divert and the
        offset commit re-diverts the bad records on redelivery
        (duplicate dead letters); the reverse order would LOSE them
        outright when a crash lands between commit and divert."""
        good, bad = [], []
        for km, ok in zip(records, self.update.validate_records(records)):
            (good if ok else bad).append(km)
        if bad:
            try:
                self._quarantine.divert(bad, reason="validate_record rejected")
            except Exception:
                # mutate in place, never rebind: the prefetch thread
                # extends this same list object, and a rebind would strand
                # anything it appended between the copy and the swap
                self._prefetched[:0] = records
                raise
        return good

    def _start_prefetch(self) -> None:
        """Ingest/compute overlap: drain the input topic on a background
        thread while the model build holds the device, so the next
        generation's window is already read and decoded when its timer
        fires. Bounded by prefetch-max-records."""
        if not self.prefetch_enabled:
            return
        stop = threading.Event()

        def loop():
            while not stop.wait(0.05):
                if len(self._prefetched) >= self.prefetch_max_records:
                    continue
                recs = self._consumer.poll_available()
                if recs:
                    self._prefetched.extend(recs)

        self._prefetch_stop = stop
        self._prefetch_thread = threading.Thread(
            target=loop, name="oryx-batch-prefetch", daemon=True
        )
        self._prefetch_thread.start()

    def _stop_prefetch(self) -> None:
        # local snapshots: close() and the generation loop's finally can
        # both land here; the attributes may be None-ed under us
        stop, thread = self._prefetch_stop, self._prefetch_thread
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=10)
            if thread.is_alive():
                # wait it out, loudly: proceeding would race the zombie's
                # in-flight poll on the shared consumer — window offsets
                # could be committed for records that never reach a
                # persisted window (permanent input loss). poll_available
                # is non-blocking by design, so this resolves as soon as
                # the slow drain returns.
                log.warning(
                    "prefetch thread still draining after 10s; waiting "
                    "(a poll this slow usually means storage contention)"
                )
                thread.join()
        self._prefetch_stop = None
        self._prefetch_thread = None

    def start(self) -> None:
        """Spawn the generation-interval loop (BatchLayer.start)."""
        self.ensure_streams()

        def loop():
            while not self._stop.wait(self.interval_sec):
                try:
                    self.run_generation()
                except Exception:
                    log.exception("generation failed")

        self._thread = threading.Thread(target=loop, name="oryx-batch", daemon=True)
        self._thread.start()

        self._watchdog = start_wedge_watchdog(
            self, "_gen_started", "batch generation", log, "oryx-batch-watchdog"
        )

    def await_termination(self) -> None:
        if self._thread:
            self._thread.join()

    def close(self) -> None:
        self._stop.set()
        self._stop_prefetch()
        if self._consumer:
            self._consumer.close()
        if self._thread:
            self._thread.join(timeout=10)
        if self._watchdog:
            self._watchdog.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
