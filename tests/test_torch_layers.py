"""The batch and speed layer runtimes and the ALS incremental generations,
run as the same cases against both packages: each case takes a ``pkg``
fixture that names the JAX package's classes or the port's, so every case
counts once per package. The port's ALS update runs on ``device="cpu"``.

These mirror tests/test_layers.py (the layers with mock updates and
managers) and the ALS cases of tests/test_incremental_batch.py (full then
delta generations, restart from the snapshot, stale snapshots, drift,
failed builds, the threshold, and the incremental switch).
"""

from __future__ import annotations

import importlib
import logging
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

_MODULES = {
    "api": "api",
    "bus_api": "bus.api",
    "broker": "bus.broker",
    "inproc": "bus.inproc",
    "config": "common.config",
    "metrics": "common.metrics",
    "rng": "common.rng",
    "layers": "layers",
    "layer_batch": "layers.batch",
    "layer_speed": "layers.speed",
    "datastore": "layers.datastore",
    "als_batch": "apps.als.batch",
}


def _namespace(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root)
    for name, rel in _MODULES.items():
        setattr(ns, name, importlib.import_module(f"{root}.{rel}"))
    ns.KeyMessage = ns.bus_api.KeyMessage
    ns.TopicProducer = ns.bus_api.TopicProducer
    ns.get_broker = ns.broker.get_broker
    ns.topics = ns.broker.topics
    ns.load_config = ns.config.load_config
    ns.BatchLayer = ns.layers.BatchLayer
    ns.SpeedLayer = ns.layers.SpeedLayer
    ns.get_registry = ns.metrics.get_registry
    ns.RandomManager = ns.rng.RandomManager
    if root == "oryx_tpu_torch":
        ns.als_update = lambda cfg: ns.als_batch.ALSUpdate(cfg, device="cpu")
    else:
        ns.als_update = lambda cfg: ns.als_batch.ALSUpdate(cfg)
    return ns


@pytest.fixture(params=["oryx_tpu", "oryx_tpu_torch"], ids=["jax", "port"])
def pkg(request):
    ns = _namespace(request.param)
    ns.inproc.InProcBroker.reset_all()
    yield ns
    ns.inproc.InProcBroker.reset_all()


def _cfg(pkg, tmp_path, name, partitions=2, **extra):
    overlay = {
        "oryx.id": name,
        "oryx.input-topic.broker": f"mem://{name}",
        "oryx.update-topic.broker": f"mem://{name}",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.monitoring.quarantine.dir": str(tmp_path / "quarantine"),
        "oryx.batch.streaming.generation-interval-sec": 1,
        "oryx.speed.streaming.generation-interval-sec": 1,
    }
    overlay.update(extra)
    cfg = pkg.load_config(overlay=overlay)
    pkg.topics.maybe_create(f"mem://{name}", "OryxInput", partitions)
    pkg.topics.maybe_create(f"mem://{name}", "OryxUpdate", 1)
    return cfg


# ---- mock updates and managers, one class per package ----------------------

def _recording_update(pkg):
    class RecordingUpdate(pkg.api.BatchLayerUpdate):
        def __init__(self):
            self.calls = []

        def run_update(self, ts, new_data, past_data, model_dir, producer):
            self.calls.append((len(new_data), len(past_data)))
            producer.send("MODEL", f"model-at-{ts}")

    return RecordingUpdate()


def _echo_manager(pkg):
    class EchoSpeedManager(pkg.api.AbstractSpeedModelManager):
        def __init__(self):
            self.seen_updates = []

        def consume_key_message(self, key, message):
            self.seen_updates.append((key, message))

        def build_updates(self, new_data):
            return [("UP", f"delta:{km.message}") for km in new_data]

    return EchoSpeedManager()


# ---- datastore ---------------------------------------------------------------

def test_datastore_roundtrip_and_order(pkg, tmp_path):
    d = str(tmp_path / "ds")
    KM = pkg.KeyMessage
    pkg.datastore.save_generation(d, 1000, [KM("a", "m1"), KM(None, "m2")])
    pkg.datastore.save_generation(d, 2000, [KM("b", "m3")])
    assert pkg.datastore.save_generation(d, 3000, []) is None
    got = pkg.datastore.load_all_data(d)
    assert [km.message for km in got] == ["m1", "m2", "m3"]
    assert got[1].key is None


def test_datastore_files_are_the_same_bytes(tmp_path):
    """A generation window written by either package reads back in the
    other: the same record-log format on disk."""
    a, b = _namespace("oryx_tpu"), _namespace("oryx_tpu_torch")
    recs = [("k", "m1"), (None, "mé"), ("key", "")]
    a.datastore.save_generation(str(tmp_path / "a"), 5, [a.KeyMessage(*r) for r in recs])
    b.datastore.save_generation(str(tmp_path / "b"), 5, [b.KeyMessage(*r) for r in recs])
    fa = (tmp_path / "a" / "oryx-5" / "data.log").read_bytes()
    fb = (tmp_path / "b" / "oryx-5" / "data.log").read_bytes()
    assert fa == fb
    assert [tuple(km) for km in b.datastore.load_all_data(str(tmp_path / "a"))] == recs


# ---- batch layer ------------------------------------------------------------

def test_batch_layer_generations_accumulate_history(pkg, tmp_path):
    cfg = _cfg(pkg, tmp_path, "b1")
    upd = _recording_update(pkg)
    layer = pkg.BatchLayer(cfg, update=upd)
    layer.ensure_streams()
    broker = pkg.get_broker("mem://b1")
    for i in range(3):
        broker.send("OryxInput", None, f"g1-{i}")
    layer.run_generation(timestamp_ms=1000)
    for i in range(2):
        broker.send("OryxInput", None, f"g2-{i}")
    layer.run_generation(timestamp_ms=2000)
    layer.run_generation(timestamp_ms=3000)
    assert upd.calls == [(3, 0), (2, 3), (0, 5)]
    recs = broker.read("OryxUpdate", 0, 0, 10)
    assert [m for _, _, m in recs] == ["model-at-1000", "model-at-2000", "model-at-3000"]
    layer.close()


def test_batch_layer_resumes_from_committed_offsets(pkg, tmp_path):
    cfg = _cfg(pkg, tmp_path, "b2")
    broker = pkg.get_broker("mem://b2")
    layer1 = pkg.BatchLayer(cfg, update=_recording_update(pkg))
    layer1.ensure_streams()
    broker.send("OryxInput", None, "first")
    layer1.run_generation(timestamp_ms=1000)
    layer1.close()
    broker.send("OryxInput", None, "second")
    upd2 = _recording_update(pkg)
    layer2 = pkg.BatchLayer(cfg, update=upd2)
    layer2.run_generation(timestamp_ms=2000)
    assert upd2.calls == [(1, 1)]
    layer2.close()


def test_batch_layer_survives_failing_update(pkg, tmp_path):
    class Boom(pkg.api.BatchLayerUpdate):
        def run_update(self, *a):
            raise RuntimeError("boom")

    cfg = _cfg(pkg, tmp_path, "b3")
    layer = pkg.BatchLayer(cfg, update=Boom())
    layer.ensure_streams()
    pkg.get_broker("mem://b3").send("OryxInput", None, "x")
    layer.run_generation(timestamp_ms=1000)  # must not raise
    assert len(pkg.datastore.load_all_data(str(tmp_path / "data"))) == 1
    layer.close()


def test_batch_layer_interval_loop(pkg, tmp_path):
    cfg = _cfg(pkg, tmp_path, "b4")
    upd = _recording_update(pkg)
    layer = pkg.BatchLayer(cfg, update=upd)
    layer.ensure_streams()
    pkg.get_broker("mem://b4").send("OryxInput", None, "x")
    layer.start()
    deadline = time.time() + 10
    while layer.generation_count == 0 and time.time() < deadline:
        time.sleep(0.05)
    layer.close()
    assert layer.generation_count >= 1
    assert upd.calls and upd.calls[0][0] == 1


def test_layer_requires_existing_topics(pkg, tmp_path):
    cfg = pkg.load_config(overlay={
        "oryx.input-topic.broker": "mem://missing",
        "oryx.update-topic.broker": "mem://missing",
        "oryx.batch.storage.data-dir": str(tmp_path / "d"),
        "oryx.batch.storage.model-dir": str(tmp_path / "m"),
    })
    layer = pkg.BatchLayer(cfg, update=_recording_update(pkg))
    with pytest.raises(RuntimeError, match="topic does not exist"):
        layer.run_generation()


# ---- speed layer ------------------------------------------------------------

def test_speed_layer_micro_batch_and_listener(pkg, tmp_path):
    cfg = _cfg(pkg, tmp_path, "s1")
    broker = pkg.get_broker("mem://s1")
    broker.send("OryxUpdate", "MODEL", "the-model")
    mgr = _echo_manager(pkg)
    layer = pkg.SpeedLayer(cfg, manager=mgr)
    layer.start()
    deadline = time.time() + 10
    while not mgr.seen_updates and time.time() < deadline:
        time.sleep(0.05)
    assert ("MODEL", "the-model") in mgr.seen_updates
    broker.send("OryxInput", None, "interaction1")
    deadline = time.time() + 10
    while layer.batch_count < 2 and time.time() < deadline:
        time.sleep(0.05)
    layer.close()
    recs = broker.read("OryxUpdate", 0, 0, 100)
    assert ("UP", "delta:interaction1") in [(k, m) for _, k, m in recs]


def test_speed_layer_run_batch_sync(pkg, tmp_path):
    cfg = _cfg(pkg, tmp_path, "s2")
    broker = pkg.get_broker("mem://s2")
    layer = pkg.SpeedLayer(cfg, manager=_echo_manager(pkg))
    layer.ensure_streams()
    broker.send("OryxInput", None, "a")
    broker.send("OryxInput", None, "b")
    assert layer.run_batch() == 2
    assert layer.run_batch() == 0
    layer.close()


def test_speed_layer_failed_window_reprocessed_without_commits(pkg, tmp_path):
    class FailOnce(pkg.api.AbstractSpeedModelManager):
        def __init__(self):
            self.fail_next, self.seen = True, []

        def consume_key_message(self, key, message):
            pass

        def build_updates(self, new_data):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("transient build failure")
            self.seen.extend(km.message for km in new_data)
            return []

    cfg = _cfg(pkg, tmp_path, "srw")
    broker = pkg.get_broker("mem://srw")
    mgr = FailOnce()
    layer = pkg.SpeedLayer(cfg, manager=mgr)
    layer.ensure_streams()
    for i in range(4):
        broker.send("OryxInput", None, f"evt-{i}")
    assert layer.run_batch() == 4
    assert mgr.seen == []
    assert layer.run_batch() == 4
    assert sorted(mgr.seen) == [f"evt-{i}" for i in range(4)]
    layer.close()


def test_poison_update_message_does_not_kill_consume(pkg):
    class Counting(pkg.api.AbstractSpeedModelManager):
        def __init__(self):
            self.good = []

        def consume_key_message(self, key, message):
            if message == "poison":
                raise ValueError("bad payload")
            self.good.append(message)

        def build_updates(self, new_data):
            return []

    mgr = Counting()
    KM = pkg.KeyMessage
    mgr.consume(iter([KM("UP", "ok-1"), KM("UP", "poison"), KM("UP", "ok-2")]))
    assert mgr.good == ["ok-1", "ok-2"]


def test_transient_model_load_failure_retries(pkg, monkeypatch):
    class Flaky(pkg.api.AbstractSpeedModelManager):
        def __init__(self):
            self.attempts, self.loaded = 0, []

        def consume_key_message(self, key, message):
            if key == "MODEL":
                self.attempts += 1
                if self.attempts < 3:
                    raise IOError("artifact not visible yet")
            self.loaded.append((key, message))

        def build_updates(self, new_data):
            return []

    monkeypatch.setattr(pkg.api.time, "sleep", lambda s: None)
    mgr = Flaky()
    mgr.consume(iter([pkg.KeyMessage("MODEL", "m-payload")]))
    assert mgr.attempts == 3
    assert mgr.loaded == [("MODEL", "m-payload")]


@pytest.mark.parametrize("tier", ["batch", "speed"])
def test_watchdog_flags_stuck_work(pkg, tmp_path, caplog, tier):
    """Work running far past its limit is loudly reported and the running
    gauge exposes the elapsed time; both clear once the work ends."""
    release = threading.Event()
    cfg = _cfg(pkg, tmp_path, f"wdog-{tier}", partitions=1)
    if tier == "batch":
        class Stuck(pkg.api.BatchLayerUpdate):
            def run_update(self, ts, new_data, past_data, model_dir, producer):
                release.wait(timeout=30)

        layer = pkg.BatchLayer(cfg, update=Stuck())
        gauge_name = "oryx_batch_generation_running_seconds"
    else:
        class Stuck(pkg.api.SpeedModelManager):
            def consume(self, it):
                for _ in it:
                    pass

            def build_updates(self, batch):
                release.wait(timeout=30)
                return []

        layer = pkg.SpeedLayer(cfg, manager=Stuck())
        gauge_name = "oryx_speed_batch_running_seconds"
    layer.watchdog_limit_sec = 0.3
    layer.watchdog_poll_sec = 0.1
    layer.start()
    pkg.TopicProducer(pkg.get_broker(f"mem://wdog-{tier}"), "OryxInput").send("k", "v")
    gauge = pkg.get_registry().gauge(gauge_name, "")
    logger = f"{pkg.root}.layers.{tier}"
    with caplog.at_level(logging.ERROR, logger=logger):
        deadline = time.time() + 15
        while time.time() < deadline:
            if any("wedged" in r.message for r in caplog.records):
                break
            time.sleep(0.05)
    assert any("wedged" in r.message for r in caplog.records), "no watchdog log"
    assert gauge.value() > 0.3
    release.set()
    layer.close()
    assert gauge.value() == 0.0


# ---- ALS incremental generations --------------------------------------------

def _gen_cfg(pkg, tmp_path, name, **extra):
    return _cfg(pkg, tmp_path, name, **{
        "oryx.als.hyperparams.features": 5,
        "oryx.als.hyperparams.iterations": 4,
        "oryx.ml.eval.test-fraction": 0.1,
        **extra,
    })


def _feed(broker, rng, n, base_ts, users=25, items=15):
    for j in range(n):
        u, i = rng.integers(0, users), rng.integers(0, items)
        broker.send("OryxInput", None,
                    f"u{u},i{i},{1 + int(rng.poisson(1))},{base_ts + j}")


def _counts(pkg):
    c = pkg.get_registry().counter("oryx_batch_incremental_total")
    return c.value(kind="full"), c.value(kind="delta")


def test_generation_cycle_full_then_deltas(pkg, tmp_path, monkeypatch):
    pkg.RandomManager.use_test_seed(3)
    cfg = _gen_cfg(pkg, tmp_path, "g1")
    layer = pkg.BatchLayer(cfg, update=pkg.als_update(cfg))
    layer.ensure_streams()
    broker = pkg.get_broker("mem://g1")
    rng = np.random.default_rng(0)
    f0, d0 = _counts(pkg)
    _feed(broker, rng, 500, 1000, users=40, items=25)
    layer.run_generation(timestamp_ms=10_000)
    _feed(broker, rng, 50, 20_000, users=40, items=25)
    layer.run_generation(timestamp_ms=30_000)
    _feed(broker, rng, 50, 40_000, users=40, items=25)
    layer.run_generation(timestamp_ms=50_000)
    f1, d1 = _counts(pkg)
    assert (f1 - f0, d1 - d0) == (1, 2)
    recs = broker.read("OryxUpdate", 0, 0, 100_000)
    assert sum(1 for _, k, _m in recs if k in ("MODEL", "MODEL-REF")) == 3
    assert pkg.get_registry().gauge("oryx_batch_aggregate_rows").value() > 0
    calls = []
    real = pkg.datastore.load_all_data
    monkeypatch.setattr(pkg.datastore, "load_all_data",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    _feed(broker, rng, 50, 60_000, users=40, items=25)
    layer.run_generation(timestamp_ms=70_000)
    assert calls == []  # incremental generations never read history
    assert _counts(pkg) == (f0 + 1, d0 + 3)
    layer.close()


def test_restart_resumes_incrementally_from_snapshot(pkg, tmp_path):
    pkg.RandomManager.use_test_seed(5)
    cfg = _gen_cfg(pkg, tmp_path, "g2")
    broker = pkg.get_broker("mem://g2")
    rng = np.random.default_rng(1)
    f0, d0 = _counts(pkg)
    layer1 = pkg.BatchLayer(cfg, update=pkg.als_update(cfg))
    layer1.ensure_streams()
    _feed(broker, rng, 200, 1000)
    layer1.run_generation(timestamp_ms=1_700_000_010_000)
    layer1.close()
    upd2 = pkg.als_update(cfg)
    layer2 = pkg.BatchLayer(cfg, update=upd2)
    _feed(broker, rng, 60, 20_000)
    layer2.run_generation(timestamp_ms=1_700_000_030_000)
    layer2.close()
    assert _counts(pkg) == (f0 + 1, d0 + 1)
    # the warm start came from the newest model dir (13-digit stamps)
    assert upd2._prev_y is not None


def test_stale_snapshot_forces_full_rebuild(pkg, tmp_path):
    pkg.RandomManager.use_test_seed(6)
    cfg = _gen_cfg(pkg, tmp_path, "g3")
    broker = pkg.get_broker("mem://g3")
    rng = np.random.default_rng(2)
    f0, d0 = _counts(pkg)
    layer = pkg.BatchLayer(cfg, update=pkg.als_update(cfg))
    layer.ensure_streams()
    _feed(broker, rng, 200, 1000)
    layer.run_generation(timestamp_ms=10_000)
    pkg.datastore.save_generation(
        str(tmp_path / "data"), 20_000, [pkg.KeyMessage(None, "u1,i1,1,19000")])
    layer2 = pkg.BatchLayer(cfg, update=pkg.als_update(cfg))
    _feed(broker, rng, 60, 30_000)
    layer2.run_generation(timestamp_ms=40_000)
    f1, d1 = _counts(pkg)
    assert f1 - f0 == 2 and d1 - d0 == 0
    _feed(broker, rng, 60, 50_000)
    layer2.run_generation(timestamp_ms=60_000)
    assert _counts(pkg) == (f0 + 2, d0 + 1)
    layer.close()
    layer2.close()


def test_drift_past_fraction_forces_full_rebuild(pkg, tmp_path):
    pkg.RandomManager.use_test_seed(8)
    cfg = _gen_cfg(pkg, tmp_path, "g4", **{
        "oryx.batch.storage.incremental.max-drift-fraction": 0.05})
    broker = pkg.get_broker("mem://g4")
    rng = np.random.default_rng(3)
    f0, d0 = _counts(pkg)
    layer = pkg.BatchLayer(cfg, update=pkg.als_update(cfg))
    layer.ensure_streams()
    _feed(broker, rng, 150, 1000)
    layer.run_generation(timestamp_ms=10_000)
    _feed(broker, rng, 150, 20_000)
    layer.run_generation(timestamp_ms=30_000)
    assert _counts(pkg) == (f0 + 2, d0)
    layer.close()


def test_failed_build_window_not_lost_from_memory_state(pkg, tmp_path, monkeypatch):
    pkg.RandomManager.use_test_seed(13)
    cfg = _gen_cfg(pkg, tmp_path, "g8")
    broker = pkg.get_broker("mem://g8")
    rng = np.random.default_rng(7)
    f0, d0 = _counts(pkg)
    upd = pkg.als_update(cfg)
    layer = pkg.BatchLayer(cfg, update=upd)
    layer.ensure_streams()
    _feed(broker, rng, 400, 1000, users=40, items=25)
    layer.run_generation(timestamp_ms=10_000)
    real = pkg.als_batch.train_als_warm
    boom = {"armed": True}

    def flaky(*a, **k):
        if boom.pop("armed", False):
            raise RuntimeError("transient device failure")
        return real(*a, **k)

    monkeypatch.setattr(pkg.als_batch, "train_als_warm", flaky)
    broker.send("OryxInput", None, "uLOST,iLOST,4,20000")
    layer.run_generation(timestamp_ms=30_000)
    _feed(broker, rng, 40, 40_000, users=40, items=25)
    layer.run_generation(timestamp_ms=50_000)
    assert _counts(pkg) == (f0 + 2, d0)
    state = upd._agg_state
    mask = (np.asarray(state.user_ids)[state.users] == "uLOST") & (
        np.asarray(state.item_ids)[state.items] == "iLOST")
    total = float(np.nansum(state.vals[mask]))
    pend = upd._agg_pending
    total += float(np.nansum(pend[2][pend[0] == "uLOST"]))
    assert total == 4.0
    layer.close()


def test_threshold_withheld_build_still_reanchors_snapshot(pkg, tmp_path):
    pkg.RandomManager.use_test_seed(10)
    cfg = _gen_cfg(pkg, tmp_path, "g7", **{"oryx.ml.eval.threshold": 2.0})
    broker = pkg.get_broker("mem://g7")
    rng = np.random.default_rng(5)
    f0, d0 = _counts(pkg)
    layer = pkg.BatchLayer(cfg, update=pkg.als_update(cfg))
    layer.ensure_streams()
    _feed(broker, rng, 400, 1000, users=40, items=25)
    layer.run_generation(timestamp_ms=10_000)
    _feed(broker, rng, 40, 20_000, users=40, items=25)
    layer.run_generation(timestamp_ms=30_000)
    assert _counts(pkg) == (f0 + 1, d0 + 1)
    recs = broker.read("OryxUpdate", 0, 0, 100_000)
    assert not any(k in ("MODEL", "MODEL-REF") for _, k, _m in recs)
    layer.close()


def test_incremental_disabled_by_config(pkg, tmp_path):
    pkg.RandomManager.use_test_seed(9)
    cfg = _gen_cfg(pkg, tmp_path, "g5", **{
        "oryx.batch.storage.incremental.enabled": False})
    broker = pkg.get_broker("mem://g5")
    rng = np.random.default_rng(4)
    f0, d0 = _counts(pkg)
    layer = pkg.BatchLayer(cfg, update=pkg.als_update(cfg))
    layer.ensure_streams()
    _feed(broker, rng, 100, 1000)
    layer.run_generation(timestamp_ms=10_000)
    _feed(broker, rng, 50, 20_000)
    layer.run_generation(timestamp_ms=30_000)
    assert _counts(pkg) == (f0 + 2, d0)
    layer.close()


# ---- the port only ------------------------------------------------------------

def test_port_rejects_a_pod_config(tmp_path):
    """(Named when a pod config was refused.) A config with
    ``oryx.compute.distributed.num-processes = 2`` builds pod members, as
    in the JAX package: process 0 is the leader and publishes; process 1
    keeps its storage in per-process dirs, reads through a consumer group
    of its own, prefetches nothing and publishes through the null
    producer. Both packages agree on every one of these."""
    for name in ("oryx_tpu", "oryx_tpu_torch"):
        ns = _namespace(name)
        members = {}
        for pid in (0, 1):
            cfg = _cfg(ns, tmp_path / f"{name}-{pid}", f"pod-{name}-{pid}", **{
                "oryx.compute.distributed.num-processes": 2,
                "oryx.compute.distributed.process-id": pid,
            })
            layer = ns.BatchLayer(cfg, update=_recording_update(ns))
            layer.ensure_streams()
            members[pid] = layer
            assert ns.als_update(cfg)._pod is True
        lead, other = members[0], members[1]
        assert lead.is_leader and not other.is_leader
        assert not lead.prefetch_enabled and not other.prefetch_enabled
        assert other.data_dir.endswith("proc-1")
        assert other.model_dir.endswith("proc-1")
        assert other.group.endswith("-batch-proc1")
        assert lead.group.endswith("-batch")
        assert type(lead._producer).__name__ == "TopicProducer"
        assert type(other._producer).__name__ == "_NullProducer"
        # one process in the group: the window is this member's own
        assert lead._pod_window(1234) == (1234, None)
        for layer in members.values():
            layer.close()


def test_port_profile_dir_writes_a_torch_trace(tmp_path):
    ns = _namespace("oryx_tpu_torch")
    cfg = _cfg(ns, tmp_path, "prof", **{"oryx.monitoring.profile-dir": str(tmp_path / "prof")})
    layer = ns.BatchLayer(cfg, update=_recording_update(ns))
    layer.ensure_streams()
    ns.get_broker("mem://prof").send("OryxInput", None, "x")
    layer.run_generation(timestamp_ms=1000)
    layer.close()
    traces = list((tmp_path / "prof").glob("batch-gen-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
