"""The serving batcher's wedge watchdog and its dispatch telemetry, under
the port's contract: a wedged dispatch fails its requests with
DeviceWedged (503 + Retry-After) within about ``device_timeout``; while
the card is down submits fail at once; a probe brings the dispatch back;
compile grace holds only while the kernel library's first load is in
flight; and no request is ever answered from a host path. Then both
packages' ALS serving layers side by side over HTTP: the same /healthz
key set (apart from the planes the port lacks), and device-down in both
after a wedge (the JAX package's through its host failover, the port's
through DeviceWedged).

A wedge is simulated by ``WedgeHook`` (a copy of tests/e2e_common.py's),
patched over the batcher's ``topk_dot_batch`` on ``device="cpu"``.
Results are compared with the port's own unwedged plain top-k, exactly.
"""

from __future__ import annotations

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.perfstats import get_perfstats
from oryx_tpu_torch.ops import topk
from oryx_tpu_torch.ops.als import topk_dot_batch as _real_topk_dot_batch
from oryx_tpu_torch.serving import batcher as P
from oryx_tpu_torch.serving.app import ShedLoad


class WedgeHook:
    """Monkeypatch target simulating a wedged device transport: blocks
    topk_dot_batch until released, then delegates to the real kernel.

    block_first_only=True blocks just the first call (a transient wedge);
    False blocks every call until release (a dead transport)."""

    def __init__(self, real_fn, block_first_only=True, timeout=30):
        self.release = threading.Event()
        self.calls = 0
        self._real = real_fn
        self._first_only = block_first_only
        self._timeout = timeout

    def __call__(self, xs, y, k, **kwargs):
        self.calls += 1
        if (self.calls == 1 or not self._first_only) and not self.release.is_set():
            self.release.wait(timeout=self._timeout)
        return self._real(xs, y, k=k, **kwargs)


@pytest.fixture
def y():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.standard_normal((200, 8)).astype(np.float32))


@pytest.fixture
def hook(monkeypatch):
    h = WedgeHook(_real_topk_dot_batch, block_first_only=True)
    monkeypatch.setattr(P, "topk_dot_batch", h)
    yield h
    h.release.set()


def _direct(vec, k, y):
    v, i = _real_topk_dot_batch(torch.from_numpy(vec[None, :]), y, k=k)
    return v.numpy()[0], i.numpy()[0]


VEC = np.random.default_rng(0).normal(size=8).astype(np.float32)


def test_wedged_dispatch_fails_with_device_wedged(y, hook):
    b = P.TopKBatcher(device_timeout=0.5, probe_interval=30.0,
                      compile_timeout=0.5)
    try:
        t0 = time.monotonic()
        fut = b.submit_nowait(VEC, 10, y)
        queued = [b.submit_nowait(VEC, 10, y) for _ in range(3)]
        with pytest.raises(P.DeviceWedged) as e:
            fut.result(timeout=10)
        took = time.monotonic() - t0
        assert 0.5 <= took < 3.0, took
        assert e.value.status == 503
        assert ("Retry-After", "30") in e.value.headers
        assert isinstance(e.value, ShedLoad)
        # the queued requests behind the stuck dispatch fail alike
        for f in queued:
            with pytest.raises(P.DeviceWedged):
                f.result(timeout=10)
        assert b.device_failovers == 1
        assert b._device_down.is_set()
        # while down, a submit fails at once, never queued
        t1 = time.monotonic()
        with pytest.raises(P.DeviceWedged):
            b.submit_nowait(VEC, 10, y)
        assert time.monotonic() - t1 < 1.0  # refused, not queued
        assert b._queue == [] and b._inflight == {}
    finally:
        hook.release.set()
        b.close()


def test_no_request_is_answered_from_a_host_path(y, hook):
    """The stuck call returns a real result once released, but its
    futures were already failed: nothing answers them late, and no
    result ever comes from anywhere but topk_dot_batch."""
    fallbacks = get_registry().counter("oryx_device_fallback_dispatches_total")
    before = fallbacks.value()  # the registry is the process's: other tests count too
    b = P.TopKBatcher(device_timeout=0.3, probe_interval=30.0)
    try:
        futs = [b.submit_nowait(VEC, 5, y) for _ in range(4)]
        for f in futs:
            with pytest.raises(P.DeviceWedged):
                f.result(timeout=10)
        hook.release.set()  # the stuck dispatcher finishes its call
        time.sleep(0.3)
        for f in futs:
            assert isinstance(f.exception(), P.DeviceWedged)
        # the port has no host-scoring counter to bump, and the JAX
        # package's host-fallback family stays at zero
        assert not hasattr(b, "host_fallbacks")
        assert fallbacks.value() == before
        assert hook.calls == 1  # no probe yet, no other scoring call
    finally:
        b.close()


def test_probe_brings_the_dispatch_back(y, hook):
    b = P.TopKBatcher(device_timeout=0.3, probe_interval=0.1,
                      compile_timeout=0.3)
    try:
        with pytest.raises(P.DeviceWedged):
            b.submit(VEC, 10, y)
        assert b._device_down.is_set()
        hook.release.set()  # the card recovers
        deadline = time.monotonic() + 10
        refused = 0
        while b._device_down.is_set() and time.monotonic() < deadline:
            try:
                b.submit(VEC, 10, y)
            except P.DeviceWedged:
                refused += 1
            time.sleep(0.02)
        assert not b._device_down.is_set(), "probe never recovered the card"
        assert refused >= 1
        # the device path again, on a fresh dispatcher thread
        vals, idx = b.submit(VEC, 10, y)
        dvals, didx = _direct(VEC, 10, y)
        assert list(idx) == list(didx)
        np.testing.assert_array_equal(vals, dvals)
        assert b.device_failovers == 1
    finally:
        b.close()


def test_watchdog_probes_without_traffic(y, hook):
    """No host path serves during the outage, so recovery must not wait
    for a request: the watchdog itself probes the last view."""
    b = P.TopKBatcher(device_timeout=0.3, probe_interval=0.1)
    try:
        with pytest.raises(P.DeviceWedged):
            b.submit(VEC, 10, y)
        hook.release.set()
        deadline = time.monotonic() + 10
        while b._device_down.is_set() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not b._device_down.is_set()
    finally:
        b.close()


def test_a_hung_probe_is_abandoned_after_device_timeout(y, monkeypatch):
    hook = WedgeHook(_real_topk_dot_batch, block_first_only=False)
    monkeypatch.setattr(P, "topk_dot_batch", hook)
    b = P.TopKBatcher(device_timeout=0.3, probe_interval=0.05)
    try:
        with pytest.raises(P.DeviceWedged):
            b.submit(VEC, 10, y)
        deadline = time.monotonic() + 3
        while hook.calls < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        # the first probe hung; a later one was started past the timeout
        assert hook.calls >= 3
        assert b._device_down.is_set()
        hook.release.set()
        deadline = time.monotonic() + 10
        while b._device_down.is_set() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not b._device_down.is_set()
    finally:
        hook.release.set()
        b.close()


def test_compile_grace_defers_the_watchdog_during_the_first_load(
        y, hook, monkeypatch):
    """A dispatch stuck past device_timeout while the kernel library's
    first load (an nvcc build) is in flight is a cold compile, not a
    wedge: the watchdog waits, the request is answered by the card."""
    started = time.monotonic()
    monkeypatch.setattr(topk, "library_load_started", lambda: started)
    b = P.TopKBatcher(device_timeout=0.3, probe_interval=0.1,
                      compile_timeout=15.0)
    threading.Thread(target=lambda: (time.sleep(1.2), hook.release.set()),
                     daemon=True).start()
    try:
        vals, idx = b.submit(VEC, 10, y)
        assert b.device_failovers == 0
        assert not b._device_down.is_set()
        dvals, didx = _direct(VEC, 10, y)
        assert list(idx) == list(didx)
        np.testing.assert_array_equal(vals, dvals)
    finally:
        b.close()


def test_compile_grace_expires_after_compile_timeout(y, hook, monkeypatch):
    started = time.monotonic()
    monkeypatch.setattr(topk, "library_load_started", lambda: started)
    b = P.TopKBatcher(device_timeout=0.2, probe_interval=30.0,
                      compile_timeout=0.6)
    try:
        t0 = time.monotonic()
        with pytest.raises(P.DeviceWedged):
            b.submit(VEC, 10, y)
        assert time.monotonic() - t0 >= 0.55
        assert b.device_failovers == 1
    finally:
        b.close()


def test_failover_gauges_and_no_host_fallback_gauge(y, hook):
    b = P.TopKBatcher(device_timeout=0.3, probe_interval=30.0)
    try:
        b.register_gauges()
        with pytest.raises(P.DeviceWedged):
            b.submit(VEC, 10, y)
        text = get_registry().render_prometheus()
    finally:
        b.close()
    values = dict(line.rsplit(" ", 1) for line in text.splitlines()
                  if line.startswith(("oryx_topk_", "oryx_device_peak")))
    assert float(values["oryx_topk_device_failovers"]) == 1
    assert float(values["oryx_topk_device_down"]) == 1
    assert float(values["oryx_device_peak_flops"]) == 0  # the CPU: unknown
    assert "oryx_topk_host_fallbacks" not in values


def test_resolved_groups_record_dispatch_costs(y):
    """One record per group at resolve time, with the group's own fields;
    occupancy is 1.0 by construction (views hold live rows, no query row
    is padded)."""
    ps = get_perfstats()
    t_mark = time.monotonic()
    b = P.TopKBatcher()
    try:
        b.submit(VEC, 3, y, score_mode="quantized")
    finally:
        b.close()
    recs = [r for r in ps.records_since(t_mark) if r.kind == "serving"]
    assert len(recs) == 1
    r = recs[0]
    assert r.flops == 2.0 * 1 * 200 * 8
    assert r.bytes_moved == 1 * 8 * 4 + y.nbytes + 1 * 16 * 8
    assert (r.rows, r.valid_rows, r.capacity_rows) == (1, 200, 200)
    assert r.occupancy == 1.0
    assert r.score_mode == "quantized"
    assert r.wall_s > 0


def test_peak_follows_the_dispatched_type(monkeypatch):
    from oryx_tpu_torch.ops.transfer import QuantizedMatrix

    b = P.TopKBatcher()
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    class _OnCard:
        def __init__(self, dtype):
            self.dtype = dtype
            self.device = torch.device("cuda", 0)

    assert b._peak_for_matrix(_OnCard(torch.bfloat16)) == 989e12
    assert b._peak_for_matrix(_OnCard(torch.float32)) == 67e12
    q = QuantizedMatrix.__new__(QuantizedMatrix)
    monkeypatch.setattr(QuantizedMatrix, "device",
                        property(lambda self: torch.device("cuda", 0)))
    assert b._peak_for_matrix(q) == 1979e12
    assert b._peak_for_matrix(torch.zeros((2, 2))) is None  # the CPU


def test_idle_gaps_are_classified_between_dispatches(y):
    reg = get_registry()
    h = reg.histogram("oryx_device_idle_gap_seconds")
    before = {c: h.sum(cause=c) for c in ("empty_queue", "host_serialize")}
    b = P.TopKBatcher()
    try:
        b.submit(VEC, 3, y)
        time.sleep(0.2)  # the dispatcher waits on an empty queue
        b.submit(VEC, 3, y)
    finally:
        b.close()
    waited = h.sum(cause="empty_queue") - before["empty_queue"]
    assert waited >= 0.15


def test_dispatcher_timeline_pieces_run_in_sequence(y):
    """The dispatcher logs each slice of its loop once: per dispatch one
    stage, issue, sync and distribute piece in that order, and a wait
    while the queue is empty; no two pieces overlap, so their sum over a
    window never exceeds it."""
    b = P.TopKBatcher()
    try:
        b.submit(VEC, 3, y)
        time.sleep(0.1)  # the dispatcher waits on an empty queue
        b.submit(VEC, 3, y)
    finally:
        b.close()
    tl = list(b.timeline)
    kinds = [k for k, _t0, _t1 in tl]
    assert [k for k in kinds if k != "wait"] == \
        ["stage", "issue", "sync", "distribute"] * 2
    for (_k, t0, t1), (_k2, u0, _u1) in zip(tl, tl[1:]):
        assert t0 <= t1 <= u0
    waited = sum(t1 - t0 for k, t0, t1 in tl if k == "wait")
    assert waited >= 0.08


def test_faults_fire_at_the_serving_device_site(y):
    from oryx_tpu_torch.common import faults

    inj = faults.get_injector()
    inj.arm("serving.device", kind="latency", latency_s=0.8)
    b = P.TopKBatcher(device_timeout=0.3, probe_interval=30.0)
    try:
        with pytest.raises(P.DeviceWedged):
            b.submit(VEC, 3, y)
        assert b.device_failovers == 1
    finally:
        inj.disarm()
        b.close()


# ---- both packages' serving layers over HTTP --------------------------------

from oryx_tpu.apps.spi import app_overlay as jax_app_overlay  # noqa: E402
from oryx_tpu.bus.broker import get_broker as jax_get_broker  # noqa: E402
from oryx_tpu.common.artifact import ModelArtifact  # noqa: E402
from oryx_tpu.common.config import load_config as jax_load_config  # noqa: E402
from oryx_tpu.serving import batcher as J  # noqa: E402
from oryx_tpu.serving.server import ServingLayer as JaxServingLayer  # noqa: E402
from oryx_tpu_torch.apps.als.serving import ALSServingModelManager  # noqa: E402
from oryx_tpu_torch.apps.spi import app_overlay  # noqa: E402
from oryx_tpu_torch.bus import get_broker  # noqa: E402
from oryx_tpu_torch.common.config import load_config  # noqa: E402
from oryx_tpu_torch.serving.server import ServingLayer  # noqa: E402

N_ITEMS, N_USERS, FEATURES = 500, 40, 8


@pytest.fixture(scope="module")
def model_ref(tmp_path_factory) -> str:
    rng = np.random.default_rng(20240611)
    x = rng.standard_normal((N_USERS, FEATURES), dtype=np.float32)
    yy = rng.standard_normal((N_ITEMS, FEATURES), dtype=np.float32)
    x_ids = [f"u{j}" for j in range(N_USERS)]
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    art = ModelArtifact("als", content={"knownItems": {x_ids[0]: ["i1"]}},
                        tensors={"X": x, "Y": yy})
    art.set_extension("features", str(FEATURES))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", x_ids)
    art.set_extension("YIDs", y_ids)
    path = tmp_path_factory.mktemp("als-wedge-model") / "model"
    art.write(path)
    return str(path)


def _request(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path, headers={"Accept": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _overlay(spi: dict, bus: str, tmp_path, pkg: str) -> dict:
    overlay = dict(spi)
    overlay.update({
        "oryx.input-topic.broker": bus,
        "oryx.update-topic.broker": bus,
        "oryx.serving.api.port": 0,
        "oryx.serving.api.loops": 1,
        # an assumed peak, so mfu is reported on the CPU by both
        "oryx.monitoring.perf.assumed-peak-flops": 1e4,
        "oryx.monitoring.flight.dir": str(tmp_path / pkg / "flight"),
    })
    return overlay


@pytest.fixture
def layers(tmp_path, model_ref, monkeypatch):
    """Both packages' ALS serving layers on the same model, each with a
    shared batcher that trips quickly; restores the previous shared
    batchers afterwards. Each package's process-wide freshness tracker
    starts empty, so a stamp another test left behind does not add
    ``staleness_seconds`` to one package's /healthz only."""
    from oryx_tpu.common import freshness as jax_freshness
    from oryx_tpu_torch.common import freshness as port_freshness

    for mod in (jax_freshness, port_freshness):
        monkeypatch.setattr(mod, "_instance", mod.ModelFreshness())
    saved = (J.TopKBatcher._shared, P.TopKBatcher._shared)
    J.TopKBatcher._shared = J.TopKBatcher(
        device_timeout=0.5, probe_interval=60.0, compile_timeout=0.5)
    P.TopKBatcher._shared = P.TopKBatcher(
        device_timeout=0.5, probe_interval=60.0)
    jbus, pbus = (f"mem://jax-wedge-{id(tmp_path)}",
                  f"mem://port-wedge-{id(tmp_path)}")
    started = []
    try:
        for bus, broker in ((jbus, jax_get_broker(jbus)),
                            (pbus, get_broker(pbus))):
            for topic in ("OryxInput", "OryxUpdate"):
                if not broker.topic_exists(topic):
                    broker.create_topic(topic, 1)
        jl = JaxServingLayer(jax_load_config(overlay=_overlay(
            jax_app_overlay("als"), jbus, tmp_path, "jax")))
        jl.start()
        started.append(jl)
        pcfg = load_config(overlay=_overlay(app_overlay("als"), pbus,
                                            tmp_path, "port"))
        pl = ServingLayer(pcfg,
                          model_manager=ALSServingModelManager(pcfg,
                                                               device="cpu"))
        pl.start()
        started.append(pl)
        jax_get_broker(jbus).send("OryxUpdate", "MODEL-REF", model_ref)
        get_broker(pbus).send("OryxUpdate", "MODEL-REF", model_ref)
        for sl in (jl, pl):
            deadline = time.monotonic() + 60
            while _request(sl.port, "/ready")[0] != 200:
                assert time.monotonic() < deadline, "never ready"
                time.sleep(0.02)
        yield {"jax": jl, "port": pl}
    finally:
        for sl in started:
            sl.close()
        for cls in (J.TopKBatcher, P.TopKBatcher):
            cls._shared.close()
        J.TopKBatcher._shared, P.TopKBatcher._shared = saved
        # a degraded /healthz starts a flight snapshot on a daemon thread,
        # which renders the registry and so samples its SLO trackers: let
        # it end here, not inside a later test that times those samples
        for t in threading.enumerate():
            if t.name == "oryx-flight-snapshot":
                t.join(timeout=30)


def _healthz(sl):
    status, _h, body = _request(sl.port, "/healthz")
    return status, json.loads(body)


def test_healthz_has_the_jax_packages_keys(layers):
    for sl in layers.values():
        for u in range(6):
            assert _request(sl.port, f"/recommend/u{u}?howMany=5")[0] == 200
    (js, jbody), (ps, pbody) = _healthz(layers["jax"]), _healthz(
        layers["port"])
    assert js == ps == 200
    # both packages add "shards" only to a sharded view's /healthz
    assert set(pbody) == set(jbody)
    assert "shards" not in pbody
    for key in ("mfu", "occupancy", "slo_burn", "latency_budget"):
        assert key in pbody
    assert pbody["occupancy"]["mean"] == 1.0
    assert pbody["occupancy"]["dispatches"] >= 1
    assert set(pbody["slo_burn"]) >= {"serving-availability",
                                      "serving-latency"}
    assert set(pbody["slo_burn"]["serving-latency"]) == {"fast", "slow"}
    assert set(pbody["latency_budget"]) == set(jbody["latency_budget"])
    assert pbody["mfu"] > 0


def test_device_down_in_both_after_a_wedge(layers, monkeypatch):
    from oryx_tpu.ops.als import topk_dot_batch as jax_real

    jhook = WedgeHook(jax_real, block_first_only=True)
    phook = WedgeHook(_real_topk_dot_batch, block_first_only=True)
    monkeypatch.setattr("oryx_tpu.ops.als.topk_dot_batch", jhook)
    monkeypatch.setattr(P, "topk_dot_batch", phook)
    try:
        js, _jh, _ = _request(layers["jax"].port, "/recommend/u1?howMany=4")
        ps, ph, pb = _request(layers["port"].port, "/recommend/u1?howMany=4")
        # the JAX package answers from its host failover; the port refuses
        assert js == 200
        assert ps == 503 and ph.get("Retry-After") == "60", pb
        for name, sl in layers.items():
            status, body = _healthz(sl)
            assert status == 503, name
            assert "device-down" in body["degraded"], (name, body)
        # the port's up->degraded edge left its flight snapshot
        flight = layers["port"].app.config.get_string(
            "oryx.monitoring.flight.dir")
        from oryx_tpu_torch.common.flightrec import read_events

        deadline = time.monotonic() + 10
        kinds = []
        while time.monotonic() < deadline:
            kinds = [e["kind"] for e in read_events(flight)]
            if "health-degraded" in kinds:
                break
            time.sleep(0.05)
        assert "health-degraded" in kinds and "wedge" in kinds
        status, _h, body = _request(layers["port"].port, "/debug/flight")
        assert status == 200
        assert any(e["kind"] == "health-degraded"
                   for e in json.loads(body)["events"])
    finally:
        jhook.release.set()
        phook.release.set()
