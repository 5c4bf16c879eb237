"""The serving path's telemetry planes in both packages side by side:
perfattr's idle-gap classification, compile telemetry and burn capture,
the SLO burn math, perfstats' dispatch accounting, the flight recorder
and the debug routes (/debug/flight, /debug/profile) on a ServingApp.

Each contract of the JAX package's own tests (tests/test_perfattr.py,
tests/test_slo.py, tests/test_perfstats.py, tests/test_flightrec.py) is
held against the port's objects, and the same inputs go to both packages'
objects: classify_idle_gap on seeded random gaps (numpy seed 20240611),
the SLO trackers on one synthetic counter source under one fake clock,
PerfStats on one record_dispatch sequence. Tolerance: exact equality
(both packages do the same float operations in the same order), except
where a reference test states an approx bound, kept here as it is.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

import numpy as np
import pytest

from oryx_tpu.common import flightrec as jflightrec
from oryx_tpu.common import perfattr as jperfattr
from oryx_tpu.common import perfstats as jperfstats
from oryx_tpu.common import slo as jslo
from oryx_tpu.common.config import load_config as jax_load_config
from oryx_tpu_torch.common import flightrec, perfattr, perfstats, slo
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.metrics import Counter, Histogram, get_registry

SEED = 20240611


# ---- idle-gap classification ------------------------------------------------


def _random_gap_cases():
    rng = np.random.default_rng(SEED)
    cases = []
    for _ in range(400):
        gap = float(rng.choice([rng.uniform(0.0, 2.0),
                                rng.uniform(0.0, 0.02),
                                rng.uniform(-0.5, 1e-5)]))
        parts = rng.uniform(0.0, 1.2, size=3) * max(gap, 0.0)
        # some slices zero, some past the gap, some tiny
        parts *= rng.choice([0.0, 0.1, 1.0, 3.0], size=3)
        cases.append((gap, *map(float, parts)))
    # the edges: a gap at the 1e-6 floor, a residue exactly at the 2 ms
    # fold and just past it, a residue at 10% of a large gap and past it
    cases += [
        (1e-6, 0.0, 0.0, 0.0), (2e-6, 1e-6, 0.0, 0.0),
        (0.010, 0.008, 0.0, 0.0), (0.010, 0.0079, 0.0, 0.0),
        (1.0, 0.9, 0.0, 0.0), (1.0, 0.899, 0.0, 0.0),
        (1.0, 0.2, 0.3, 0.4), (1.0, 2.0, 5.0, 5.0), (1.0, 0.0, 0.9, 0.7),
    ]
    return cases


def test_classify_idle_gap_equals_the_jax_package_on_seeded_gaps():
    seen = set()
    for gap, wait, serialize, down in _random_gap_cases():
        ported = perfattr.classify_idle_gap(gap, wait, serialize, down)
        assert ported == jperfattr.classify_idle_gap(gap, wait, serialize,
                                                     down)
        seen.update(ported)
    # the cases reach every measured cause and the honesty valve
    assert seen == {"empty_queue", "host_serialize", "failover_backoff",
                    "unattributed"}
    assert perfattr.IDLE_CAUSES == jperfattr.IDLE_CAUSES


def test_classify_idle_gap_measured_causes():
    causes = perfattr.classify_idle_gap(1.0, wait_s=0.9, serialize_s=0.1)
    assert causes == {
        "empty_queue": pytest.approx(0.9),
        "host_serialize": pytest.approx(0.1),
    }
    # cap order: wait first, then down, then serialize, each bounded by
    # what the gap can still hold
    causes = perfattr.classify_idle_gap(1.0, wait_s=2.0, serialize_s=5.0,
                                        down_s=5.0)
    assert causes == {"empty_queue": pytest.approx(1.0)}
    causes = perfattr.classify_idle_gap(1.0, down_s=0.7, serialize_s=0.9)
    assert causes["failover_backoff"] == pytest.approx(0.7)
    assert causes["host_serialize"] == pytest.approx(0.3)


def test_classify_idle_gap_residue_fold_and_unattributed():
    causes = perfattr.classify_idle_gap(0.010, wait_s=0.0095)
    assert set(causes) == {"empty_queue", "host_serialize"}
    assert causes["host_serialize"] == pytest.approx(0.0005)
    causes = perfattr.classify_idle_gap(1.0, wait_s=0.2)
    assert causes["unattributed"] == pytest.approx(0.8)
    assert perfattr.classify_idle_gap(0.0) == {}
    assert perfattr.classify_idle_gap(-0.5) == {}


# ---- perfattr budget, compile telemetry, burn capture ------------------------


def _ledger(mod, phases: dict[str, float]):
    led = mod.PhaseLedger()
    t = led.t0
    for phase, s in phases.items():
        led.add(phase, s, start=t)
        t += s
    return led


def test_budget_gap_ranking_matches_the_jax_package():
    budgets = []
    for mod in (jperfattr, perfattr):
        pa = mod.PerfAttr(window_s=300.0)
        for ms in (1, 2, 3, 4, 100):
            pa.observe_request(_ledger(mod, {"device": ms / 1e3,
                                             "parse": 0.001}))
        pa.record_idle_gap("empty_queue", 0.9)
        pa.record_idle_gap("host_serialize", 0.1)
        pa.record_idle_gap("compile_stall", 0.25)
        pa.record_idle_gap("bogus", -1.0)     # non-positive: dropped
        budgets.append(pa.budget())
    jb, pb = budgets
    assert pb["idle_gaps"] == jb["idle_gaps"]
    assert list(pb["idle_gaps"]) == ["empty_queue", "compile_stall",
                                     "host_serialize"]
    assert pb["phases"] == jb["phases"]
    assert pb["total_phase_seconds"] == jb["total_phase_seconds"]


def test_idle_gaps_since_sums_the_window_after_a_time():
    pa = perfattr.PerfAttr(window_s=300.0)
    pa.record_idle_gap("empty_queue", 0.5)
    t = time.monotonic()
    pa.record_idle_gap("empty_queue", 0.25)
    pa.record_idle_gap("host_serialize", 0.125)
    pa.record_idle_gap("empty_queue", 0.0)  # dropped
    assert pa.idle_gaps_since(t) == {"empty_queue": 0.25,
                                     "host_serialize": 0.125}
    assert pa.idle_gaps_since(0.0)["empty_queue"] == 0.75
    assert pa.idle_gaps_since(time.monotonic() + 1) == {}


def test_budget_window_expires_old_gaps():
    pa = perfattr.PerfAttr(window_s=0.05)
    pa.observe_request(_ledger(perfattr, {"device": 0.01}))
    pa.record_idle_gap("empty_queue", 0.5)
    time.sleep(0.08)
    b = pa.budget()
    assert b["phases"] == {}
    assert b["idle_gaps"] == {}


def test_disabled_perfattr_still_feeds_histograms_not_windows():
    pa = perfattr.PerfAttr(window_s=300.0)
    pa.enabled = False
    pa.observe_request(_ledger(perfattr, {"device": 0.01}))
    pa.record_idle_gap("empty_queue", 0.5)
    assert pa.budget()["phases"] == {}
    assert pa.budget()["idle_gaps"] == {}
    text = get_registry().render_prometheus()
    for family in ("oryx_request_phase_seconds",
                   "oryx_device_idle_gap_seconds",
                   "oryx_xla_compile_seconds", "oryx_xla_compiles_total"):
        assert family in text


def _flight_to(rec, path):
    rec.dir = str(path)
    rec.enabled = True
    with rec._lock:
        rec._last_episode.clear()
    return rec


def test_compile_storm_fires_flight_event_like_the_jax_package(tmp_path):
    events = {}
    for name, pmod, fmod in (("jax", jperfattr, jflightrec),
                             ("port", perfattr, flightrec)):
        rec = fmod.get_flightrec()
        saved = (rec.dir, rec.enabled)
        _flight_to(rec, tmp_path / name)
        try:
            pa = pmod.PerfAttr(window_s=300.0)
            pa.storm_threshold = 3
            pa.storm_window_s = 60.0
            pa.record_compile("serving", 0.2)
            pa.record_compile("serving", 0.3)
            assert not [e for e in fmod.read_events(str(tmp_path / name))
                        if e["kind"] == "compile-storm"]
            pa.record_compile("serving", 0.4)
            events[name] = [e for e in fmod.read_events(str(tmp_path / name))
                            if e["kind"] == "compile-storm"]
        finally:
            rec.dir, rec.enabled = saved
    strip = lambda e: {k: v for k, v in e.items() if k not in ("ts_ms",)}
    assert events["port"] and [strip(e) for e in events["port"]] == [
        strip(e) for e in events["jax"]]
    ev = events["port"][-1]
    assert ev["compiles"] == 3 and ev["dispatch_kind"] == "serving"
    assert ev["last_compile_s"] == pytest.approx(0.4)


def test_library_load_records_one_compile_and_stall(monkeypatch):
    """The kernel library's first load is the port's one cold compile:
    ops/topk.py times it into the compile families and a compile_stall
    gap, and the load-in-flight stamp exists only while it runs."""
    from oryx_tpu_torch.ops import _build, topk

    seen = {}

    def fake_load(name):
        seen["in_flight"] = topk.library_load_started()
        time.sleep(0.01)
        raise OSError("no nvcc here")

    reg = get_registry()
    before = reg.counter("oryx_xla_compiles_total").value(kind="serving")
    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(topk, "_LIB", None)
    with pytest.raises(OSError):
        topk._lib()
    assert seen["in_flight"] is not None
    assert topk.library_load_started() is None
    assert not topk.library_loaded()
    # a failed load is not a compile
    assert reg.counter("oryx_xla_compiles_total").value(
        kind="serving") == before

    class _Lib:
        _oryx_bound = True

    gaps0 = reg.histogram("oryx_device_idle_gap_seconds").count(
        cause="compile_stall")
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    assert isinstance(topk._lib(), _Lib)
    topk._lib()  # loaded: no second record
    assert reg.counter("oryx_xla_compiles_total").value(
        kind="serving") == before + 1
    assert reg.histogram("oryx_device_idle_gap_seconds").count(
        cause="compile_stall") == gaps0 + 1
    assert topk.library_loaded()


def test_burn_capture_leaves_a_profile_capture_event(tmp_path, monkeypatch):
    rec = flightrec.get_flightrec()
    monkeypatch.setattr(rec, "dir", str(tmp_path))
    monkeypatch.setattr(rec, "enabled", True)
    monkeypatch.setattr(perfattr, "_latency_fast_burn", lambda: 20.0)
    pa = perfattr.PerfAttr(window_s=300.0)
    pa.check_interval_s = 0.0
    pa.capture_s = 0.01
    pa.observe_request(_ledger(perfattr, {"device": 0.01}))
    deadline = time.monotonic() + 10
    events = []
    while time.monotonic() < deadline and not events:
        events = [e for e in flightrec.read_events(str(tmp_path))
                  if e["kind"] == "profile-capture"]
        time.sleep(0.02)
    assert events, "a fast burn left no profile-capture event"
    ev = events[-1]
    assert ev["trigger"] == "latency-fast-burn" and ev["burn_rate"] == 20.0
    assert ev["budget"]["phases"]["device"]["count"] == 1
    assert "dispatch_records" in ev["profile"]
    # the cooldown holds: a second hot check inside min-interval is quiet
    pa.observe_request(_ledger(perfattr, {"device": 0.01}))
    time.sleep(0.1)
    assert len([e for e in flightrec.read_events(str(tmp_path))
                if e["kind"] == "profile-capture"]) == 1


# ---- SLO burn rates ----------------------------------------------------------


def _slo_cfg(loader, fast=0.25, slow=0.8, **extra):
    return loader(overlay={
        "oryx.monitoring.slo.fast-window-sec": fast,
        "oryx.monitoring.slo.slow-window-sec": slow,
        **extra,
    })


def _gap():
    time.sleep(slo._MIN_SAMPLE_GAP_S + 0.02)


class _Clock:
    """One fake monotonic clock for both packages' slo modules."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def test_burn_math_equals_the_jax_package_under_one_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(jslo, "time", clock)
    monkeypatch.setattr(slo, "time", clock)
    counts = {"total": 0.0, "bad": 0.0}
    source = lambda: (counts["total"], counts["bad"])
    trackers = [mod.SloTracker("parity", 0.999, source, fast_s=0.25,
                               slow_s=0.8) for mod in (jslo, slo)]
    rng = np.random.default_rng(SEED)
    readings = []
    for _step in range(300):
        clock.t += float(rng.choice([0.01, 0.06, 0.2, 0.9]))
        total = float(rng.integers(0, 60))
        counts["total"] += total
        counts["bad"] += float(rng.integers(0, int(total) + 1)) * float(
            rng.choice([0.0, 0.0, 1.0]))
        readings.append([
            (t.burn_rate(t.fast_s), t.burn_rate(t.slow_s),
             t.budget_remaining()) for t in trackers
        ])
    for jax_reading, port_reading in readings:
        assert port_reading == jax_reading
    assert any(r[1][0] > 0 for r in readings)


def test_burn_math_is_exact_on_an_isolated_source():
    counts = {"total": 0.0, "bad": 0.0}
    t = slo.SloTracker(
        "math-test", 0.999, lambda: (counts["total"], counts["bad"]),
        fast_s=0.25, slow_s=0.8,
    )
    assert t.burn_rate(t.fast_s) == 0.0
    _gap()
    counts["total"] += 50
    counts["bad"] += 50
    assert t.burn_rate(t.fast_s) == pytest.approx(1000.0)
    assert t.budget_remaining() == pytest.approx(1.0 - 1000.0)
    _gap()
    counts["total"] += 50
    assert t.burn_rate(t.fast_s) == pytest.approx(500.0)
    time.sleep(t.fast_s + 0.05)
    counts["total"] += 20
    assert t.burn_rate(t.fast_s) == 0.0


def test_burn_moves_under_shed_storm_and_recovers():
    slo.ensure_serving_slos(_slo_cfg(load_config))
    t = slo.tracker("serving-availability")
    assert t is not None
    c = get_registry().counter("oryx_serving_requests_total")
    g = get_registry().gauge("oryx_slo_burn_rate")
    _gap()
    t.burn_rate(t.fast_s)
    _gap()
    for _ in range(50):
        c.inc(method="GET", status="503")
    burn = g.value(slo="serving-availability", window="fast")
    assert burn > 100.0, "shed storm must move the burn rate"
    assert t.budget_remaining() < 0
    _gap()
    time.sleep(t.fast_s)
    for _ in range(20):
        c.inc(method="GET", status="200")
    assert g.value(slo="serving-availability", window="fast") == 0.0


def test_latency_slo_counts_slow_requests():
    slo.ensure_serving_slos(_slo_cfg(load_config, **{
        "oryx.monitoring.slo.latency.objective": 0.9,
        "oryx.monitoring.slo.latency.threshold-sec": 0.25,
    }))
    t = slo.tracker("serving-latency")
    h = get_registry().histogram("oryx_serving_request_seconds")
    _gap()
    t.burn_rate(t.fast_s)
    _gap()
    for _ in range(40):
        h.observe(0.01, method="GET")
    for _ in range(40):
        h.observe(1.5, method="GET")
    burn = t.burn_rate(t.fast_s)
    assert 2.0 < burn <= 5.01, burn


def test_front_availability_counts_unanswered_requests():
    slo.ensure_front_slos(_slo_cfg(load_config))
    t = slo.tracker("front-availability")
    c = get_registry().counter("oryx_fleet_front_requests_total")
    _gap()
    t.burn_rate(t.fast_s)
    _gap()
    for _ in range(9):
        c.inc(replica="r0")
    c.inc(replica="none")
    burn = t.burn_rate(t.fast_s)
    assert 50.0 < burn <= 100.01, burn


def test_idle_window_is_not_an_outage():
    t = slo.SloTracker("idle-test", 0.999, lambda: (0.0, 0.0), fast_s=0.25,
                       slow_s=0.8)
    assert t.burn_rate(t.fast_s) == 0.0
    _gap()
    assert t.burn_rate(t.fast_s) == 0.0
    assert t.budget_remaining() == pytest.approx(1.0)


def test_gauges_render_on_the_registry():
    slo.ensure_serving_slos(_slo_cfg(load_config))
    slo.ensure_front_slos(_slo_cfg(load_config))
    slo.ensure_quality_slo(_slo_cfg(load_config))
    text = get_registry().render_prometheus()
    for series in (
        'oryx_slo_burn_rate{slo="serving-availability",window="fast"}',
        'oryx_slo_burn_rate{slo="serving-availability",window="slow"}',
        'oryx_slo_burn_rate{slo="serving-latency",window="fast"}',
        'oryx_slo_burn_rate{slo="front-availability",window="fast"}',
        'oryx_slo_burn_rate{slo="quality",window="fast"}',
        'oryx_slo_error_budget_remaining{slo="serving-availability"}',
    ):
        assert series in text, text[:2000]
    # no quality sampler in the port: its source reads no data, burn 0
    assert slo.current_burn("quality") == 0.0
    assert "quality" not in slo.sample_errors()


def test_disabled_slo_block_registers_nothing():
    before = set(slo._trackers)
    slo.ensure_serving_slos(load_config(overlay={
        "oryx.monitoring.slo.enabled": False,
    }))
    assert set(slo._trackers) == before


def test_histogram_totals_below_threshold_semantics():
    h = Histogram("t", "t", buckets=(0.1, 0.25, 1.0))
    for v in (0.05, 0.2, 0.9, 5.0):
        h.observe(v)
    assert h.totals_below(0.25) == (2, 4)
    assert h.totals_below(0.5) == (2, 4)
    assert h.totals_below(0.01) == (0, 4)
    assert h.totals_below(2.0) == (3, 4)


def test_counter_series_snapshot():
    c = Counter("t_total", "t", labeled=True)
    c.inc(status="200")
    c.inc(2.0, status="503")
    series = c.series()
    assert series[(("status", "200"),)] == 1.0
    assert series[(("status", "503"),)] == 2.0


def test_a_raising_source_is_counted_and_surfaced():
    def broken():
        raise KeyError("renamed counter")

    t = slo.SloTracker("broken-test", 0.99, broken, fast_s=0.25, slow_s=0.8)
    with slo._trackers_lock:
        slo._trackers["broken-test"] = t
    try:
        assert t.burn_rate(t.fast_s) == 0.0
        assert slo.sample_errors()["broken-test"].startswith("KeyError")
        assert get_registry().counter("oryx_slo_sample_errors_total").value(
            slo="broken-test") >= 1
        assert slo.burn_snapshot()["broken-test"] == {"fast": 0.0,
                                                      "slow": 0.0}
    finally:
        with slo._trackers_lock:
            slo._trackers.pop("broken-test", None)


# ---- perfstats ----------------------------------------------------------------


def _fresh(mod, window_s=10.0):
    ps = mod.PerfStats(capacity=256, window_s=window_s)
    ps.ensure_metrics()
    return ps


def _dispatch_sequence():
    rng = np.random.default_rng(SEED)
    seq = []
    for _ in range(40):
        cap = int(rng.integers(0, 300))
        seq.append(dict(
            kind=str(rng.choice(["serving", "train"])),
            flops=float(rng.uniform(0, 1e9)),
            bytes_moved=float(rng.uniform(0, 1e8)),
            wall_s=float(rng.uniform(1e-4, 0.05)),
            rows=int(rng.integers(1, 64)), padded_rows=int(rng.integers(1, 64)),
            valid_rows=int(rng.integers(-2, cap + 50)), capacity_rows=cap,
            score_mode=str(rng.choice(["exact", "quantized"])),
        ))
    return seq


def test_perfstats_equals_the_jax_package_on_one_sequence():
    jps, pps = _fresh(jperfstats, 300.0), _fresh(perfstats, 300.0)
    for ps in (jps, pps):
        ps.assumed_peak_flops = 1e12
        ps.set_peak("train", 67e12)
    for kw in _dispatch_sequence():
        j = jps.record_dispatch(**kw)
        p = pps.record_dispatch(**kw)
        assert p.occupancy == j.occupancy
    for kind in ("serving", "train"):
        assert pps.achieved_flops_per_sec(kind) == jps.achieved_flops_per_sec(
            kind)
        assert pps.mfu(kind) == jps.mfu(kind)
        assert pps.window_occupancy(kind) == jps.window_occupancy(kind)
        assert pps.peak_for(kind) == jps.peak_for(kind)
    assert pps.window_occupancy("serving")[1] > 0


def test_record_dispatch_occupancy_and_mfu():
    ps = _fresh(perfstats)
    ps.assumed_peak_flops = 1e6
    for _ in range(2):
        ps.record_dispatch(
            "serving", flops=1e5, bytes_moved=4096, wall_s=0.01,
            rows=3, padded_rows=4, valid_rows=50, capacity_rows=128,
        )
    recs = ps.records_since(0)
    assert len(recs) == 2
    assert recs[0].occupancy == pytest.approx(50 / 128)
    assert ps.achieved_flops_per_sec("serving") == pytest.approx(2e4)
    assert ps.mfu("serving") == pytest.approx(0.02)
    over = ps.record_dispatch(
        "train", flops=1.0, bytes_moved=0, wall_s=0.001,
        rows=10, padded_rows=10, valid_rows=20, capacity_rows=10,
    )
    assert over.occupancy == 1.0


def test_record_dispatch_occupancy_degenerate_inputs():
    ps = _fresh(perfstats)
    for kw in (dict(valid_rows=5, capacity_rows=0),
               dict(valid_rows=0, capacity_rows=128),
               dict(valid_rows=0, capacity_rows=0),
               dict(valid_rows=-3, capacity_rows=64)):
        r = ps.record_dispatch(
            "serving", flops=1.0, bytes_moved=0, wall_s=0.001,
            rows=1, padded_rows=1, **kw,
        )
        assert r.occupancy == 0.0, kw
        assert not math.isnan(r.occupancy)


def test_mfu_nan_without_peak_and_zero_during_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(flightrec.get_flightrec(), "dir", str(tmp_path))
    ps = _fresh(perfstats, window_s=0.2)
    ps.record_dispatch(
        "serving", flops=1e5, bytes_moved=0, wall_s=0.001,
        rows=1, padded_rows=1, valid_rows=1, capacity_rows=1,
    )
    assert math.isnan(ps.mfu("serving"))
    ps.assumed_peak_flops = 1e6
    assert ps.mfu("serving") > 0
    ps.note_fallback(2)
    assert ps.mfu("serving") == 0.0
    time.sleep(0.25)
    ps.record_dispatch(
        "serving", flops=1e5, bytes_moved=0, wall_s=0.001,
        rows=1, padded_rows=1, valid_rows=1, capacity_rows=1,
    )
    assert ps.mfu("serving") > 0
    ps.note_peak("serving", 1e7)
    assert ps.peak_for("serving") == 1e7


def _pump(ps, stop):
    while not stop.is_set():
        ps.record_dispatch(
            "serving", flops=100.0, bytes_moved=10.0, wall_s=0.001,
            rows=1, padded_rows=1, valid_rows=64, capacity_rows=128,
        )
        time.sleep(0.01)


@pytest.mark.parametrize("trace_dir", [False, True])
def test_capture_profile_artifact_and_concurrency_guard(tmp_path, trace_dir):
    from oryx_tpu_torch.common.metrics import PROFILER_LOCK, maybe_profile

    ps = _fresh(perfstats)
    if trace_dir:
        ps.profile_dir = str(tmp_path / "prof")
    stop = threading.Event()
    t = threading.Thread(target=_pump, args=(ps, stop), daemon=True)
    t.start()
    try:
        art = ps.capture_profile(0.3)
    finally:
        stop.set()
        t.join(timeout=10)
    assert art["displayTimeUnit"] == "ms"
    assert art["traceEvents"], "no dispatch slices captured in the window"
    ev = art["traceEvents"][0]
    assert ev["ph"] == "X" and ev["name"] == "device.dispatch.serving"
    assert ev["args"]["occupancy"] == pytest.approx(0.5)
    summary = art["oryx"]["by_kind"]["serving"]
    assert summary["dispatches"] >= 1
    assert summary["mean_occupancy"] == pytest.approx(0.5)
    path = art["oryx"]["torch_trace_path"]
    if trace_dir:
        # a torch.profiler Chrome trace of the window
        assert path and os.path.dirname(path) == str(tmp_path / "prof")
        with open(path, encoding="utf-8") as f:
            assert "traceEvents" in json.load(f)
    else:
        assert path is None
    # the guard is the one maybe_profile takes: one profiler per process
    assert ps._capture_lock is PROFILER_LOCK
    assert PROFILER_LOCK.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError):
            ps.capture_profile(0.01)
        with maybe_profile(str(tmp_path / "gen"), "held"):
            pass  # runs untraced while the profiler is held
        assert not (tmp_path / "gen").exists()
    finally:
        PROFILER_LOCK.release()
    with maybe_profile(str(tmp_path / "gen"), "free"):
        pass
    assert [p.name.startswith("free-") for p in (tmp_path / "gen").iterdir()] \
        == [True]


def test_metric_families_match_the_jax_package():
    from oryx_tpu.common.metrics import get_registry as jax_registry

    jperfstats.get_perfstats().ensure_metrics()
    perfstats.get_perfstats().ensure_metrics()
    for name in ("oryx_device_dispatch_seconds",
                 "oryx_dispatch_batch_occupancy",
                 "oryx_device_bytes_per_dispatch"):
        assert get_registry().histogram(name).buckets == \
            jax_registry().histogram(name).buckets
    text = get_registry().render_prometheus()
    for family in ("oryx_score_mode_dispatches_total", "oryx_device_mfu",
                   "oryx_device_flops_per_sec",
                   "oryx_device_fallback_dispatches_total"):
        assert family in text


def test_train_als_records_a_train_dispatch():
    from oryx_tpu_torch.ops.als import InteractionData, train_als

    ps = perfstats.get_perfstats()
    t_mark = time.monotonic()
    rng = np.random.default_rng(0)
    n = 300
    data = InteractionData(
        [f"u{i}" for i in range(40)], [f"i{i}" for i in range(30)],
        rng.integers(0, 40, n).astype(np.int32),
        rng.integers(0, 30, n).astype(np.int32),
        (rng.random(n) + 0.1).astype(np.float32),
    )
    timings = {}
    train_als(data, features=4, iterations=2, timings=timings, device="cpu")
    recs = [r for r in ps.records_since(t_mark) if r.kind == "train"]
    assert len(recs) == 1
    r = recs[0]
    assert r.flops == timings["train_flops"]
    assert r.wall_s == timings["train_s"]
    assert r.bytes_moved > (40 + 30) * 4 * 4
    # live rows only: every solved row is a real one
    assert r.occupancy == 1.0 and r.rows == 70


# ---- flight recorder ----------------------------------------------------------


def _rec(tmp_path, **overlay):
    rec = flightrec.FlightRecorder()
    rec.configure(load_config(overlay={
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        **overlay,
    }))
    return rec


def test_record_and_read_round_trip(tmp_path):
    rec = _rec(tmp_path)
    assert rec.record(kind="generation", generation=7, lag_s=0.5)
    assert rec.record(kind="wedge", layer="speed", state="wedged")
    events = rec.events()
    assert [e["kind"] for e in events] == ["generation", "wedge"]
    assert events[0]["generation"] == 7
    assert events[0]["pid"] == os.getpid()
    assert events[0]["ts_ms"] > 0


def test_replica_id_stamps_every_event(tmp_path):
    rec = _rec(tmp_path, **{"oryx.fleet.replica.id": "r3"})
    rec.record(kind="generation", generation=1)
    assert rec.events()[0]["replica"] == "r3"


def test_ring_is_bounded_and_rotates(tmp_path):
    rec = _rec(tmp_path, **{
        "oryx.monitoring.flight.segment-bytes": 4096,
        "oryx.monitoring.flight.segments": 2,
    })
    for i in range(400):
        rec.record(kind="generation", generation=i)
    flight = tmp_path / "flight"
    segs = [p for p in flight.iterdir() if p.name.startswith("events-")]
    assert len(segs) <= 2
    assert sum(p.stat().st_size for p in segs) <= 2 * 4096 + 512
    gens = [e["generation"] for e in rec.events()]
    assert gens[-1] == 399
    assert 0 not in gens
    assert gens == sorted(gens)


def test_episode_rate_limit_coalesces_bursts(tmp_path):
    rec = _rec(tmp_path)
    assert rec.record(kind="shed-episode", episode_s=60.0, queue_depth=1)
    for _ in range(10):
        assert not rec.record(kind="shed-episode", episode_s=60.0,
                              queue_depth=2)
    assert len([e for e in rec.events() if e["kind"] == "shed-episode"]) == 1


def test_disabled_recorder_writes_nothing(tmp_path):
    rec = _rec(tmp_path, **{"oryx.monitoring.flight.enabled": False})
    assert not rec.record(kind="generation", generation=1)
    assert not (tmp_path / "flight").exists()


def test_restart_resumes_newest_segment(tmp_path):
    a = _rec(tmp_path)
    a.record(kind="generation", generation=1)
    b = _rec(tmp_path)
    b.record(kind="generation", generation=2)
    assert [e["generation"]
            for e in flightrec.read_events(str(tmp_path / "flight"))] == [1, 2]


def test_read_events_skips_torn_lines(tmp_path):
    rec = _rec(tmp_path)
    rec.record(kind="generation", generation=1)
    seg = next((tmp_path / "flight").glob("events-*.jsonl"))
    with open(seg, "a", encoding="utf-8") as f:
        f.write('{"kind": "torn')
    rec2 = _rec(tmp_path)
    rec2.record(kind="generation", generation=2)
    assert [e["generation"] for e in rec2.events()] == [1, 2]


def test_snapshot_bundles_the_black_box(tmp_path):
    rec = _rec(tmp_path)
    rec.record(kind="health-degraded", reasons=["model-stale"])
    perfstats.get_perfstats().record_dispatch(
        "serving", flops=1.0, bytes_moved=1.0, wall_s=0.001, rows=1,
        padded_rows=1, valid_rows=1, capacity_rows=1, score_mode="exact",
    )
    bundle, path = rec.snapshot("unit-test", extra={"note": "x"})
    assert path is not None and os.path.exists(path)
    on_disk = json.load(open(path, encoding="utf-8"))
    for doc in (bundle, on_disk):
        assert doc["trigger"] == "unit-test"
        assert doc["note"] == "x"
        assert doc["config_fingerprint"]
        assert any(e["kind"] == "health-degraded" for e in doc["events"])
        assert "oryx_" in doc["metrics"]
        assert doc["dispatch_ring"][-1]["score_mode"] == "exact"
    assert rec.events()[-1]["kind"] == "snapshot"


def test_snapshot_dir_stays_bounded(tmp_path):
    rec = _rec(tmp_path)
    for i in range(12):
        rec.snapshot(f"t{i}")
    assert len(list((tmp_path / "flight" / "snapshots").glob("*.json"))) <= 8


def test_harvest_packs_a_corpse_ring(tmp_path):
    rec = _rec(tmp_path)
    rec.record(kind="generation", generation=9)
    del rec
    path = flightrec.harvest(str(tmp_path / "flight"), replica="r0",
                             returncode=-9)
    doc = json.load(open(path, encoding="utf-8"))
    assert doc["replica"] == "r0" and doc["returncode"] == -9
    assert any(e["kind"] == "generation" for e in doc["events"])
    assert flightrec.harvest(str(tmp_path / "never-existed")) is None


def test_event_catalog_is_the_jax_packages():
    assert set(flightrec.EVENT_KINDS) == set(jflightrec.EVENT_KINDS)
    for kind, doc in flightrec.EVENT_KINDS.items():
        assert isinstance(kind, str) and isinstance(doc, str)


def test_each_package_reads_the_others_ring(tmp_path):
    """One on-disk format: a ring written by either package reads back
    alike through either package's read_events and harvest."""
    jrec = jflightrec.FlightRecorder()
    jrec.configure(jax_load_config(overlay={
        "oryx.monitoring.flight.dir": str(tmp_path / "jax"),
        "oryx.monitoring.flight.segment-bytes": 4096,
    }))
    prec = _rec(tmp_path, **{"oryx.monitoring.flight.segment-bytes": 4096})
    for i in range(120):
        for rec in (jrec, prec):
            rec.record(kind="generation", generation=i, lag_s=0.25)
            rec.record(kind="wedge", layer="speed", state="wedged",
                       elapsed_s=1.5)
    for d in (str(tmp_path / "jax"), str(tmp_path / "flight")):
        assert flightrec.read_events(d) == jflightrec.read_events(d)
        assert len(flightrec.read_events(d)) > 50
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts_ms"}
                         for e in evs]
    assert strip(flightrec.read_events(str(tmp_path / "jax"))) == strip(
        jflightrec.read_events(str(tmp_path / "flight")))
    # a ring the JAX package wrote resumes in the port's recorder
    cont = flightrec.FlightRecorder()
    cont.configure(load_config(overlay={
        "oryx.monitoring.flight.dir": str(tmp_path / "jax"),
        "oryx.monitoring.flight.segment-bytes": 4096,
    }))
    cont.record(kind="generation", generation=999)
    assert jflightrec.read_events(str(tmp_path / "jax"))[-1]["generation"] \
        == 999
    path = jflightrec.harvest(str(tmp_path / "flight"))
    assert json.load(open(path, encoding="utf-8"))["events"]


# ---- flight events of the ported layers ---------------------------------------


def test_faults_watchdog_and_freshness_record_flight_events(tmp_path,
                                                            monkeypatch):
    import logging

    from oryx_tpu_torch.common import faults
    from oryx_tpu_torch.common.freshness import ModelFreshness, publish_stamp
    from oryx_tpu_torch.layers import watchdog

    rec = flightrec.get_flightrec()
    monkeypatch.setattr(rec, "dir", str(tmp_path))
    monkeypatch.setattr(rec, "enabled", True)
    rec._last_episode.clear()
    inj = faults.get_injector()
    inj.arm("speed.build", kind="error")
    try:
        with pytest.raises(faults.InjectedFault):
            faults.fire("speed.build")
    finally:
        inj.disarm()

    class _Layer:
        watchdog_poll_sec = 0.01
        watchdog_limit_sec = 0.05

        def __init__(self):
            self._stop = threading.Event()
            self.busy = time.monotonic()

    layer = _Layer()
    t = watchdog.start_wedge_watchdog(
        layer, "busy", "flight-test layer", logging.getLogger("t"), "t",
        label="flight-test")

    def events(kind):
        return [e for e in flightrec.read_events(str(tmp_path))
                if e["kind"] == kind]

    def wait_for(cond):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not cond():
            time.sleep(0.01)
        return cond()

    try:
        assert wait_for(lambda: any(e["state"] == "wedged"
                                    for e in events("wedge")))
        layer.busy = None  # the stuck work completes: readiness heals
        assert wait_for(lambda: any(e["state"] == "cleared"
                                    for e in events("wedge")))
    finally:
        layer._stop.set()
        t.join(timeout=10)
    wedges = [(e["layer"], e["state"]) for e in events("wedge")]
    assert wedges == [("flight-test", "wedged"), ("flight-test", "cleared")]

    fresh = ModelFreshness()
    fresh.note_loaded()
    fresh.note_stamp(publish_stamp(generation=42))
    gen = events("generation")[-1]
    assert gen["generation"] == 42 and gen["lag_s"] >= 0
    fault = events("fault-injection")[-1]
    assert (fault["site"], fault["fault"]) == ("speed.build", "error")


# ---- ServingApp: process start, debug routes, health edge ---------------------


class _NoModelManager:
    def __init__(self, config=None):
        self.config = config

    def consume(self, it):
        pass

    def get_model(self):
        return None


def _app(pkg: str, tmp_path, **overlay):
    if pkg == "jax":
        from oryx_tpu.serving.app import ServingApp
        loader = jax_load_config
    else:
        from oryx_tpu_torch.serving.app import ServingApp
        loader = load_config
    cfg = loader(overlay={
        "oryx.monitoring.flight.dir": str(tmp_path / pkg / "flight"),
        **overlay,
    })
    return ServingApp(cfg, _NoModelManager(cfg), None)


def _dispatch(pkg: str, app, method, path, query=None):
    if pkg == "jax":
        from oryx_tpu.serving.app import Request
    else:
        from oryx_tpu_torch.serving.app import Request
    req = Request(method=method, path=path, params={}, query=query or {},
                  body=b"", headers={})
    return app.dispatch(req)


@pytest.fixture
def restore_planes():
    yield
    # the next ServingApp of either package adopts defaults again
    for mod, loader in ((jperfstats, jax_load_config),
                        (perfstats, load_config)):
        mod.configure_perfstats(loader())
    jflightrec.get_flightrec().dir = None
    flightrec.get_flightrec().dir = None


def test_serving_app_records_process_start(tmp_path, restore_planes):
    _app("port", tmp_path)
    events = flightrec.read_events(str(tmp_path / "port" / "flight"))
    assert any(e["kind"] == "process-start" and e.get("role") == "serving"
               for e in events)


def test_debug_routes_answer_like_the_jax_package(tmp_path, restore_planes):
    """/debug/flight and /debug/profile: 403 while disabled, 200 enabled,
    409 (profile) while another capture holds the profiler — the same
    codes from both packages' ServingApps."""
    seconds = {"seconds": ["0.05"]}
    codes = {}
    for pkg in ("jax", "port"):
        off = _app(pkg, tmp_path, **{
            "oryx.monitoring.flight.enabled": False,
            "oryx.monitoring.profile.enabled": False,
        })
        got = [_dispatch(pkg, off, "GET", "/debug/flight")[0],
               _dispatch(pkg, off, "GET", "/debug/profile", seconds)[0]]
        on = _app(pkg, tmp_path, **{"oryx.monitoring.profile.enabled": True})
        status, body, ctype = _dispatch(pkg, on, "GET", "/debug/flight")
        doc = json.loads(body)
        assert ctype == "application/json"
        assert doc["trigger"] == "debug-endpoint"
        assert any(e["kind"] == "process-start" for e in doc["events"])
        assert "oryx_serving_requests" in doc["metrics"]
        got.append(status)
        status, body, _ = _dispatch(pkg, on, "GET", "/debug/profile", seconds)
        assert json.loads(body)["oryx"]["window_seconds"] >= 0.05
        got.append(status)
        ps = (jperfstats if pkg == "jax" else perfstats).get_perfstats()
        assert ps._capture_lock.acquire(blocking=False)
        try:
            got.append(_dispatch(pkg, on, "GET", "/debug/profile",
                                 seconds)[0])
        finally:
            ps._capture_lock.release()
        codes[pkg] = got
    assert codes["port"] == codes["jax"] == [403, 403, 200, 200, 409]


def test_healthz_degraded_transition_snapshots_once(tmp_path, restore_planes):
    app = _app("port", tmp_path)
    snap_dir = tmp_path / "port" / "flight" / "snapshots"

    def wait_for(n):
        deadline = time.time() + 10
        while time.time() < deadline:
            if len(list(snap_dir.glob("flight-healthz-degraded-*.json"))) >= n:
                break
            time.sleep(0.05)
        return len(list(snap_dir.glob("flight-healthz-degraded-*.json")))

    app.note_health_state(False, [])
    app.note_health_state(True, ["model-stale@r1:8101"])
    app.note_health_state(True, ["model-stale@r1:8101"])
    assert wait_for(1) == 1
    time.sleep(0.1)
    assert wait_for(1) == 1, "exactly one snapshot per up->degraded edge"
    events = flightrec.read_events(str(tmp_path / "port" / "flight"))
    degraded = [e for e in events if e["kind"] == "health-degraded"]
    assert len(degraded) == 1
    assert degraded[0]["reasons"] == ["model-stale@r1:8101"]
    app.note_health_state(False, [])
    app.note_health_state(True, ["device-down"])
    assert wait_for(2) == 2


def test_configure_flightrec_is_the_servingapp_path(tmp_path, restore_planes):
    rec = flightrec.configure_flightrec(load_config(overlay={
        "oryx.monitoring.flight.dir": str(tmp_path / "f2"),
    }))
    rec.record(kind="process-start", role="test")
    assert flightrec.read_events(str(tmp_path / "f2"))
