"""The port's host timeline of a measured window: ``Tracer.capture()``, the
batcher's dispatcher pieces as spans that tile its thread and as always-on
seconds, the interpreter's collections (``common/gcstats.py``), the
profile window's marker alignment and its one-timebase file, and the
benchmark's readers that split the device's idle time by those spans."""

from __future__ import annotations

import gc
import json
import time

import numpy as np
import pytest
import torch

from oryx_tpu_torch.common import gcstats
from oryx_tpu_torch.common.metrics import (
    MARKER_KERNEL,
    ProfiledWindow,
    align_profiler_events,
    get_registry,
)
from oryx_tpu_torch.common.perfstats import write_profile
from oryx_tpu_torch.common.tracing import Tracer, get_tracer
from oryx_tpu_torch.serving import batcher as P

from portbench import harness
from portbench.trace import DeviceTrace

VEC = np.random.default_rng(0).normal(size=8).astype(np.float32)


@pytest.fixture
def y():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.standard_normal((200, 8)).astype(np.float32))


# ---- Tracer.capture ----------------------------------------------------------

def test_capture_keeps_more_than_the_ring_and_restores_enabled():
    tr = Tracer(capacity=16)
    assert not tr.enabled
    with tr.capture() as cap:
        assert tr.enabled
        for i in range(100):
            tr.finish(tr.start("work", i=i))
    assert not tr.enabled
    assert len(tr.snapshot()) == 16
    # readable after exit, in the order they finished, none lost
    assert [s.attrs["i"] for s in cap.spans] == list(range(100))
    assert tr.last_capture is cap
    assert cap.t0 <= cap.spans[0].start and cap.spans[-1].end <= cap.t1


def test_overlapping_captures_restore_the_state_before_the_first():
    tr = Tracer(capacity=16)
    tr.configure(enabled=True)
    a = tr.capture()
    cap_a = a.__enter__()
    with tr.capture() as cap_b:
        tr.configure(enabled=False)  # takes effect once both have closed
        tr.finish(tr.start("both"))
    assert tr.enabled  # a is still open
    tr.finish(tr.start("only-a"))
    a.__exit__(None, None, None)
    assert not tr.enabled
    assert [s.name for s in cap_a.spans] == ["both", "only-a"]
    assert [s.name for s in cap_b.spans] == ["both"]
    tr.finish(tr.start("after"))  # tracing off: nothing recorded
    assert len(cap_a.spans) == 2


# ---- the dispatcher's pieces -------------------------------------------------

def _two_dispatches_and_a_wait(y):
    b = P.TopKBatcher()
    with get_tracer().capture() as cap:
        try:
            b.submit(VEC, 3, y)
            time.sleep(0.1)  # the dispatcher waits on an empty queue
            b.submit(VEC, 3, y)
        finally:
            b.close()  # the last piece ends once the thread waits again
    return b, cap


def test_dispatcher_pieces_tile_its_thread(y):
    b, cap = _two_dispatches_and_a_wait(y)
    mine = [s for s in cap.spans if s.name.startswith("batcher.")
            and s.name not in ("batcher.queue_wait", "batcher.device")]
    assert {s.tid for s in mine} == {s.tid for s in mine[:1]}
    assert [s.name for s in mine] == [
        "batcher.wait", "batcher.stage", "batcher.issue", "batcher.sync",
        "batcher.distribute", "batcher.wait", "batcher.stage",
        "batcher.issue", "batcher.sync", "batcher.distribute"]
    # no gap and no overlap: each piece starts where the one before ended
    for s, t in zip(mine, mine[1:]):
        assert s.start <= s.end == t.start
    for s in mine:
        if s.name != "batcher.wait":
            assert s.attrs == {"rows": 1, "k": 16}
    assert b.timeline == [(s.name[len("batcher."):], s.start, s.end) for s in mine]


def test_piece_counters_equal_the_spans_sums(y):
    b, cap = _two_dispatches_and_a_wait(y)
    sums = dict.fromkeys(P.PIECES, 0.0)
    for piece, t0, t1 in b.timeline:
        sums[piece] += t1 - t0
    for piece in P.PIECES:
        assert b.seconds_by_piece[piece] == pytest.approx(sums[piece], abs=1e-9)
    assert b.seconds_by_piece["wait"] >= 0.08


def test_piece_counters_are_on_metrics_without_tracing(y):
    assert not get_tracer().enabled
    b = P.TopKBatcher()
    try:
        b.submit(VEC, 3, y)
        b.submit(VEC, 3, y)
    finally:
        b.close()
    assert b.seconds_by_piece["sync"] > 0.0 and b.seconds_by_piece["stage"] > 0.0
    try:
        b.register_gauges()
        text = get_registry().render_prometheus()
        for piece in P.PIECES:
            want = b.seconds_by_piece[piece]
            line = next(x for x in text.splitlines() if x.startswith(
                f'oryx_topk_dispatcher_seconds_total{{piece="{piece}"}}'))
            assert float(line.split()[-1]) == pytest.approx(want)
    finally:
        P.TopKBatcher.shared().register_gauges()


# ---- the interpreter's collections -----------------------------------------

def test_gc_hook_counts_forced_collections_by_generation():
    gcstats.install()
    gcstats.install()  # once: a second call adds no second hook
    assert gc.callbacks.count(gcstats._hook) == 1
    was = gc.isenabled()
    gc.disable()  # no collection but the forced ones
    try:
        n0, p0 = list(gcstats.collections), list(gcstats.pause_seconds)
        with get_tracer().capture() as cap:
            gc.collect(0)
            gc.collect(2)
        assert gcstats.collections == [n0[0] + 1, n0[1], n0[2] + 1]
        assert gcstats.pause_seconds[0] > p0[0] and gcstats.pause_seconds[2] > p0[2]
        spans = [s for s in cap.spans if s.name == "runtime.gc"]
        assert [s.attrs["generation"] for s in spans] == [0, 2]
        assert all(s.end >= s.start for s in spans)
    finally:
        if was:
            gc.enable()
    rows = dict(x.rsplit(" ", 1) for x in get_registry().render_prometheus().splitlines()
                if x.startswith("oryx_gc_"))
    for g in gcstats.GENERATIONS:
        assert float(rows[f'oryx_gc_collections_total{{generation="{g}"}}']) == \
            gcstats.collections[g]
        assert float(rows[f'oryx_gc_pause_seconds_total{{generation="{g}"}}']) == \
            pytest.approx(gcstats.pause_seconds[g])


# ---- the profile window's one timebase ---------------------------------------

def test_marker_alignment_offset_on_synthetic_events():
    mark = 5_000_000_000
    # the profiler's clock runs 7 s ahead of the host's monotonic clock
    events = [
        ("cudaLaunchKernel", "cuda_runtime", False, 1, 12_000_000_000 - 9_000,
         12_000_000_000 - 2_000, 31),
        (f"void at::cuda::{MARKER_KERNEL}(long)", "kernel", True, 7,
         12_000_000_000, 12_000_010_000, 31),
        ("topk_dot_partial_kernel", "kernel", True, 7, 12_000_050_000,
         12_005_000_000, 32),
    ]
    # the marker's launch (same correlation) starts at the mark
    out, offset = align_profiler_events(events, mark, fallback_offset_ns=123)
    assert offset == 7_000_000_000 - 9_000
    assert [e[4] for e in out] == [mark, mark + 9_000, mark + 59_000]
    assert out[1][5] == mark + 19_000 and out[1][6] == 31
    # a trace without the host's calls: the marker kernel starts at the mark
    out, offset = align_profiler_events(events[1:], mark, fallback_offset_ns=123)
    assert offset == 7_000_000_000
    assert [e[4] for e in out] == [mark, mark + 50_000]
    # no marker (or no mark): the profiler's clock is taken for the epoch's
    out, offset = align_profiler_events(events[2:], mark, fallback_offset_ns=10)
    assert offset is None and out[0][4] == 12_000_050_000 - 10
    out, offset = align_profiler_events(events, None, fallback_offset_ns=10)
    assert offset is None and out[1][4] == 12_000_000_000 - 10


def test_profile_file_puts_spans_and_device_on_one_timebase(tmp_path):
    tr = Tracer()
    with tr.capture() as cap:
        s = tr.start("batcher.sync", rows=1, k=16)
        tr.finish(s)
    dev = ProfiledWindow()
    t = int(s.start * 1e9)
    dev.events = [("topk_dot_partial_kernel", "kernel", True, 7, t, t + 5000, 9)]
    dev.offset_ns, dev.mark_ns = 42, t
    path = tmp_path / "p" / "ondemand.json"
    write_profile(str(path), [], cap.spans, dev)
    doc = json.loads(path.read_text())
    assert doc["oryx"]["timebase"] == "time.monotonic"
    by_name = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    host, card = by_name["batcher.sync"], by_name["topk_dot_partial_kernel"]
    assert host["pid"] == 1 and card["pid"] == 2 and card["cat"] == "kernel"
    assert abs(host["ts"] - card["ts"]) < 1.0  # µs
    assert card["dur"] == pytest.approx(5.0) and card["args"]["correlation"] == 9


# ---- the benchmark's readers ---------------------------------------------------

MS = 1_000_000


def _synthetic():
    """A 100 ms window: the card busy 0-20, 30-60 and 90-95 ms; idle
    20-30 (a collection 22-25 ms inside the dispatcher's distribute),
    60-90 (wait 60-80, stage 80-84, issue 84-86, sync 86-88, then no
    dispatcher piece) and 95-100 (sync)."""
    t = DeviceTrace(None, enabled=False)
    t.t0, t.t1 = 0, 100 * MS
    t.ops = [("k", "kernel", 0, 20 * MS), ("k", "kernel", 30 * MS, 60 * MS),
             ("k", "kernel", 90 * MS, 95 * MS)]
    spans = [
        ("runtime.gc", 22 * MS, 25 * MS),
        ("batcher.sync", 0, 20 * MS), ("batcher.distribute", 20 * MS, 30 * MS),
        ("batcher.wait", 30 * MS, 80 * MS), ("batcher.stage", 80 * MS, 84 * MS),
        ("batcher.issue", 84 * MS, 86 * MS), ("batcher.sync", 86 * MS, 88 * MS),
        ("batcher.sync", 95 * MS, 100 * MS),
        ("http.request", 0, 100 * MS),  # on another thread: names nothing
    ]
    return t, spans


def _ctx(trace, counters):
    cell = harness.Cell("c", "conf", "traffic", 1, {}, {}, [], [])
    return harness.Context(cell, counters, {}, trace)


@pytest.mark.parametrize("name, want", [
    ("idle.gc_share", 3.0),
    ("idle.dispatch_host_share", 7.0 + 4.0 + 2.0),
    ("idle.sync_share", 2.0 + 5.0),
    ("idle.empty_queue_share", 20.0),
])
def test_idle_share_readers_on_a_synthetic_window(name, want):
    t, spans = _synthetic()
    reader = harness.metric_reader(name)
    assert reader.read(_ctx(t, {"program_spans": spans})) == pytest.approx(want)
    assert reader.read(_ctx(None, {"program_spans": spans})) is None
    assert reader.read(_ctx(t, {})) is None


def test_idle_shares_sum_to_the_idle_share_less_the_unnamed():
    t, spans = _synthetic()
    ctx = _ctx(t, {"program_spans": spans})
    idle = harness.metric_reader("device_idle_share.serve").read(ctx)
    assert idle == pytest.approx(45.0)
    parts = sum(harness.metric_reader(f"idle.{c}_share").read(ctx)
                for c in ("dispatch_host", "sync", "empty_queue", "gc"))
    assert idle - parts == pytest.approx(2.0)  # 88-90 ms under no piece
    # with the dispatcher's pieces tiling the window, the sum is the share
    whole = spans + [("batcher.distribute", 88 * MS, 95 * MS)]
    ctx = _ctx(t, {"program_spans": whole})
    parts = sum(harness.metric_reader(f"idle.{c}_share").read(ctx)
                for c in ("dispatch_host", "sync", "empty_queue", "gc"))
    assert parts == pytest.approx(idle)


def test_dispatcher_host_ms_reader():
    reader = harness.metric_reader("dispatcher.host_ms")
    pieces = {"wait": 9.0, "stage": 0.2, "issue": 0.3, "sync": 5.0, "distribute": 0.5}
    assert reader.read(_ctx(None, {"dispatcher_seconds": pieces, "dispatches": 1000})) \
        == pytest.approx(1.0)
    assert reader.read(_ctx(None, {"dispatcher_seconds": pieces, "dispatches": 0})) is None
    assert reader.read(_ctx(None, {"dispatches": 10})) is None


# ---- portbench.capture_run on a tiny cell --------------------------------------

def _host_only_trace(monkeypatch):
    """``DeviceTrace`` without a card: the window's edges only, no device
    operation (the card idles the whole window)."""

    def enter(self):
        if self.enabled:
            self.t0 = time.monotonic_ns()
        return self

    def leave(self, *exc):
        if self.enabled:
            self.t1 = time.monotonic_ns()
        return False

    monkeypatch.setattr(DeviceTrace, "__enter__", enter)
    monkeypatch.setattr(DeviceTrace, "__exit__", leave)


@pytest.mark.parametrize("traced", [False, True])
def test_capture_run_patches_a_tiny_serving_run(monkeypatch, traced):
    """``portbench.capture_run``'s patch points, run through the serving
    system at a tiny size on the CPU: the dispatcher's seconds over the
    window in every run; with tracing, the capture's spans, the five
    readers, and the idle shares within the idle share; everything
    patched goes back."""
    from portbench import capture_run
    from portbench import trace as trace_mod
    from portbench.systems import RunSpec, Setup
    from portbench.tests.tiny import tiny_cell

    _host_only_trace(monkeypatch)
    resolve, system_module = harness.resolve, harness.system_module
    restore = capture_run.install()
    try:
        assert trace_mod.DeviceTrace is capture_run.CapturedTrace
        cell = tiny_cell("als-serve-20m-250f.recommend-c2")  # patched resolve
        system = harness.system_module(cell.config["system"])
        out = system.run(RunSpec(cell, 2_200_000_017, 0.5, traced,
                                 torch.device("cpu"), Setup(time.monotonic())))
    finally:
        restore()
    assert harness.resolve is resolve and harness.system_module is system_module
    assert trace_mod.DeviceTrace is not capture_run.CapturedTrace
    assert not get_tracer().enabled
    c = out.counters
    assert c["dispatches"] > 0 and set(c["dispatcher_seconds"]) == set(P.PIECES)
    host = sum(c[f"dispatcher_{p}_s"] for p in capture_run.HOST)
    assert c["dispatcher_host_ms"] == pytest.approx(host / c["dispatches"] * 1e3)
    assert [m["name"] for m in cell.per_layer][-5:] == [n for n, _ in capture_run.EXTRA]
    if not traced:
        assert "program_spans" not in c and out.trace is None
        return
    names = {n for n, _, _ in c["program_spans"]}
    assert {"batcher.stage", "batcher.issue", "batcher.sync"} <= names
    ctx = harness.Context(cell, c, {}, out.trace)
    read = {n: harness.metric_reader(n).read(ctx) for n, _ in capture_run.EXTRA}
    assert all(v is not None for v in read.values())
    assert read["dispatcher.host_ms"] == pytest.approx(c["dispatcher_host_ms"])
    # the counters and the captured spans come from one stamp a piece
    assert c["dispatcher_host_ms_spans"] == pytest.approx(c["dispatcher_host_ms"], rel=0.1)
    idle = harness.metric_reader("device_idle_share.serve").read(ctx)
    assert idle == pytest.approx(100.0)  # no device operation
    shares = sum(read[f"idle.{x}_share"] for x in ("dispatch_host", "sync",
                                                   "empty_queue", "gc"))
    assert 50.0 < shares <= idle + 1e-6


class _Event:
    """The part of a profiler event ``marker_latency_ns`` reads."""

    def __init__(self, name, on_host, corr, start):
        self._v = (name, "DeviceType.CPU" if on_host else "DeviceType.CUDA", corr, start)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]


def test_capture_run_marker_latency_on_synthetic_events():
    from portbench.capture_run import marker_latency_ns

    events = [
        _Event("cudaLaunchKernel", True, 30, 1_000),
        _Event("topk_dot_partial_kernel", False, 30, 2_000),
        _Event("cudaLaunchKernel", True, 31, 5_000),
        _Event(f"void at::cuda::{MARKER_KERNEL}(long)", False, 31, 68_400),
    ]
    # the marker kernel starts 63.4 µs after its own launch call
    assert marker_latency_ns(events) == 63_400
    assert marker_latency_ns(events[:2] + events[3:]) is None  # no launch call
    assert marker_latency_ns(events[:3]) is None  # no marker
