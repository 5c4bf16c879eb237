"""The count functions and the per-layer readers on hand-worked numbers,
and the device trace's reduction on intervals laid out by hand."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import parked_training_cell
from portbench.trace import DeviceTrace

PEAKS = harness.load_file_module(harness.BENCH_DIR / "peaks.py", "peaks_for_test").PEAKS


def test_topk_counts_by_hand():
    topk = harness.counts("topk")
    # 2 dispatches, 10 rows in all, 100 x 8 bf16 view, k 16
    ops, n_bytes = topk.work(2, 10, 100, 8, 2, 16)
    assert ops == 2 * 10 * 100 * 8 == 16_000
    assert n_bytes == 2 * 100 * 8 * 2 + 10 * 8 * 4 + 10 * 16 * 8 == 4_800
    assert topk.bound_s(16_000, 4_800, 1e6, 1e3) == 4.8
    # the int8 view: one byte an element and an f32 scale a row
    q = topk.view("quantized")
    ops, n_bytes = topk.work(2, 10, 100, 8, q["itemsize"], 16, q["row_scale_bytes"])
    assert n_bytes == 2 * 100 * (8 + 4) + 10 * 8 * 4 + 10 * 16 * 8 == 4_000
    assert topk.view("exact") == {"itemsize": 2, "row_scale_bytes": 0, "peak": "bfloat16_flops"}
    assert q["peak"] == "int8_ops" and set(topk.VIEWS) <= {"exact", "quantized"}
    for v in topk.VIEWS.values():
        assert v["peak"] in PEAKS


def test_topk_counts_refuse_a_score_mode_they_do_not_know():
    with pytest.raises(ValueError, match="approx"):
        harness.counts("topk").view("approx")


def test_als_sweep_counts_by_hand():
    c = harness.counts("als_sweep")
    # 3 rows solved against 4 fixed rows, 5 kept interactions, K = 2
    ops, n_bytes = c.half_step(3, 4, 5, 2)
    assert ops == pytest.approx(2 * 5 * 4 + 2 * 5 * 2 + 2 * 4 * 4 + 3 * (8 / 3 + 2 * 4))
    assert n_bytes == 8 * 5 + 4 * 4 * 2 + 4 * 3 * 2
    ops2, bytes2 = c.sweep(3, 4, 5, 6, 2)
    assert ops2 == pytest.approx(ops + c.half_step(4, 3, 6, 2)[0])
    assert bytes2 == n_bytes + c.half_step(4, 3, 6, 2)[1]


def _trace(ops, t0=0, t1=100):
    tr = DeviceTrace(torch, enabled=False)
    tr.ops, tr.t0, tr.t1 = ops, t0, t1
    return tr


def test_trace_union_counts_and_gaps():
    tr = _trace([("topk_dot_partial<bf16>", "kernel", 10, 30),
                 ("topk_merge", "kernel", 25, 40),
                 ("Memcpy HtoD", "memcpy", 60, 70),
                 ("gemm", "kernel", 95, 120)])
    assert tr.busy_intervals() == [(10, 40), (60, 70), (95, 100)]
    assert tr.busy_s() == pytest.approx(45e-9)
    assert tr.count() == 3 and tr.count(kernels_only=False) == 4
    assert tr.seconds_matching(("topk_dot_partial", "topk_merge")) == pytest.approx(35e-9)
    gaps = tr.idle_gaps([("gc", 72, 90), ("dispatcher wait", 0, 12),
                         ("dispatcher issue", 40, 58), ("dispatcher issue", 65, 96)])
    assert gaps == [["host: gc", pytest.approx(25e-9)],
                    ["host: dispatcher issue", pytest.approx(20e-9)],
                    ["host: dispatcher wait", pytest.approx(10e-9)]]


def _ctx(workload, counters, trace=None):
    cell = harness.resolve(harness.load_manifest(), workload)
    return harness.Context(cell, counters, {}, trace, PEAKS)


def test_serving_readers_by_hand():
    w = "als-serve-20m-250f.recommend-c2"
    counters = {"dispatches": 4, "rows": 100, "items": 1_000_000, "features": 250,
                "score_mode": "exact", "k": 32, "answers": 100, "window_s": 2.0, "latency_p95_ms": 80.5,
                "phases": {"parse": [0.01, 100], "auth": [0.002, 100], "serialize": [0.02, 100],
                           "write": [0.008, 100], "queue_wait": [1.5, 100]}}
    tr = _trace([("topk_dot_partial<bf16>", "kernel", 0, 4_000_000),
                 ("topk_merge", "kernel", 4_000_000, 5_000_000)], 0, 10_000_000)
    ctx = _ctx(w, counters, tr)
    read = lambda name: harness.metric_reader(name).read(ctx)
    assert read("http.host_ms") == pytest.approx(0.4)
    assert read("batcher.queue_wait_ms") == pytest.approx(15.0)
    assert read("batcher.rows_per_dispatch") == 25.0
    bound = (4 * 1e6 * 250 * 2 + 100 * 250 * 4 + 100 * 32 * 8) / 3.35e12
    assert read("topk_roofline") == pytest.approx(bound / 5e-3 * 100)
    assert read("serve.mfu") == pytest.approx(2 * 1e6 * 250 * 100 / (2.0 * 989e12) * 100)
    assert read("device_idle_share.serve") == pytest.approx(50.0)
    assert read("recommend_p95_ms") == 80.5
    # the same window over the int8 view: half the bytes and scales, int8 peak
    ctx.counters = dict(counters, score_mode="quantized")
    bound = max(2 * 100 * 1e6 * 250 / 1979e12,
                (4 * 1e6 * (250 + 4) + 100 * 250 * 4 + 100 * 32 * 8) / 3.35e12)
    assert read("topk_roofline") == pytest.approx(bound / 5e-3 * 100)
    assert read("serve.mfu") == pytest.approx(2 * 1e6 * 250 * 100 / (2.0 * 1979e12) * 100)
    ctx.counters = dict(counters, score_mode="approx")
    with pytest.raises(ValueError):
        read("topk_roofline")


def test_training_readers_by_hand():
    """The parked training cell's readers (tests/tiny.py)."""
    counters = {"sweeps": 10, "window_s": 5.0, "prepare_s": 7.5, "users": 100,
                "items": 50, "kept_u": 1000, "kept_i": 900, "features": 16}
    tr = _trace([("bmm", "kernel", 0, 1_000_000), ("potrf", "kernel", 1_000_000, 3_000_000),
                 ("Memcpy HtoD", "memcpy", 3_000_000, 4_000_000)], 0, 8_000_000)
    ctx = harness.Context(parked_training_cell(), counters, {}, tr, PEAKS)
    read = lambda name: harness.metric_reader(name).read(ctx)
    ops, n_bytes = harness.counts("als_sweep").sweep(100, 50, 1000, 900, 16)
    assert read("train.prepare_s") == 7.5
    assert read("train.launches_per_sweep") == 0.2
    bound = max(ops / 67e12, n_bytes / 3.35e12)
    assert read("als_sweep_roofline") == pytest.approx(bound * 10 / 3e-3 * 100)
    assert read("train.mfu") == pytest.approx(ops * 10 / (5.0 * 67e12) * 100)
    assert read("device_idle_share.train") == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["topk_roofline", "als_sweep_roofline",
                                  "device_idle_share.serve", "train.launches_per_sweep"])
def test_a_reader_with_nothing_to_read_returns_none(name):
    cell = parked_training_cell()
    assert harness.metric_reader(name).read(harness.Context(cell, {}, {}, None, PEAKS)) is None


@pytest.mark.cuda
def test_the_profiler_sees_the_card():
    """On the card: a traced matmul shows up as device time inside the
    window, aligned to the host clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(4096, 4096, device="cuda")
    with DeviceTrace(torch, True) as tr:
        for _ in range(10):
            a = a @ a / 64.0
    assert tr.count() >= 10
    assert 0 < tr.busy_s() <= tr.window_s
