"""The port's micro-batcher (oryx_tpu_torch/serving/batcher.py) on the CPU:
its k buckets against the JAX package's, unpadded groups, coalescing, load
shedding, and a failed group's exception reaching every one of its
futures."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from oryx_tpu.serving import batcher as J
from oryx_tpu_torch.serving import batcher as P
from oryx_tpu_torch.serving.app import ShedLoad


def test_buckets_match_jax():
    assert P.K_BUCKETS == J.K_BUCKETS
    assert (P.MAX_BATCH, P.MAX_QUEUE) == (J.MAX_BATCH, J.MAX_QUEUE)
    for k in list(range(1, 300)) + [1000, 1024, 1025, 5000]:
        assert P.k_bucket(k) == J.k_bucket(k)


def test_groups_dispatch_unpadded(monkeypatch):
    # the kernel takes the batch size at run time: a group of B requests
    # scores B query rows, never a padded bucket
    y = torch.from_numpy(
        np.random.default_rng(2).standard_normal((70, 6)).astype(np.float32))
    rows, entered, gate = [], threading.Event(), threading.Event()
    real = P.topk_dot_batch

    def recording(xs, *args, **kwargs):
        rows.append(xs.shape[0])
        entered.set()
        gate.wait(30)
        return real(xs, *args, **kwargs)

    monkeypatch.setattr(P, "topk_dot_batch", recording)
    b = P.TopKBatcher()
    try:
        first = b.submit_nowait(np.ones(6, np.float32), 4, y)
        assert entered.wait(30)
        rest = [b.submit_nowait(np.full(6, j, np.float32), 4, y)
                for j in range(5)]
        gate.set()
        for f in [first] + rest:
            assert len(f.result(timeout=30)[1]) == 4
    finally:
        gate.set()
        b.close()
    assert rows == [1, 5]


def _plain_topk(vec, y, k):
    s = y.float().numpy() @ vec
    order = np.argsort(-s, kind="stable")[:k]
    return s[order], order


def test_concurrent_requests_coalesce_and_match_plain():
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((800, 16)).astype(np.float32))
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    b = P.TopKBatcher()
    try:
        futs = [b.submit_nowait(v, 10, y) for v in vecs]
        results = [f.result(timeout=60) for f in futs]
        assert b.coalesced == 300
        assert b.dispatches < 300
    finally:
        b.close()
    for v, (vals, idx) in zip(vecs, results):
        want_v, want_i = _plain_topk(v, y, 10)
        assert np.array_equal(idx, want_i)
        np.testing.assert_allclose(vals, want_v, atol=1e-4)


def test_sheds_past_max_queue(monkeypatch):
    y = torch.zeros((50, 4))
    vec = np.ones(4, np.float32)
    entered, gate = threading.Event(), threading.Event()
    real = P.topk_dot_batch

    def held(*args, **kwargs):  # hold the dispatcher inside a dispatch
        entered.set()
        gate.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(P, "topk_dot_batch", held)
    b = P.TopKBatcher(max_queue=3, retry_after_sec=7)
    try:
        first = b.submit_nowait(vec, 3, y)
        assert entered.wait(30)
        queued = [b.submit_nowait(vec, 3, y) for _ in range(3)]
        with pytest.raises(ShedLoad) as e:
            b.submit_nowait(vec, 3, y)
        assert e.value.status == 503
        assert ("Retry-After", "7") in e.value.headers
    finally:
        gate.set()
    try:
        for f in [first] + queued:
            assert len(f.result(timeout=30)[1]) == 3
    finally:
        b.close()


def test_a_failed_group_fails_its_futures_only():
    rng = np.random.default_rng(4)
    good = torch.from_numpy(rng.standard_normal((60, 8)).astype(np.float32))
    bad = torch.zeros((60, 5))  # queries have 8 features: staging raises
    b = P.TopKBatcher()
    try:
        f_bad = [b.submit_nowait(np.ones(8, np.float32), 4, bad)
                 for _ in range(5)]
        f_good = b.submit_nowait(np.ones(8, np.float32), 4, good)
        for f in f_bad:
            with pytest.raises(ValueError):
                f.result(timeout=30)
        assert len(f_good.result(timeout=30)[1]) == 4
    finally:
        b.close()


def test_configure_adopts_the_shed_knobs_like_jax():
    from oryx_tpu.common.config import load_config as jax_load_config
    from oryx_tpu_torch.common.config import load_config

    overlay = {"oryx.serving.api.shed.max-queue": 17,
               "oryx.serving.api.shed.retry-after-sec": 4}
    jb, pb = J.TopKBatcher(), P.TopKBatcher()
    jb.configure(jax_load_config(overlay=overlay))
    pb.configure(load_config(overlay=overlay))
    assert (pb.max_queue, pb.retry_after_sec) == (17, 4)
    assert (pb.max_queue, pb.retry_after_sec) == (jb.max_queue,
                                                  jb.retry_after_sec)
    pb.configure(load_config())
    assert pb.max_queue == P.MAX_QUEUE


def test_gauges_read_the_live_counters():
    from oryx_tpu_torch.common.metrics import get_registry

    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    b = P.TopKBatcher()
    try:
        b.register_gauges()
        for f in [b.submit_nowait(rng.standard_normal(6), 5, y)
                  for _ in range(9)]:
            f.result(timeout=30)
        text = get_registry().render_prometheus()
    finally:
        b.close()
    values = dict(line.rsplit(" ", 1) for line in text.splitlines()
                  if line.startswith("oryx_topk_"))
    assert float(values["oryx_topk_coalesced"]) == 9
    assert float(values["oryx_topk_dispatches"]) == b.dispatches
    assert float(values["oryx_topk_mean_batch"]) == 9 / b.dispatches
    assert float(values["oryx_topk_queue_depth"]) == 0
    # 2 x rows x items x features over every dispatch
    assert float(values["oryx_topk_flops_total"]) == 2.0 * 9 * 40 * 6
    # the same series names as the JAX package's batcher exposes
    jax_names = set(J.TopKBatcher.register_gauges.__code__.co_consts)
    assert set(values) <= jax_names


def test_requests_stamp_their_phase_ledger():
    from oryx_tpu_torch.common.perfattr import PhaseLedger, swap_ledger

    y = torch.from_numpy(
        np.random.default_rng(6).standard_normal((30, 4)).astype(np.float32))
    ledger = PhaseLedger()
    ledger.add("parse", 0.0, start=ledger.t0)
    b = P.TopKBatcher()
    prev = swap_ledger(ledger)
    try:
        fut = b.submit_nowait(np.ones(4, np.float32), 3, y)
    finally:
        swap_ledger(prev)
    try:
        fut.result(timeout=30)
    finally:
        b.close()
    phases = [p for p, _start, _s in ledger.items()]
    assert phases[-2:] == ["queue_wait", "device"]
    assert all(s >= 0 for _p, _start, s in ledger.items())


def test_a_shed_counts_on_the_serving_shed_counter(monkeypatch):
    from oryx_tpu_torch.common.metrics import get_registry

    counter = get_registry().counter("oryx_serving_shed_total")
    before = counter.value()
    b = P.TopKBatcher(max_queue=0)
    b.max_queue = 1
    b._queue.append(object())  # a full queue, no dispatcher running
    with pytest.raises(ShedLoad):
        b.submit_nowait(np.ones(4, np.float32), 3, torch.zeros((5, 4)))
    assert counter.value() == before + 1
