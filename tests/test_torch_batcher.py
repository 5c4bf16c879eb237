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
