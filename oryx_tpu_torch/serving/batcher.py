"""Request-coalescing micro-batcher for device top-k scoring (the port's
counterpart of oryx_tpu/serving/batcher.py).

The reference serves each /recommend request by fanning one thread pool
over LSH partitions (ALSServingModel.java:264-279). On the card the hot
loop is one fused score + top-k over the whole catalog (ops/topk.py), and
one dispatch per HTTP request would leave it scoring a single query row.
So:

- Concurrent requests are coalesced into ONE ``topk_dot_batch`` dispatch
  per (matrix, k-bucket) group. Coalescing is natural backpressure, not a
  timer: while the dispatcher scores batch N, arrivals queue and become
  batch N+1. An idle server dispatches a single request at once.
- k rounds up to a bucket and results are trimmed on the host. Rows are
  not padded: the kernel takes the batch size at run time, so a group of
  B queries scores B rows (the JAX package pads rows to bound XLA's
  recompiles, which eager PyTorch does not have).
- The dispatcher runs a depth-1 pipeline: batch N+1 is launched before
  batch N's results are read. Results come back by non-blocking copies
  into pinned host buffers, and one CUDA event per group says when they
  have landed.
- Past ``max_queue`` waiting requests, submits shed with ShedLoad (503 +
  Retry-After) instead of queueing without bound.

A group whose dispatch fails gets the exception on every one of its
futures: there is no host fallback. A request submitted from an HTTP
handler carries its phase ledger (common/perfattr.py), stamped with
queue_wait (submit to its group's launch) and device (launch to results on
the host). The wedge watchdog, its host drain and the rest of the JAX
package's dispatch telemetry wait for a later slice.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.perfattr import current_ledger
from oryx_tpu_torch.ops.als import PALLAS_TOPK_MAX_K, topk_dot_batch
from oryx_tpu_torch.serving.app import ShedLoad
from oryx_tpu_torch.serving.futureutil import try_set_exception, try_set_result

log = logging.getLogger(__name__)

# k rounds up to the smallest of these (then min'd with the item count);
# larger requests round to next_pow2(k). Every bucket up to
# PALLAS_TOPK_MAX_K rides the fused kernel — a default
# /recommend?howMany=10 overfetches to k=18 and lands in the 32 bucket.
K_BUCKETS = (16, 32, PALLAS_TOPK_MAX_K, 1024)

MAX_BATCH = 4096  # rows per device dispatch

# Queue-depth bound before the batcher sheds load (about two full
# dispatches deep): past it, every queued request only adds latency for
# everyone behind it, and an honest refusal lets the client retry elsewhere.
MAX_QUEUE = 8192


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def k_bucket(k: int) -> int:
    for b in K_BUCKETS:
        if k <= b:
            return b
    return _next_pow2(k)


class _Pending:
    __slots__ = ("vec", "k", "y", "future", "recall", "t_enq", "ledger")

    def __init__(self, vec, k, y, future, recall=1.0):
        self.vec = vec
        self.k = k
        self.y = y
        self.future = future
        self.recall = recall
        self.t_enq = time.monotonic()
        # the submitting request's phase ledger (thread-local, installed
        # by ServingApp.dispatch_nowait; None off the request path)
        self.ledger = current_ledger()
        if self.ledger is not None:
            # routing and the handler's pre-work since the last stamp
            # (parse/auth) count as parse, so the budget tiles the request
            tail = self.ledger.last_end()
            if tail is not None and tail < self.t_enq:
                self.ledger.add("parse", self.t_enq - tail, start=tail)


class _Group:
    """One launched dispatch: its requests, k bucket, host result buffers
    and the event recorded after their device-to-host copies. ``staged``
    keeps the pinned query buffer alive until its copy has run."""

    __slots__ = ("requests", "kb", "vals", "idx", "event", "staged",
                 "t_launch")

    def __init__(self, requests, kb, vals, idx, event=None, staged=None,
                 t_launch=0.0):
        self.requests = requests
        self.kb = kb
        self.vals = vals
        self.idx = idx
        self.event = event
        self.staged = staged
        self.t_launch = t_launch


class TopKBatcher:
    """Coalesces top-k scoring requests into batched device dispatches."""

    _shared: "TopKBatcher | None" = None
    _shared_lock = threading.Lock()

    @classmethod
    def shared(cls) -> "TopKBatcher":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = TopKBatcher()
        return cls._shared

    def __init__(
        self,
        max_batch: int = MAX_BATCH,
        max_queue: int = MAX_QUEUE,
        retry_after_sec: int = 1,
    ):
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.retry_after_sec = retry_after_sec
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: list[_Pending] = []  # guarded-by: _lock
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # dispatches / coalesced requests: coalesced / dispatches is the
        # achieved mean batch size
        self.dispatches = 0  # guarded-by: _lock (writes)
        self.coalesced = 0  # guarded-by: _lock (writes)
        # analytic operations dispatched to the card (2·B·I·F per group)
        self.flops_scored = 0.0  # guarded-by: _lock (writes)

    def configure(self, config) -> None:
        """Adopt the serving config's shed knobs (ServingLayer.start);
        0 / negative max-queue disables shedding."""
        self.max_queue = config.get_int(
            "oryx.serving.api.shed.max-queue", MAX_QUEUE
        )
        self.retry_after_sec = config.get_int(
            "oryx.serving.api.shed.retry-after-sec", 1
        )

    def register_gauges(self) -> None:
        """Expose the batcher's counters as callback gauges on the global
        metrics registry (the serving resources call this once at startup;
        scrapes then read live values with no per-scrape mutation). The
        JAX package's host-fallback, failover, device-down and peak-rate
        gauges have no source here: the port has no host path, and the
        watchdog and the peak table are not ported yet."""
        reg = get_registry()
        for name, help_text, fn in (
            ("oryx_topk_dispatches",
             "device top-k dispatches issued by the micro-batcher",
             lambda: float(self.dispatches)),
            ("oryx_topk_coalesced",
             "requests coalesced into device dispatches",
             lambda: float(self.coalesced)),
            ("oryx_topk_mean_batch",
             "achieved mean coalesced batch size (coalesced/dispatches "
             "over the process lifetime; >1 means requests are sharing "
             "device dispatches)",
             lambda: (
                 self.coalesced / self.dispatches if self.dispatches else 0.0
             )),
            ("oryx_topk_queue_depth",
             "requests waiting for a device dispatch right now; at "
             "oryx.serving.api.shed.max-queue new submits shed with 503",
             # len() is one GIL-atomic read and the gauge is advisory
             lambda: float(len(self._queue))),
            ("oryx_topk_flops_total",
             "analytic operations dispatched to device top-k scoring "
             "(2 x rows x items x features per dispatch)",
             lambda: float(self.flops_scored)),
        ):
            reg.gauge(name, help_text).set_function(fn)

    # -- public API --------------------------------------------------------

    def submit(self, vec: np.ndarray, k: int, y, recall: float = 1.0):
        """Score vec against device matrix y, returning (values, indices)
        for the top-k rows. Blocks until the coalesced dispatch completes."""
        return self.submit_nowait(vec, k, y, recall=recall).result()

    def submit_nowait(self, vec: np.ndarray, k: int, y,
                      recall: float = 1.0) -> Future:
        """submit() without the wait: the Future of (values, indices).
        recall < 1 selects the approximate scoring form."""
        vec = np.asarray(vec, dtype=np.float32)
        fut: Future = Future()
        p = _Pending(vec, int(k), y, fut, float(recall))
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self.max_queue > 0 and len(self._queue) >= self.max_queue:
                # saturation: refuse honestly instead of queueing without
                # bound; renders as 503 + Retry-After at the app boundary
                get_registry().counter("oryx_serving_shed_total").inc()
                raise ShedLoad(
                    f"top-k queue saturated ({len(self._queue)} deep)",
                    retry_after_sec=self.retry_after_sec,
                )
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="oryx-topk-batcher", daemon=True
                )
                self._thread.start()
            self._queue.append(p)
            self._cond.notify()
        return fut

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=5)

    # -- dispatcher --------------------------------------------------------

    def _run(self) -> None:
        inflight: list[_Group] = []
        while True:
            with self._cond:
                while not self._queue and not self._closed and not inflight:
                    self._cond.wait()
                if self._closed and not self._queue and not inflight:
                    return
                batch = self._queue[: self.max_batch]
                self._queue = self._queue[self.max_batch:]
            try:
                launched = self._launch(batch) if batch else []
            except Exception as e:  # a failure before the per-group guard
                log.exception("batcher launch failed")
                for p in batch:
                    try_set_exception(p.future, e)
                launched = []
            for g in inflight:
                self._resolve(g)
            inflight = launched

    def _launch(self, batch: list[_Pending]) -> list[_Group]:
        """Issue one device dispatch per (matrix, k-bucket, recall) group
        and start its result copies; returns the in-flight groups."""
        groups: dict[tuple[int, int, float], list[_Pending]] = {}
        for p in batch:
            kb = min(k_bucket(p.k), p.y.shape[0])
            groups.setdefault((id(p.y), kb, p.recall), []).append(p)
        with self._lock:
            self.dispatches += len(groups)
            self.coalesced += len(batch)
            self.flops_scored += sum(
                2.0 * len(g) * g[0].y.shape[0] * g[0].y.shape[1]
                for g in groups.values()
            )
        launched = []
        for (_, kb, recall), group in groups.items():
            # failures stay inside their group: a bad shape against one
            # matrix must not fail requests scoring another
            try:
                launched.append(self._launch_group(group, kb, recall))
            except Exception as e:
                log.exception("batcher group dispatch failed (k=%d)", kb)
                for p in group:
                    try_set_exception(p.future, e)
        return launched

    def _launch_group(self, group: list[_Pending], kb: int,
                      recall: float) -> _Group:
        y = group[0].y
        dev = y.device
        on_cuda = dev.type == "cuda"
        t_launch = time.monotonic()
        for p in group:
            if p.ledger is not None:
                p.ledger.add("queue_wait", t_launch - p.t_enq, start=p.t_enq)
        staged = torch.empty(
            (len(group), y.shape[1]), dtype=torch.float32, pin_memory=on_cuda
        )
        rows = staged.numpy()
        for i, p in enumerate(group):
            rows[i] = p.vec
        xs = staged.to(dev, non_blocking=True) if on_cuda else staged
        vals, idx = topk_dot_batch(xs, y, k=kb, recall=recall)
        if not on_cuda:
            return _Group(group, kb, vals, idx, t_launch=t_launch)
        h_vals = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        h_idx = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
        h_vals.copy_(vals, non_blocking=True)
        h_idx.copy_(idx, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Group(group, kb, h_vals, h_idx, event, staged, t_launch)

    def _resolve(self, g: _Group) -> None:
        try:
            if g.event is not None:
                g.event.synchronize()
            vals = g.vals.numpy()
            idx = g.idx.numpy()
            t_done = time.monotonic()
            for i, p in enumerate(g.requests):
                if p.ledger is not None:
                    p.ledger.add("device", t_done - g.t_launch,
                                 start=g.t_launch)
                k_eff = min(p.k, g.kb)
                try_set_result(
                    p.future, (vals[i, :k_eff].copy(), idx[i, :k_eff].copy())
                )
        except Exception as e:
            log.exception("batcher group resolve failed (k=%d)", g.kb)
            for p in g.requests:
                try_set_exception(p.future, e)
