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

Telemetry (the JAX package's, read by the same metric names): a request
submitted from an HTTP handler carries its phase ledger
(common/perfattr.py), stamped with queue_wait (submit to its group's
launch) and device (launch to results on the host), and, with tracing
on, ``batcher.queue_wait`` / ``batcher.device`` /
``batcher.compile_stall`` spans. Every resolved group records one
``DispatchRecord`` (common/perfstats.py: FLOPs, bytes, wall-clock, the
peak of the dispatched type). The dispatcher thread's loop is cut into
pieces that tile it (``PIECES``: each runs from its start to the next
one's, so every instant of the thread is under exactly one), and one
helper stamps each piece as it ends: its seconds into the always-on
``seconds_by_piece`` (``oryx_topk_dispatcher_seconds_total{piece}``), a
``batcher.<piece>`` span with tracing on (``TopKBatcher.timeline`` reads
them from the tracer's latest capture), and its slice of the open idle
gap between dispatches, which is then split by cause
(``classify_idle_gap``). The accounting reads host clocks only: it adds
no device synchronisation.

A group whose dispatch fails gets the exception on every one of its
futures, and there is no host fallback. The same holds for a wedge: a
watchdog thread declares the card wedged when a dispatch cycle is stuck
past ``device_timeout`` (longer while the kernel library's first load,
an nvcc build, is in flight), supersedes the stuck dispatcher thread,
fails every in-flight and queued request with ``DeviceWedged`` (503 +
Retry-After), refuses new submits the same way while the card is down,
and probes the card in disposable threads until a one-row dispatch comes
back. No request is ever scored on the host.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common.flightrec import get_flightrec
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.perfattr import (
    classify_idle_gap,
    current_ledger,
    get_perfattr,
)
from oryx_tpu_torch.common.perfstats import get_perfstats
from oryx_tpu_torch.common.tracing import current_span, get_tracer
from oryx_tpu_torch.ops import topk
from oryx_tpu_torch.ops.als import PALLAS_TOPK_MAX_K, topk_dot_batch
from oryx_tpu_torch.ops.flops import peak_flops_for_name
from oryx_tpu_torch.ops.transfer import QuantizedMatrix
from oryx_tpu_torch.serving.app import ShedLoad
from oryx_tpu_torch.serving.futureutil import try_set_exception, try_set_result

log = logging.getLogger(__name__)

_TRACER = get_tracer()
_PERF = get_perfstats()
_PA = get_perfattr()

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

# A dispatch cycle stuck this long is a wedged card, not a slow kernel —
# except while the kernel library's first load (an nvcc build on a cold
# build directory) is in flight, which gets COMPILE_TIMEOUT. While the
# card is down, probes re-test it every PROBE_INTERVAL.
DEVICE_TIMEOUT = 75.0
COMPILE_TIMEOUT = 240.0
PROBE_INTERVAL = 20.0

# The dispatcher thread's pieces: "wait" on an empty queue; "stage" from
# taking a batch to its launch (grouping, ledgers, the pinned query rows);
# "issue" the wrapper's launches and copies; "sync" a group's event wait
# and read-back; "distribute" its results to the futures. A piece lasts
# until the next one starts, so the loop's bookkeeping counts under the
# piece it follows.
PIECES = ("wait", "stage", "issue", "sync", "distribute")
_SPAN_NAMES = {p: "batcher." + p for p in PIECES}
_PIECE_OF_SPAN = {v: k for k, v in _SPAN_NAMES.items()}


class DeviceWedged(ShedLoad):
    """The card is wedged (a dispatch stuck past the watchdog's timeout)
    or still down after one: the request is refused with 503 and a
    Retry-After of the probe interval, never scored on the host."""


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def k_bucket(k: int) -> int:
    for b in K_BUCKETS:
        if k <= b:
            return b
    return _next_pow2(k)


def _dispatch_bytes(rows: int, features: int, y, kb: int) -> float:
    """Approximate bytes one coalesced dispatch moves: the query upload,
    the item-matrix stream (the dominant term — the scan reads all of Y),
    and the result read-back."""
    return float(rows * features * 4 + int(y.nbytes) + rows * kb * 8)


class _Pending:
    __slots__ = ("vec", "k", "y", "future", "recall", "score_mode", "t_enq",
                 "ledger", "trace_parent", "dev_span")

    def __init__(self, vec, k, y, future, recall=1.0, score_mode="exact"):
        self.vec = vec
        self.k = k
        self.y = y
        self.future = future
        self.recall = recall
        # labels the dispatch's perfstats record (exact | quantized | approx)
        self.score_mode = score_mode
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
        # with tracing on: the submitting request's span (thread-current)
        # and a one-element box holding the in-flight device span
        self.trace_parent = current_span() if _TRACER.enabled else None
        self.dev_span: list = []

    def finish_dev_span(self, **attrs) -> None:
        """End the device span exactly once: the dispatcher's resolve and
        the watchdog's failure may race for it, and list.pop is one
        GIL-atomic call, so only one caller gets the span."""
        try:
            span = self.dev_span.pop()
        except IndexError:
            return
        _TRACER.finish(span, **attrs)


class _Group:
    """One launched dispatch: its requests, k bucket, host result buffers,
    the event recorded after their device-to-host copies, and its cost
    record. ``staged`` keeps the pinned query buffer alive until its copy
    has run."""

    __slots__ = ("requests", "kb", "vals", "idx", "event", "staged",
                 "t_launch", "flops", "bytes_moved", "rows")

    def __init__(self, requests, kb, vals, idx, event, staged, t_launch,
                 flops, bytes_moved, rows):
        self.requests = requests
        self.kb = kb
        self.vals = vals
        self.idx = idx
        self.event = event
        self.staged = staged
        self.t_launch = t_launch
        self.flops = flops
        self.bytes_moved = bytes_moved
        self.rows = rows


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
        device_timeout: float = DEVICE_TIMEOUT,
        probe_interval: float = PROBE_INTERVAL,
        compile_timeout: float = COMPILE_TIMEOUT,
        max_queue: int = MAX_QUEUE,
        retry_after_sec: int = 1,
    ):
        self.max_batch = max_batch
        self.device_timeout = device_timeout
        self.probe_interval = probe_interval
        self.compile_timeout = compile_timeout
        self.max_queue = max_queue
        self.retry_after_sec = retry_after_sec
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: list[_Pending] = []  # guarded-by: _lock
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # watchdog state: _busy_since marks the start of the dispatcher's
        # current cycle (launch, then the previous groups' read-back);
        # _inflight holds every request the (possibly wedged) dispatcher
        # owns, so the watchdog can fail them
        self._busy_since: float | None = None  # guarded-by: _lock
        self._inflight: dict[int, _Pending] = {}  # guarded-by: _lock
        self._device_down = threading.Event()
        self._watchdog: threading.Thread | None = None  # guarded-by: _lock
        self._probe_at = 0.0  # guarded-by: _lock
        self._probing = False  # guarded-by: _lock
        self._probe_started = 0.0  # guarded-by: _lock
        self._last_y = None  # guarded-by: _lock
        # idle-gap attribution (common/perfattr.py): _gap_mark is when the
        # card was last known busy (dispatch issued / results on the host);
        # the accumulators hold measured slices of the idle time since —
        # the "wait" pieces (empty queue), the "stage" and "distribute"
        # pieces (host serialize), and the down window (failover backoff).
        # Classified and reset at the next launch, reset whenever results
        # land. The dispatcher thread alone writes the first three.
        self._gap_mark = time.monotonic()
        self._gap_wait = 0.0
        self._gap_host = 0.0
        self._gap_down = 0.0  # guarded-by: _lock
        self._down_since = 0.0  # guarded-by: _lock
        # the dispatcher thread's open piece (PIECES), its start and the
        # rows and k bucket it works on; seconds_by_piece sums the pieces
        # ended so far. Dispatcher thread only (_enter).
        self._piece = "wait"
        self._piece_t0 = self._gap_mark
        self._piece_rows = 0
        self._piece_k = 0
        self.seconds_by_piece = dict.fromkeys(PIECES, 0.0)
        self._dispatcher_tids: set[int] = set()
        # dispatches / coalesced requests: coalesced / dispatches is the
        # achieved mean batch size
        self.dispatches = 0  # guarded-by: _lock (writes)
        self.coalesced = 0  # guarded-by: _lock (writes)
        self.device_failovers = 0  # guarded-by: _lock (writes)
        # analytic operations dispatched to the card (2·B·I·F per group)
        self.flops_scored = 0.0  # guarded-by: _lock (writes)
        # peak of the most recent dispatch's type (None: unknown or CPU)
        self._peak_flops: float | None = None
        self._device_names: dict[int, str] = {}

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
        JAX package's host-fallback gauge has no source here: no request
        is scored on the host."""
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
            ("oryx_topk_device_failovers",
             "wedged dispatches declared by the watchdog; their requests "
             "were failed with 503 (DeviceWedged), not scored on the host",
             lambda: float(self.device_failovers)),
            ("oryx_topk_device_down",
             "1 while the card is down after a wedge (submits get 503 "
             "until a probe dispatch comes back)",
             lambda: 1.0 if self._device_down.is_set() else 0.0),
            ("oryx_topk_queue_depth",
             "requests waiting for a device dispatch right now; at "
             "oryx.serving.api.shed.max-queue new submits shed with 503",
             # len() is one GIL-atomic read and the gauge is advisory
             lambda: float(len(self._queue))),
            ("oryx_topk_flops_total",
             "analytic operations dispatched to device top-k scoring "
             "(2 x rows x items x features per dispatch)",
             lambda: float(self.flops_scored)),
            ("oryx_device_peak_flops",
             "dense peak operations/s of the serving card at the type of "
             "the most recent dispatch (int8/bf16/f32, ops/flops.py; 0 "
             "when unknown or on the CPU)",
             lambda: float(self._peak_flops or 0.0)),
        ):
            reg.gauge(name, help_text).set_function(fn)
        pieces = reg.counter(
            "oryx_topk_dispatcher_seconds_total",
            "seconds of the batcher's dispatcher thread by piece of its "
            "loop (wait, stage, issue, sync, distribute); the pieces tile "
            "the thread, so their sum is its running time", labeled=True)
        for piece in PIECES:
            pieces.set_function(
                lambda piece=piece: self.seconds_by_piece[piece], piece=piece)
        # the kernels' own launch counts (ops/topk.py bumps them where it
        # launches), so a process that serves on the card shows it did
        launches = reg.counter(
            "oryx_cuda_kernel_launches_total",
            "launches of the hand-written top-k kernels in this process, "
            "by kernel and the type of its items", labeled=True)
        for t in topk.PARTIAL_LAUNCHES_BY_TYPE:
            launches.set_function(
                lambda t=t: float(topk.PARTIAL_LAUNCHES_BY_TYPE[t]),
                kernel="topk_dot_partial", type=t)
        launches.set_function(lambda: float(topk.LAUNCHES["topk_merge"]),
                              kernel="topk_merge", type="float32")

    def _peak_for_matrix(self, y) -> float | None:
        """The card's dense peak at the type this dispatch streams (int8
        for a QuantizedMatrix, the view's dtype otherwise), so a quantized
        window's MFU divides by the int8 peak, never flattering itself
        against bf16. None on the CPU or for a card the table lacks."""
        dev = y.device
        if dev.type != "cuda":
            return None
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        name = self._device_names.get(index)
        if name is None:
            name = self._device_names[index] = torch.cuda.get_device_name(index)
        dtype = "int8" if isinstance(y, QuantizedMatrix) else str(y.dtype)
        return peak_flops_for_name(name, dtype.removeprefix("torch."))

    # -- public API --------------------------------------------------------

    def submit(self, vec: np.ndarray, k: int, y, recall: float = 1.0,
               score_mode: str = "exact"):
        """Score vec against device matrix y, returning (values, indices)
        for the top-k rows. Blocks until the coalesced dispatch completes."""
        return self.submit_nowait(
            vec, k, y, recall=recall, score_mode=score_mode
        ).result()

    def submit_nowait(self, vec: np.ndarray, k: int, y,
                      recall: float = 1.0, score_mode: str = "exact") -> Future:
        """submit() without the wait: the Future of (values, indices).
        recall < 1 selects the approximate scoring form; score_mode labels
        the dispatch's perfstats record. Raises ShedLoad when the queue is
        full and DeviceWedged while the card is down."""
        vec = np.asarray(vec, dtype=np.float32)
        fut: Future = Future()
        p = _Pending(vec, int(k), y, fut, float(recall), score_mode)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            # the probe tests the matrix that will actually be served
            self._last_y = y
            down = self._device_down.is_set()
            if not down:
                if self.max_queue > 0 and len(self._queue) >= self.max_queue:
                    # saturation: refuse honestly instead of queueing
                    # without bound; renders as 503 + Retry-After
                    get_registry().counter("oryx_serving_shed_total").inc()
                    # one flight event per storm, not per request
                    get_flightrec().record(
                        kind="shed-episode", episode_s=5.0,
                        queue_depth=len(self._queue),
                    )
                    raise ShedLoad(
                        f"top-k queue saturated ({len(self._queue)} deep)",
                        retry_after_sec=self.retry_after_sec,
                    )
                self._ensure_thread()
                self._ensure_watchdog()
                self._queue.append(p)
                self._cond.notify()
        if down:
            self._maybe_probe()
            raise DeviceWedged(
                "the card is down after a wedged dispatch",
                retry_after_sec=max(1, round(self.probe_interval)),
            )
        return fut

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=5)
        with self._lock:
            self._last_y = None

    # -- dispatcher --------------------------------------------------------

    def _ensure_thread(self) -> None:  # holds _lock
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="oryx-topk-batcher", daemon=True
            )
            self._thread.start()

    def _ensure_watchdog(self) -> None:  # holds _lock
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog = threading.Thread(
                target=self._watch, name="oryx-topk-watchdog", daemon=True
            )
            self._watchdog.start()

    @property
    def timeline(self) -> list[tuple[str, float, float]]:
        """This batcher's dispatcher pieces in the tracer's latest capture
        (``Tracer.capture()``), as (piece, t0, t1) on ``time.monotonic``
        in the order they ran; empty before any capture."""
        cap = _TRACER.last_capture
        if cap is None:
            return []
        tids = self._dispatcher_tids
        return [(_PIECE_OF_SPAN[s.name], s.start, s.end) for s in cap.spans
                if s.name in _PIECE_OF_SPAN and s.tid in tids]

    def _enter(self, piece: str, t: float, rows: int = 0, k: int = 0) -> None:
        """End the dispatcher thread's open piece at ``t`` and start
        ``piece`` there (the same piece again only takes the new rows and
        k). The ended piece adds its seconds to ``seconds_by_piece``, its
        ``batcher.<piece>`` span with tracing on, and its part inside the
        open idle gap to that gap's empty-queue ("wait") or host-serialize
        ("stage", "distribute") slice. A superseded dispatcher stamps
        nothing."""
        if piece == self._piece:
            self._piece_rows, self._piece_k = rows, k
            return
        if threading.current_thread() is not self._thread:
            return
        prev, t0 = self._piece, self._piece_t0
        self.seconds_by_piece[prev] += t - t0
        if _TRACER.enabled:
            _TRACER.record_interval(_SPAN_NAMES[prev], t0, t,
                                    rows=self._piece_rows, k=self._piece_k)
        inside = t - max(t0, self._gap_mark)
        if inside > 0.0:
            if prev == "wait":
                self._gap_wait += inside
            elif prev != "issue" and prev != "sync":
                self._gap_host += inside
        self._piece, self._piece_t0 = piece, t
        self._piece_rows, self._piece_k = rows, k

    def _run(self) -> None:
        me = threading.current_thread()
        self._dispatcher_tids.add(me.ident)
        self._piece, self._piece_t0 = "wait", time.monotonic()
        inflight: list[_Group] = []
        while True:
            with self._cond:
                while not self._queue and not self._closed and not inflight:
                    self._enter("wait", time.monotonic())
                    self._cond.wait()
                if self._closed and not self._queue and not inflight:
                    self._enter("wait", time.monotonic())  # ends the last piece
                    return
                if self._thread is not me:
                    # superseded after a wedge: whatever this thread still
                    # holds was failed by the watchdog
                    return
                if self._queue:
                    self._enter("stage", time.monotonic(),
                                rows=min(len(self._queue), self.max_batch))
                batch = self._queue[: self.max_batch]
                self._queue = self._queue[self.max_batch:]
                for p in batch:
                    self._inflight[id(p)] = p
                self._busy_since = time.monotonic()
            try:
                launched = self._launch(batch) if batch else []
            except Exception as e:  # a failure before the per-group guard
                log.exception("batcher launch failed")
                for p in batch:
                    p.finish_dev_span(error=type(e).__name__)
                    try_set_exception(p.future, e)
                launched = []
            for g in inflight:
                self._resolve(g)
            with self._cond:
                if self._thread is not me:
                    # superseded mid-cycle: the replacement owns
                    # _busy_since now
                    return
                self._busy_since = None
                for g in inflight:
                    for p in g.requests:
                        self._inflight.pop(id(p), None)
                for p in batch:
                    if p.future.done():
                        self._inflight.pop(id(p), None)
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
        launched = []
        gap_pending = True  # classify the inter-dispatch idle gap once
        for (_, kb, recall), group in groups.items():
            # failures stay inside their group: a bad shape against one
            # matrix must not fail requests scoring another
            try:
                faults.fire("serving.device")
                with self._lock:
                    if self._thread is not threading.current_thread():
                        # superseded after a wedge (while stuck in this
                        # very loop): the watchdog failed these requests,
                        # so launch nothing more on the card
                        return launched
                launched.append(
                    self._launch_group(group, kb, recall, gap_pending)
                )
                gap_pending = False
            except Exception as e:
                log.exception("batcher group dispatch failed (k=%d)", kb)
                for p in group:
                    p.finish_dev_span(error=type(e).__name__)
                    try_set_exception(p.future, e)
        return launched

    def _launch_group(self, group: list[_Pending], kb: int, recall: float,
                      classify_gap: bool) -> _Group:
        y = group[0].y
        dev = y.device
        on_cuda = dev.type == "cuda"
        b, n_items, features = len(group), y.shape[0], y.shape[1]
        flops = 2.0 * b * n_items * features
        # the MFU window divides by the peak of the type just dispatched
        self._peak_flops = self._peak_for_matrix(y)
        _PERF.set_peak("serving", self._peak_flops)
        with self._lock:
            self.flops_scored += flops
        tr = _TRACER
        t_launch = time.monotonic()
        self._enter("stage", t_launch, rows=b, k=kb)
        for p in group:
            if p.ledger is not None:
                p.ledger.add("queue_wait", t_launch - p.t_enq, start=p.t_enq)
            if tr.enabled and p.trace_parent is not None:
                tr.record_interval(
                    "batcher.queue_wait", p.t_enq, t_launch,
                    parent=p.trace_parent,
                )
                # device span: launch until the results are on the host
                # (_resolve); one per request, so every request's trace
                # tree shows its own device time
                p.dev_span.append(tr.start(
                    "batcher.device", parent=p.trace_parent, k=kb, batch=b,
                ))
        staged = torch.empty(
            (b, features), dtype=torch.float32, pin_memory=on_cuda
        )
        rows = staged.numpy()
        for i, p in enumerate(group):
            rows[i] = p.vec
        cold = on_cuda and not topk.library_loaded()
        t_disp = time.monotonic()
        causes: dict[str, float] = {}
        self._enter("issue", t_disp, rows=b, k=kb)
        with self._lock:
            if classify_gap:
                # the idle gap between the previous dispatch finishing and
                # this one being issued, split by measured cause
                causes = classify_idle_gap(
                    t_disp - self._gap_mark, wait_s=self._gap_wait,
                    serialize_s=self._gap_host, down_s=self._gap_down,
                )
                self._gap_wait = self._gap_host = self._gap_down = 0.0
                self._gap_mark = t_disp
        for cause, s in causes.items():
            _PA.record_idle_gap(cause, s)
        xs = staged.to(dev, non_blocking=True) if on_cuda else staged
        vals, idx = topk_dot_batch(xs, y, k=kb, recall=recall)
        event = None
        if on_cuda:
            h_vals = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            h_idx = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
            h_vals.copy_(vals, non_blocking=True)
            h_idx.copy_(idx, non_blocking=True)
            vals, idx = h_vals, h_idx
            event = torch.cuda.Event()
            event.record()
        t_issued = time.monotonic()
        # the card is busy from here: the next idle gap starts when its
        # results land (_resolve)
        self._gap_mark = max(self._gap_mark, t_issued)
        if cold and tr.enabled:
            # this launch loaded the kernel library (ops/topk.py records
            # the compile and its idle gap); mark the stall in the trace
            tr.record_interval(
                "batcher.compile_stall", t_disp, t_issued,
                parent=group[0].trace_parent, k=kb, rows=b,
            )
        return _Group(group, kb, vals, idx, event, staged, t_launch, flops,
                      _dispatch_bytes(b, features, y, kb), b)

    def _resolve(self, g: _Group) -> None:
        try:
            self._enter("sync", time.monotonic(), rows=g.rows, k=g.kb)
            if g.event is not None:
                g.event.synchronize()
            vals = g.vals.numpy()
            idx = g.idx.numpy()
            t_done = time.monotonic()
            self._enter("distribute", t_done, rows=g.rows, k=g.kb)
            # results are on the host: record the dispatch's cost. The view
            # holds live rows only, so valid and capacity rows are equal.
            lead = g.requests[0]
            n_items = int(lead.y.shape[0])
            _PERF.record_dispatch(
                "serving",
                flops=g.flops, bytes_moved=g.bytes_moved,
                wall_s=t_done - g.t_launch, rows=g.rows, padded_rows=g.rows,
                valid_rows=n_items, capacity_rows=n_items,
                trace_id=(lead.trace_parent.trace_id
                          if lead.trace_parent is not None else None),
                t_start=g.t_launch, score_mode=lead.score_mode,
            )
            with self._lock:
                # the card finished this dispatch when its results landed:
                # the next idle gap starts here, and slices measured
                # before it belong to no gap
                if t_done > self._gap_mark:
                    self._gap_mark = t_done
                    self._gap_wait = self._gap_host = self._gap_down = 0.0
            for i, p in enumerate(g.requests):
                p.finish_dev_span()
                if p.ledger is not None:
                    p.ledger.add("device", t_done - g.t_launch,
                                 start=g.t_launch)
                k_eff = min(p.k, g.kb)
                # the watchdog may have failed this request while the
                # read-back sat on a wedged card; try_set absorbs that
                try_set_result(
                    p.future, (vals[i, :k_eff].copy(), idx[i, :k_eff].copy())
                )
        except Exception as e:
            log.exception("batcher group resolve failed (k=%d)", g.kb)
            for p in g.requests:
                p.finish_dev_span(error=type(e).__name__)
                try_set_exception(p.future, e)

    # -- watchdog: a wedged card ---------------------------------------------

    def _compile_grace(self, now: float) -> bool:
        """True while the kernel library's first load is in flight and
        younger than compile_timeout: a cold nvcc build, not a wedge."""
        started = topk.library_load_started()
        return started is not None and now < started + self.compile_timeout

    def _watch(self) -> None:
        while True:
            time.sleep(min(1.0, self.device_timeout / 4))
            if self._device_down.is_set():
                self._maybe_probe()
            with self._cond:
                if self._closed:
                    return
                busy = self._busy_since
                now = time.monotonic()
                if (busy is None or now - busy <= self.device_timeout
                        or self._compile_grace(now)):
                    continue
                # mark the card down FIRST so new submits are refused,
                # then fail everything the stuck dispatcher owns plus the
                # whole queue
                self.device_failovers += 1
                self._device_down.set()
                self._down_since = now  # the failover_backoff window
                self._probe_at = now + self.probe_interval
                stuck = list(self._inflight.values()) + self._queue
                self._inflight.clear()
                self._queue = []
                self._busy_since = None
                self._thread = None  # supersede the stuck dispatcher
            log.error(
                "device dispatch stuck > %.0fs: failing %d requests with "
                "503 and marking the card down", self.device_timeout,
                len(stuck),
            )
            get_flightrec().record(
                kind="wedge", layer="serving-device", state="wedged",
                requests=len(stuck), timeout_s=self.device_timeout,
            )
            err = DeviceWedged(
                f"device dispatch exceeded {self.device_timeout}s",
                retry_after_sec=max(1, round(self.probe_interval)),
            )
            for p in stuck:
                p.finish_dev_span(error="DeviceWedged")
                try_set_exception(p.future, err)

    def _maybe_probe(self) -> None:
        """While the card is down, test it with a one-row dispatch on the
        last served view, in a disposable thread (a probe into a wedged
        card hangs, and must never block a request or the watchdog). A
        probe that hangs is abandoned after device_timeout."""
        with self._lock:
            now = time.monotonic()
            if self._probing and now - self._probe_started > self.device_timeout:
                # the probe itself hung; its thread cannot be cancelled
                self._probing = False
            if self._probing or self._last_y is None or now < self._probe_at:
                return
            self._probing = True
            self._probe_started = now
            y = self._last_y

        def probe() -> None:
            ok = False
            try:
                z = torch.zeros((1, y.shape[1]), dtype=torch.float32,
                                device=y.device)
                # a k the serving path dispatches, so the probe takes the
                # same kernel instantiation
                topk_dot_batch(z, y, k=min(K_BUCKETS[0], y.shape[0]))
                if y.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
                ok = True
            except Exception:
                log.info("device probe failed; the card stays down")
            with self._lock:
                self._probing = False
                self._probe_at = time.monotonic() + self.probe_interval
                recovered = ok and self._device_down.is_set()
                if recovered:
                    self._device_down.clear()
                    if self._down_since:
                        # the whole down window was card idle by fiat:
                        # charged to failover_backoff in the next gap
                        self._gap_down += time.monotonic() - self._down_since
                        self._down_since = 0.0
            if recovered:
                log.warning("device probe succeeded: resuming dispatch")
                get_flightrec().record(
                    kind="wedge", layer="serving-device", state="cleared",
                )

        threading.Thread(
            target=probe, name="oryx-topk-probe", daemon=True
        ).start()
