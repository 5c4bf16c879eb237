"""Serving helpers shared by the app endpoints (the port's copy of
oryx_tpu/serving/app.py:57-160): future chaining, the post-processing
pool, and the HTTP-status-carrying errors. The resource framework around
them is the next slice's."""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable

from oryx_tpu_torch.serving.futureutil import try_set_exception, try_set_result


def chain_future(
    future: "Future", fn: Callable[[Any], Any], executor=None
) -> "Future":
    """Future of fn(future.result()), exceptions carried through. With an
    executor, fn runs there instead of inline in the completing thread —
    REQUIRED when the completing thread is a latency-critical loop (the
    batcher dispatcher) or when fn may block."""
    out: Future = Future()

    def _apply(f):
        # out may already be cancelled by its consumer — try_set absorbs
        # the lost race instead of raising inside a done-callback
        try:
            result = fn(f.result())
        except BaseException as e:  # noqa: BLE001 - carried downstream
            try_set_exception(out, e)
            return
        try_set_result(out, result)

    if executor is None:
        future.add_done_callback(_apply)
    else:

        def _bounce(f):
            try:
                executor.submit(_apply, f)
            except Exception:
                # pool shut down: fail the future rather than leave
                # blocked callers hanging — and never run fn inline here,
                # because the completing thread may be the batcher
                # dispatcher, which arbitrary fn code could deadlock
                try_set_exception(
                    out, RuntimeError("post-processing pool is shut down")
                )
        future.add_done_callback(_bounce)
    return out


_POST_POOL = None
_POST_POOL_LOCK = threading.Lock()
_POST_POOL_WORKERS = 8  # overridden from config by the serving managers


def configure_post_pool(workers: int) -> None:
    """Size the post-processing pool (oryx.serving.api.post-workers) —
    takes effect at first use; an already-created pool keeps its size."""
    global _POST_POOL_WORKERS
    _POST_POOL_WORKERS = max(1, int(workers))


def post_pool():
    """Shared pool for per-request post-processing chained off batcher
    futures (trim/render work; a rescorer that blocks holds one of these
    threads, never the batcher dispatcher — and blocking top_n() callers
    post-process on their own thread, so nested rescorer queries cannot
    exhaust this pool into a deadlock)."""
    global _POST_POOL
    if _POST_POOL is None:
        with _POST_POOL_LOCK:
            if _POST_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _POST_POOL = ThreadPoolExecutor(
                    max_workers=_POST_POOL_WORKERS,
                    thread_name_prefix="oryx-topn-post",
                )
    return _POST_POOL


class OryxServingException(Exception):
    """HTTP-status-carrying error (reference OryxServingException).
    ``headers`` ride the response (e.g. Retry-After on a load shed)."""

    def __init__(
        self,
        status: int,
        message: str = "",
        headers: tuple[tuple[str, str], ...] = (),
    ):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers


class ShedLoad(OryxServingException):
    """Deliberate 503 under saturation: the serving tier refuses work it
    cannot queue honestly (batcher backlog past its bound) instead of
    letting latency grow without limit. Carries Retry-After so well-behaved
    clients back off."""

    def __init__(self, message: str = "overloaded", retry_after_sec: int = 1):
        super().__init__(
            503, message,
            headers=(("Retry-After", str(int(retry_after_sec))),),
        )
