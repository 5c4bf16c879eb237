"""Race-tolerant Future resolution.

Several producers may race to resolve the same concurrent.futures.Future:
the batcher's dispatcher vs the watchdog's host-side drain, a deferred
handler's completion vs the async frontend cancelling on client
disconnect. Losing such a race raises InvalidStateError from
set_result/set_exception — which, inside a done-callback or a dispatcher
loop, turns one already-resolved request into spurious failures for its
neighbours. Every resolution site goes through these helpers instead.
"""

from __future__ import annotations

from concurrent.futures import Future, InvalidStateError


def try_set_result(future: Future, result) -> bool:
    """Resolve `future` with `result` unless another producer (or a
    cancellation) got there first. Returns True iff this call delivered."""
    if future.done():
        return False
    try:
        future.set_result(result)
        return True
    except InvalidStateError:
        return False


def try_set_exception(future: Future, exc: BaseException) -> bool:
    """Fail `future` with `exc` unless already resolved/cancelled.
    Returns True iff this call delivered the exception."""
    if future.done():
        return False
    try:
        future.set_exception(exc)
        return True
    except InvalidStateError:
        return False
