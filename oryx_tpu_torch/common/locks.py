"""Concurrency primitives: context-managed read/write locks and rate-limited
checks.

Mirrors the reference's AutoReadWriteLock/AutoLock try-with-resources
discipline (framework/oryx-common .../lang/AutoReadWriteLock.java) and
RateLimitCheck (hot-path log throttling, used at
ALSSpeedModelManager.java:64,96-98). Serving models use the read/write lock
to guard factor-store mutation against concurrent request scans.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class AutoReadWriteLock:
    """Writer-preference read/write lock with `with lock.read():` /
    `with lock.write():` usage."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield self
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
                self._writer = True
            finally:
                # Decrement on all exits: an exception while waiting must not
                # leave readers blocked on a phantom waiting writer.
                self._writers_waiting -= 1
                if not self._writer:
                    self._cond.notify_all()
        try:
            yield self
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class RateLimitCheck:
    """True at most once per period; callers gate log statements on it."""

    def __init__(self, period_sec: float = 60.0):
        self.period = period_sec
        self._next = 0.0
        self._lock = threading.Lock()

    def test(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if now >= self._next:
                self._next = now + self.period
                return True
            return False
