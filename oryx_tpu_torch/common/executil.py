"""Parallel task fan-out helpers (the port's copy of
oryx_tpu/common/executil.py; its CPU child environment has no counterpart:
a port process runs on the CPU when ``oryx.compute.platform = cpu`` says
so, not through its environment).

Mirrors the reference's ExecUtils (framework/oryx-common
.../lang/ExecUtils.java:32-75): run N tasks at parallelism P, optionally on a
private pool, collecting results. Used by the ML harness to build and
evaluate hyperparameter candidates concurrently (MLUpdate.java:253-258).
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")


def do_in_parallel(
    num_tasks: int,
    task: Callable[[int], None],
    parallelism: int | None = None,
) -> None:
    collect_in_parallel(num_tasks, task, parallelism)


def collect_in_parallel(
    num_tasks: int,
    task: Callable[[int], T],
    parallelism: int | None = None,
) -> list[T]:
    """Run task(0..num_tasks-1), at most `parallelism` at a time, returning
    results in index order. parallelism<=1 runs inline (no pool), which
    matters where concurrent builds would contend for one card — the
    harness defaults to sequential candidate builds."""
    if num_tasks <= 0:
        return []
    parallelism = min(parallelism or 1, num_tasks)
    if parallelism <= 1:
        return [task(i) for i in range(num_tasks)]
    with ThreadPoolExecutor(max_workers=parallelism) as pool:
        return list(pool.map(task, range(num_tasks)))


def map_in_parallel(items: Sequence[T], fn: Callable[[T], "T"], parallelism: int = 4) -> list:
    return collect_in_parallel(len(items), lambda i: fn(items[i]), parallelism)


class LoggingRunnable:
    """Wrap a callable so exceptions are logged, not swallowed by executor
    futures (reference LoggingCallable)."""

    def __init__(self, fn: Callable[[], None], name: str = "task"):
        self.fn = fn
        self.name = name

    def __call__(self) -> None:
        try:
            self.fn()
        except Exception:  # noqa: BLE001 - must log whatever escapes a thread
            log.exception("unexpected error in %s", self.name)
            raise


def free_port_run(n: int, host: str = "127.0.0.1", attempts: int = 50) -> int:
    """Base of a run of ``n`` consecutive free TCP ports on ``host`` —
    the shape a fleet supervisor's ``base-port + i`` layout needs. All
    ``n`` ports are held bound while probing so the run is free at the
    moment of return (the usual bind race remains: the caller must bind
    soon after)."""
    import socket

    for _ in range(attempts):
        socks: list[socket.socket] = []
        try:
            s = socket.socket()
            s.bind((host, 0))
            base = s.getsockname()[1]
            socks.append(s)
            for i in range(1, n):
                si = socket.socket()
                si.bind((host, base + i))
                socks.append(si)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no run of {n} free ports found on {host}")


def config_overlay_from_sets(pairs) -> dict:
    """``key=value`` strings (the CLI's ``--set`` grammar) as a config
    overlay dict: values parse as JSON where possible (numbers, bools,
    lists) and fall back to raw strings — exactly how cli.py applies
    ``--set``, shared here so harnesses building a Config AND a child
    argv from one list of sets cannot drift from the CLI's coercion."""
    out: dict = {}
    for s in pairs:
        k, v = s.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out
