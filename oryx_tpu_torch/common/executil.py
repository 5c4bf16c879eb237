"""Parallel task fan-out (the port's copy of ``collect_in_parallel`` from
oryx_tpu/common/executil.py; its fleet and CLI helpers come with the
subcommands that use them, ROADMAP queue 1 item 10).

Mirrors the reference's ExecUtils (framework/oryx-common
.../lang/ExecUtils.java:32-75): run N tasks at parallelism P, optionally on a
private pool, collecting results. Used by the ML harness to build and
evaluate hyperparameter candidates concurrently (MLUpdate.java:253-258).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, TypeVar

T = TypeVar("T")


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

