"""Parallel task fan-out helpers (the port's copy of
``collect_in_parallel`` and ``config_overlay_from_sets`` from
oryx_tpu/common/executil.py; its other helpers have no caller in the
CLI or the layers: the fleet's port-run probe comes with the fleet, and
a port process runs on the CPU when ``oryx.compute.platform = cpu`` says
so, not through a child environment).

Mirrors the reference's ExecUtils (framework/oryx-common
.../lang/ExecUtils.java:32-75): run N tasks at parallelism P, optionally on a
private pool, collecting results. Used by the ML harness to build and
evaluate hyperparameter candidates concurrently (MLUpdate.java:253-258).
"""

from __future__ import annotations

import json
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
