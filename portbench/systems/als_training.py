"""ALS training: whole builds of the port's ``train_als``, the call the
batch layer's ``ALSUpdate`` makes, back to back.

Set-up draws the interactions and the starting item factors from the
seed on the device and runs one one-sweep build, which fills the
program's list cache for these interactions and brings up the card's
libraries. The window runs whole builds, every one from the same
starting factors, and ends when the build in progress at its end ends.
Afterwards the program's state is freed and the last build's factors
are held to the plain reference's sweeps (``portbench/reference/als.py``)
from the same interactions and starting factors.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager

import numpy as np

from portbench import gen
from portbench.reference import als as als_ref
from portbench.systems import Outcome

# program functions whose calls name the host's time in a traced window
TRACED_CALLS = ("_upload_buckets", "_half_step", "_finish_model", "gram")


@contextmanager
def host_spans(module, names, spans: list):
    """Wrap ``module``'s functions ``names`` so that each call appends
    (name, start_ns, end_ns) to ``spans``; restored on leaving."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*a, **kw):
            t0 = time.monotonic_ns()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((name, t0, time.monotonic_ns()))
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def kept_counts(entity: np.ndarray, n: int, cap: int) -> int:
    """Interactions a side's lists keep: each row's, at most ``cap``."""
    return int(np.minimum(np.bincount(entity, minlength=n), cap).sum())


def run(spec) -> Outcome:
    import torch

    from oryx_tpu_torch.ops import als as program_als
    from oryx_tpu_torch.ops.als import InteractionData, train_als

    from portbench.trace import DeviceTrace

    cfg, traffic, seed, device = spec.cell.config, spec.cell.traffic, spec.seed, spec.device
    n_u, n_i, f = cfg["users"], cfg["items"], cfg["features"]
    sweeps = int(traffic["sweeps_per_build"])
    if not cfg["implicit"]:
        raise ValueError("the plain reference (reference/als.py) covers implicit ALS only")
    setup = spec.setup
    with setup.piece("interactions"):
        users, items, values = gen.interactions(seed, n_u, n_i, cfg["interactions"],
                                                cfg["generator"], device)
        y0 = gen.initial_y(seed, n_i, f, device)
    with setup.piece("ids"):
        data = InteractionData([f"u{j}" for j in range(n_u)], [f"i{j}" for j in range(n_i)],
                               users, items, values)
    kw = dict(features=f, lam=cfg["lambda"], alpha=cfg["alpha"], implicit=cfg["implicit"],
              cap=cfg["cap"], block=cfg["block"], compute_dtype=cfg["compute_dtype"],
              resume_y=y0, device=device)
    with setup.piece("first_build"):
        first: dict = {}
        train_als(data, iterations=1, timings=first, **kw)
    setup.close()

    spans: list = []
    builds = 0
    with DeviceTrace(torch, spec.trace) as tr, \
            host_spans(program_als, TRACED_CALLS if spec.trace else (), spans):
        t0 = time.monotonic()
        while True:
            b0 = time.monotonic_ns()
            out = train_als(data, iterations=sweeps, **kw)
            spans.append(("train_als", b0, time.monotonic_ns()))
            builds += 1
            if time.monotonic() - t0 >= spec.seconds:
                break
        window = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    x, y = out.x, out.y
    del data, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.monotonic()
    x_ref, y_ref = als_ref.train(users, items, values, n_u, n_i, y0, lam=cfg["lambda"],
                                 alpha=cfg["alpha"], sweeps=sweeps, cap=cfg["cap"],
                                 device=device)
    checks = als_ref.judge(x, y, x_ref, y_ref)
    check_s = time.monotonic() - t_check
    return Outcome(
        end_to_end={
            "als_sweep_ms": window / (builds * sweeps) * 1e3,
            "peak_mem_gib": peak / 2 ** 30,
        },
        attempted=builds, failed=0, memory_peak_bytes=peak, checks=checks,
        trace=tr if spec.trace else None, spans=spans,
        counters={
            "window_s": window, "builds": builds, "sweeps": builds * sweeps,
            "prepare_s": first["lists_s"], "users": n_u, "items": n_i, "features": f,
            "kept_u": kept_counts(users, n_u, cfg["cap"]),
            "kept_i": kept_counts(items, n_i, cfg["cap"]),
            "check_s": check_s,
        },
    )
