"""Timing of kernel calls on the card, for chip_smoke.py and ops/topk_probe.py.

``device_ms`` times the card's work alone: launches queued behind a
spinning kernel, each between two CUDA events. ``wall_ms`` times one call as
a lone dispatch pays for it: from the host issuing it on an idle card to its
work being done, the host's launch overhead included. Neither is used on the
serving path.
"""

from __future__ import annotations

import statistics
import time

SLEEP_CYCLES = 40_000_000  # about 20 ms of the card's clock
TRIES = 3  # device_ms doubles the spin this many times at most


def device_ms(torch, fn, reps: int = 15, warmup: int = 3):
    """(median device ms of reps calls of fn, fn's last result, queued).

    The card first spins while the calls, each between two CUDA events,
    queue up behind it, so an event pair times the call's device work and
    not the host's time to issue it (which exceeds the device time of a
    kernel of a few microseconds). ``queued`` says whether that held: each
    call's last launch was issued while the card was still busy with the
    work before it. Where a call was issued to an idle card, the reading
    is taken again behind a spin twice as long, up to TRIES times, and
    ``queued`` is False if none held."""
    for _ in range(warmup):
        fn()
    cycles = SLEEP_CYCLES
    for _ in range(TRIES):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        prev = torch.cuda.Event()
        prev.record()
        pairs, out, queued = [], None, True
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            # done already: the card ran dry before this call was issued
            queued = queued and not prev.query()
            end.record()
            pairs.append((start, end))
            prev = end
        pairs[-1][1].synchronize()
        if queued:
            break
        cycles *= 2
    return statistics.median(s.elapsed_time(e) for s, e in pairs), out, queued


def wall_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Median host-inclusive ms of one call of fn on an idle card: the
    host's clock from issuing it to the card finishing its work."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
