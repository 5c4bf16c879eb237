"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with the
device's activity only, read back as intervals.

``DeviceTrace`` wraps the measured window. On leaving it holds every
device operation (kernels, copies, sets) as (name, start, end) on the
host's monotonic clock, aligned by a marker kernel launched as the trace
opens. From them: ``busy_s`` (the union of the operations' intervals),
``window_s``, device seconds and counts by name, the ten longest
operations by total time and the ten longest idle gaps, each named by
what the host was doing then according to spans the caller supplies.
"""

from __future__ import annotations

import time
from collections import defaultdict

MARKER = "spin_kernel"  # in the name of torch.cuda._sleep's kernel, launched to align clocks


class DeviceTrace:
    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.ops: list[tuple[str, str, int, int]] = []  # (name, kind, start, end) ns
        self.t0 = self.t1 = 0

    def __enter__(self):
        if not self.enabled:
            return self
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._unix_minus_mono = time.time_ns() - time.monotonic_ns()
        self._mark_host = time.monotonic_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self.torch.cuda.synchronize()
        self.t1 = time.monotonic_ns()
        self._prof.__exit__(*exc)
        events = self._prof.profiler.kineto_results.events()
        raw = []
        offset = None
        for e in events:
            if str(e.device_type()).endswith("CPU"):
                continue
            name = e.name()
            start = e.start_ns()
            if MARKER in name and offset is None:
                offset = start - self._mark_host
                continue
            raw.append((name, _kind(name), start, start + e.duration_ns()))
        if offset is None:  # no marker seen: the trace's clock is the epoch's
            offset = self._unix_minus_mono
        self.ops = sorted((n, k, s - offset, t - offset) for n, k, s, t in raw)
        return False

    # -- readings -----------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for _, _, s, t in sorted(self.ops, key=lambda o: o[2]):
            s, t = max(s, self.t0), min(t, self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(a, b) for a, b in out]

    def seconds_by_name(self, kernels_only: bool = False) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for name, kind, s, t in self.ops:
            if kernels_only and kind != "kernel":
                continue
            out[name] += (t - s) / 1e9
        return dict(out)

    def count(self, kernels_only: bool = True) -> int:
        return sum(1 for _, kind, _, _ in self.ops if kind == "kernel" or not kernels_only)

    def seconds_matching(self, words) -> float:
        """Device seconds of the kernels whose name holds any of ``words``."""
        return sum((t - s) / 1e9 for name, kind, s, t in self.ops
                   if kind == "kernel" and any(w in name for w in words))

    def device_ops(self, n: int = 10) -> list:
        top = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v] for k, v in top]

    def idle_gaps(self, spans, n: int = 10) -> list:
        """The ``n`` longest idle gaps in the window, each named by the
        first host span ((name, start_ns, end_ns) on the monotonic clock)
        that covers at least half of it, else by the one that covers most
        of it, or ``host: no span``. Callers put the spans that explain a
        gap (a collection that stops every thread) before those it falls
        inside."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
                if edges[j + 1] > edges[j]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            best, cover = "host: no span", 0
            for name, s, t in spans:
                c = min(b, t) - max(a, s)
                if 2 * c >= b - a:
                    best = f"host: {name}"
                    break
                if c > cover:
                    best, cover = f"host: {name}", c
            out.append([best, (b - a) / 1e9])
        return out


def _kind(name: str) -> str:
    low = name.lower()
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    return "kernel"


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n]
