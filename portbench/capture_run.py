"""Run one cell as ``portbench.run`` does, and in a ``--trace 1`` run read
the device's idle time by the program's own host timeline:

    python3 -m portbench.capture_run --workload <cell> --seed <n> --seconds <s> --trace 1

The arguments, exit codes and result line are ``portbench.run``'s. This
module patches, at run time and without an edit to the manifest or the
system modules (``portbench/systems/``), the system's ``DeviceTrace`` and
the harness's ``resolve`` and ``system_module``. It stands in until the
driver opens the capture itself; then it goes.

In every run it reads the batcher's always-on ``seconds_by_piece`` as the
window opens and closes, and adds to the system's counters
``dispatcher_seconds`` (by piece over the window) and the floats
``dispatcher_<piece>_s`` and ``dispatcher_host_ms`` (stage + issue +
distribute a dispatch), which the result line's ``counters`` shows. In a
``--trace 1`` run it also:

- opens the program's ``Tracer.capture()`` around the measured window,
  once the system's ``DeviceTrace`` has opened;
- moves the device trace's operations later by the marker kernel's
  launch-to-start latency (the start of the marker's launch call, the
  CUDA runtime event of the same correlation, against the kernel's own
  start): ``DeviceTrace`` puts the marker kernel's start at the host's
  reading taken before its launch, so without this every device interval
  sits early on the host's clock by that latency
  (``marker_launch_latency_us``, in the counters);
- adds to the counters ``program_spans`` (every span the capture kept, as
  (name, start_ns, end_ns) on ``time.monotonic``) and
  ``dispatcher_host_ms_spans`` (``dispatcher.host_ms`` summed from the
  captured ``batcher.*`` spans that ended in the window, for the two to be
  held to each other);
- reads the per-layer metrics of ``EXTRA`` beside the cell's own, and
  names the breakdown's idle gaps over the whole window, the program's
  collections of every generation first.
"""

from __future__ import annotations

import os
import sys
import time

from portbench import harness
from portbench import run as base
from portbench import trace as trace_mod
from portbench.systems import span_ns

# The per-layer metrics the capture feeds, with their units
EXTRA = (
    ("idle.dispatch_host_share", "%"),
    ("idle.sync_share", "%"),
    ("idle.empty_queue_share", "%"),
    ("idle.gc_share", "%"),
    ("dispatcher.host_ms", "ms"),
)
# The dispatcher's pieces that dispatcher.host_ms counts
HOST = ("stage", "issue", "distribute")
HOST_SPANS = tuple(f"batcher.{p}" for p in HOST)


class _Window:
    capture = None      # the open Tracer.capture() context manager
    spans = None        # its Capture once closed
    batcher = None
    pieces0: dict = {}
    pieces1: dict = {}
    t0 = t1 = 0.0  # when pieces0 and pieces1 were read
    latency_ns = None  # the marker kernel's launch-to-start latency

    @classmethod
    def reset(cls) -> None:
        cls.capture = cls.spans = cls.batcher = cls.latency_ns = None
        cls.pieces0, cls.pieces1 = {}, {}
        cls.t0 = cls.t1 = 0.0


def marker_latency_ns(events) -> int | None:
    """The first marker kernel's start less the start of its launch call
    (the host event of the same correlation), on the profiler's clock;
    None where the trace lacks either."""
    kernel = next((e for e in events if not str(e.device_type()).endswith("CPU")
                   and trace_mod.MARKER in e.name()), None)
    if kernel is None:
        return None
    corr = kernel.correlation_id()
    launch = next((e for e in events if str(e.device_type()).endswith("CPU")
                   and e.correlation_id() == corr), None)
    return None if launch is None else kernel.start_ns() - launch.start_ns()


class CapturedTrace(trace_mod.DeviceTrace):
    """The system's device trace, with the program's span capture inside it
    and the dispatcher's seconds read at its edges."""

    def __enter__(self):
        out = super().__enter__()
        from oryx_tpu_torch.serving.batcher import TopKBatcher

        _Window.batcher = TopKBatcher.shared()
        if self.enabled:
            from oryx_tpu_torch.common.tracing import get_tracer

            _Window.capture = get_tracer().capture()
            _Window.spans = _Window.capture.__enter__()
        _Window.pieces0 = dict(_Window.batcher.seconds_by_piece)
        _Window.t0 = time.monotonic()
        return out

    def __exit__(self, *exc):
        _Window.pieces1 = dict(_Window.batcher.seconds_by_piece)
        _Window.t1 = time.monotonic()
        try:
            out = super().__exit__(*exc)
        finally:
            if _Window.capture is not None:
                _Window.capture.__exit__(*exc)
        prof = getattr(self, "_prof", None)
        if self.enabled and prof is not None:
            _Window.latency_ns = marker_latency_ns(prof.profiler.kineto_results.events())
            if _Window.latency_ns is not None:
                lat = _Window.latency_ns
                self.ops = [(n, k, s + lat, t + lat) for n, k, s, t in self.ops]
        return out


def _with_capture(run):
    def wrapped(spec):
        out = run(spec)
        d = out.counters.get("dispatches")
        if _Window.pieces1:
            pieces = {p: _Window.pieces1[p] - _Window.pieces0.get(p, 0.0)
                      for p in _Window.pieces1}
            out.counters["dispatcher_seconds"] = pieces
            out.counters.update({f"dispatcher_{p}_s": v for p, v in pieces.items()})
            host = sum(pieces.get(p, 0.0) for p in HOST)
            out.counters["dispatcher_host_ms"] = host / d * 1e3 if d else 0.0
        cap = _Window.spans
        if cap is not None:
            spans = [(s.name, span_ns(s.start), span_ns(s.end)) for s in cap.spans]
            out.counters["program_spans"] = spans
            host = sum(s.end - s.start for s in cap.spans
                       if s.name in HOST_SPANS and _Window.t0 < s.end <= _Window.t1)
            out.counters["dispatcher_host_ms_spans"] = host / d * 1e3 if d else 0.0
            out.spans = [s for s in spans if s[0] == "runtime.gc"] + list(out.spans)
        if _Window.latency_ns is not None:
            out.counters["marker_launch_latency_us"] = _Window.latency_ns / 1e3
        return out
    return wrapped


def install():
    """Patch ``portbench.trace`` and ``portbench.harness`` in this process;
    returns the function that undoes it."""
    _Window.reset()
    device_trace = trace_mod.DeviceTrace
    system_module, resolve = harness.system_module, harness.resolve
    trace_mod.DeviceTrace = CapturedTrace

    def captured_system(name, root=harness.ROOT):
        mod = system_module(name, root)
        mod.run = _with_capture(mod.run)
        return mod

    def with_extra(manifest, workload, root=harness.ROOT):
        cell = resolve(manifest, workload, root)
        have = {m["name"] for m in cell.per_layer}
        cell.per_layer += [{"name": n, "unit": u} for n, u in EXTRA if n not in have]
        return cell

    harness.system_module = captured_system
    harness.resolve = with_extra

    def restore() -> None:
        trace_mod.DeviceTrace = device_trace
        harness.system_module, harness.resolve = system_module, resolve

    return restore


if __name__ == "__main__":
    install()
    try:
        code = base.main()
    except Exception:  # noqa: BLE001 - any failure ends the run without a result
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
