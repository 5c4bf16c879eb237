"""Run one cell of the benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
device trace of the window. The last line of standard output is the
result, one JSON object; the numbers the check compared, each beside its
limit, end standard error and the result.

Exit codes: 0 a result was printed; 2 bad arguments or an unknown cell;
3 no CUDA device, or fewer than the cell asks for; 4 a forbidden module
(the JAX package, or JAX itself) was loaded; 1 anything else.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"


def process_start() -> float:
    """This process's start on the monotonic clock (Linux: /proc), else the
    moment this module was imported."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        boot_s = ticks / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - boot_s
        if 0.0 <= age < 600.0:
            return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        pass
    return T_IMPORT


def cache_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def number(v: float) -> float | str:
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))

    from portbench import harness
    from portbench.systems import RunSpec, Setup

    try:
        cell = harness.resolve(harness.load_manifest(ROOT), args.workload, ROOT)
    except (KeyError, OSError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    setup = Setup(t_start)
    system = harness.system_module(cell.config["system"], ROOT)
    out = system.run(RunSpec(cell, args.seed, args.seconds, bool(args.trace), device, setup))

    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4

    limits = cell.config["limits"]
    checks = {k: {"value": number(out.checks.get(k, float("inf"))), "limit": lim}
              for k, lim in limits.items()}
    correct = all(isinstance(c["value"], float) and c["value"] <= c["limit"]
                  for c in checks.values())
    e2e = dict(out.end_to_end, setup_s=setup.seconds)
    peaks = harness.load_file_module(ROOT / "portbench" / "peaks.py", "portbench_peaks").PEAKS
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed}
    if args.trace:
        ctx = harness.Context(cell, out.counters, e2e, out.trace, peaks, ROOT)
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"], ROOT).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=out.trace.busy_s(), window_s=out.trace.window_s)
        breakdown = {"device_ops": out.trace.device_ops(), "idle_gaps": out.trace.idle_gaps(out.spans)}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result.update(metrics=metrics, device=device_info)
    if args.trace:
        result["breakdown"] = breakdown
    result["setup_pieces_s"] = setup.pieces
    result["counters"] = {k: v for k, v in out.counters.items() if isinstance(v, (int, float))}
    result["power"] = power_limit()
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - any failure ends the run without a result
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # the program's server threads, if any, need no join
