"""Measure the partial top-k kernel on the card: where its time goes, and
how two versions of its source compare.

    python3 -m oryx_tpu_torch.ops.topk_probe ablate
    python3 -m oryx_tpu_torch.ops.topk_probe ab --parent OLD_topk_dot.cu

``ablate`` builds csrc/topk_dot.cu with one of its ``ORYX_PROBE_NO_*``
switches set at a time and times each build: without the dot (loads of Y
and MMAs; every score is then 0, so little is selected), without the
selection (the compiler then drops the dot too, so that build measures the
loop, the query staging and the barriers alone), without the insertion
(every score stays a candidate, so that build is slower). ``ab`` builds a
parent source and the checkout's, times them in turns (parent, change,
change, parent) and reports whether the top-k merged from their partials
is bit-identical. Both time ``topk_dot_partial`` alone (median of 15
launches, CUDA events), each build with its own one-wave split plan, and
print one JSON line per shape. Builds go through ops/_build.py.
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import topk as T

VARIANTS = {
    "base": (), "no_dot": ("ORYX_PROBE_NO_DOT=1",),
    "no_select": ("ORYX_PROBE_NO_SELECT=1",),
    "no_insert": ("ORYX_PROBE_NO_INSERT=1",),
}

SHAPES = ((512, 1_000_000, 50, 32), (4096, 1_000_000, 50, 32),
          (64, 1_000_000, 250, 128), (1, 1_000_000, 50, 10))


def _inputs(torch, gen, b, n, f, type_name):
    y32 = torch.randn(n, f, generator=gen, device="cuda")
    xs32 = torch.randn(b, f, generator=gen, device="cuda")
    if type_name == "int8":
        y, scales = T.quantize_queries(y32)
        return T.quantize_queries(xs32)[0], y, scales
    dtype = getattr(torch, type_name)
    return xs32.to(dtype), y32.to(dtype), None


def time_partial(torch, lib, xs, y, scales, k, reps=15):
    """(median ms, final values, final indices) of one build's partial
    kernel on these inputs, launched with its own one-wave split plan; the
    final top-k is the plain merge of its partials."""
    kb = T._next_pow2(k)
    per_sm = lib.oryx_topk_partial_blocks_per_sm(
        xs.shape[1], kb, y.element_size())
    if per_sm <= 0:
        raise RuntimeError(f"occupancy query gave {per_sm}")
    sm = torch.cuda.get_device_properties(y.device).multi_processor_count
    n_splits, split_len = T.plan_splits(xs.shape[0], y.shape[0], sm, per_sm)

    def launch():
        return T.topk_dot_partial(xs, y, kb=kb, n_splits=n_splits,
                                  split_len=split_len, scales=scales, lib=lib)

    for _ in range(3):
        launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pv, pi = launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return (statistics.median(times),) + T.topk_merge_reference(pv, pi, k=k)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ablate")
    ab = sub.add_parser("ab")
    ab.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("topk_probe needs a CUDA card")
    if args.cmd == "ablate":
        builds = {label: ("topk_dot", macros, None)
                  for label, macros in VARIANTS.items()}
        order = list(VARIANTS)
        types = ("bfloat16", "int8")
    else:
        builds = {"parent": ("topk_dot", (), args.parent.resolve()),
                  "change": ("topk_dot", (), None)}
        order = ["parent", "change", "change", "parent"]
        types = ("float32", "bfloat16", "int8")
    _build.build_all(variants=builds)
    libs = {label: _build.load(*spec) for label, spec in builds.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, n, f, k in SHAPES:
        for type_name in types:
            xs, y, scales = _inputs(torch, gen, b, n, f, type_name)
            line = {"type": type_name, "B": b, "I": n, "F": f, "k": k,
                    "device": torch.cuda.get_device_name(0)}
            outs = {}
            for label in order:
                ms, v, ix = time_partial(torch, libs[label], xs, y, scales, k)
                line.setdefault(f"{label}_ms", []).append(ms)
                outs[label] = (v, ix)
            if args.cmd == "ab":
                line["identical_topk"] = all(
                    torch.equal(a, c)
                    for a, c in zip(outs["parent"], outs["change"]))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
