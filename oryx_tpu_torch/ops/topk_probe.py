"""Measure the partial top-k kernel on the card: where its time goes, and
how two versions of its source compare.

    python3 -m oryx_tpu_torch.ops.topk_probe ablate
    python3 -m oryx_tpu_torch.ops.topk_probe ab --parent OLD_topk_dot.cu

``ablate`` builds csrc/topk_dot.cu with one of its ``ORYX_PROBE_NO_*``
switches set at a time and times each build: without the dot (the wgmma
products; the TMA loads still stream, and every score is then 0, so little
is selected), without the selection (no compares: the loop, the loads and
the products alone), without the insertion (the candidates are found but
neither appended nor flushed). ``ab`` builds a parent source
and the checkout's, times them in turns (parent, change, change, parent)
and reports whether the top-k merged from their partials is identical. A
parent whose library has no ``oryx_topk_abi`` symbol (csrc/topk_dot.cu as
of its first version: no row pitch, 32 rows and 128-item tiles per block)
is fed a dense copy of the same item values; the checkout's build gets the
pitched view. Both time ``topk_dot_partial`` alone (median of 15 launches,
CUDA events), each build with its own one-wave split plan, and print one
JSON line per shape and type. Builds go through ops/_build.py.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import topk as T
from oryx_tpu_torch.ops.transfer import to_pitched

VARIANTS = {
    "base": (), "no_dot": ("ORYX_PROBE_NO_DOT=1",),
    "no_select": ("ORYX_PROBE_NO_SELECT=1",),
    "no_insert": ("ORYX_PROBE_NO_INSERT=1",),
}

# (name, B, I, F, k): the serving-path shapes of chip_smoke.py's CASES
SHAPES = (("serving", 512, 1_000_000, 50, 32),
          ("queued-batch", 2047, 1_000_000, 50, 32),
          ("large-batch", 4096, 1_000_000, 50, 32),
          ("batch-64", 64, 1_000_000, 50, 32),
          ("wide", 64, 1_000_000, 250, 128),
          ("single-row", 1, 1_000_000, 50, 10))

LEGACY_GEOMETRY = (32, 128)  # rows per block, items per tile, every type


def _inputs(torch, gen, b, n, f, type_name):
    y32 = torch.randn(n, f, generator=gen, device="cuda")
    xs32 = torch.randn(b, f, generator=gen, device="cuda")
    if type_name == "int8":
        y, scales = T.quantize_queries(y32)
        return T.quantize_queries(xs32)[0], to_pitched(y), scales
    dtype = getattr(torch, type_name)
    return xs32.to(dtype), to_pitched(y32.to(dtype)), None


def _is_legacy(lib) -> bool:
    try:
        lib.oryx_topk_abi
    except AttributeError:
        return True
    return False


def _legacy_launch(torch, lib, xs, y, scales, kb, n_splits, split_len):
    """The first version's partial entry points: contiguous y, no pitch."""
    p, i = ctypes.c_void_p, ctypes.c_int
    name = T._PARTIAL_ENTRY[y.dtype]
    fn = getattr(lib, name)
    fn.argtypes = [p, p] + ([p] if scales is not None else []) + [p, p] + [i] * 6 + [p]
    fn.restype = i
    part_v = torch.empty((n_splits, xs.shape[0], kb), dtype=torch.float32,
                         device=y.device)
    part_i = torch.empty_like(part_v, dtype=torch.int32)
    ptrs = [xs.data_ptr(), y.data_ptr()] + (
        [scales.data_ptr()] if scales is not None else [])
    rc = fn(*ptrs, part_v.data_ptr(), part_i.data_ptr(), xs.shape[0],
            y.shape[0], xs.shape[1], kb, n_splits, split_len,
            torch.cuda.current_stream().cuda_stream)
    T._check(rc, "legacy topk_dot_partial launch")
    return part_v, part_i


def time_partial(torch, lib, xs, y, scales, k, reps=15):
    """(median ms, final values, final indices) of one build's partial
    kernel on these inputs, launched with its own one-wave split plan; the
    final top-k is the plain merge of its partials."""
    kb = T._next_pow2(k)
    legacy = _is_legacy(lib)
    if legacy:
        lib.oryx_topk_partial_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.oryx_topk_partial_blocks_per_sm.restype = ctypes.c_int
        y = y.contiguous()
        rows, tile = LEGACY_GEOMETRY
    else:
        T.bind(lib)
        rows, tile = T.block_geometry(y.dtype)
    per_sm = lib.oryx_topk_partial_blocks_per_sm(
        xs.shape[1], kb, y.element_size())
    if per_sm <= 0:
        raise RuntimeError(f"occupancy query gave {per_sm}")
    sm = torch.cuda.get_device_properties(y.device).multi_processor_count
    n_splits, split_len = T.plan_splits(xs.shape[0], y.shape[0], sm, per_sm,
                                        rows, tile)

    def launch():
        if legacy:
            return _legacy_launch(torch, lib, xs, y, scales, kb, n_splits,
                                  split_len)
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
    for name, b, n, f, k in SHAPES:
        for type_name in types:
            xs, y, scales = _inputs(torch, gen, b, n, f, type_name)
            line = {"shape": name, "type": type_name, "B": b, "I": n, "F": f,
                    "k": k, "device": torch.cuda.get_device_name(0)}
            outs = {}
            for label in order:
                ms, v, ix = time_partial(torch, libs[label], xs, y, scales, k)
                line.setdefault(f"{label}_ms", []).append(ms)
                outs[label] = (v, ix)
            if args.cmd == "ab":
                line["identical_topk"] = all(
                    torch.equal(a, c)
                    for a, c in zip(outs["parent"], outs["change"]))
                pv, pix = outs["parent"]
                cv, cix = outs["change"]
                line["max_abs_diff"] = (pv - cv).abs().max().item()
                line["index_mismatches"] = int((pix != cix).sum().item())
            print(json.dumps(line), flush=True)
            del xs, y, scales
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
