"""Measure the top-k kernels on the card: where the partial kernel's time
goes, and how two versions of their source compare.

    python3 -m oryx_tpu_torch.ops.topk_probe ablate
    python3 -m oryx_tpu_torch.ops.topk_probe ab --parent OLD_topk_dot.cu

``ablate`` builds csrc/topk_dot.cu with one of its ``ORYX_PROBE_NO_*``
switches set at a time and times each build's partial kernel for every
type: without the dot (the wgmma products, or the f32 FMA loop; the TMA
loads still stream, and every score is then 0, so little is selected),
without the selection (no compares: the loop, the loads and the products
alone), without the insertion (the candidates are found but neither
appended nor flushed). ``ab`` builds a parent source and the checkout's and
times them in turns (parent, change, change, parent): the partial kernel,
each build with its own one-wave split plan, with whether the top-k merged
from their partials is identical; then the merge kernel of each build on
the same partials (the change's), with whether their outputs are identical
and equal to the plain merge's. A parent whose library reports
``oryx_topk_abi() < 3`` (csrc/topk_dot.cu before the f32 redesign) takes no
query pitch and tiles f32 items 128 at a time for 32 rows. Times are
device times, medians of 15 launches (ops/timing.py ``device_ms``; a
line's ``queued`` is false where a reading may hold the host's time to
issue a launch); one JSON line per shape and type.
Builds go through ops/_build.py.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import topk as T
from oryx_tpu_torch.ops.timing import device_ms
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

ABI2_F32_GEOMETRY = (32, 128)  # rows per block, items per tile


def _inputs(torch, gen, b, n, f, type_name):
    y32 = torch.randn(n, f, generator=gen, device="cuda")
    xs32 = torch.randn(b, f, generator=gen, device="cuda")
    if type_name == "int8":
        y, scales = T.quantize_queries(y32)
        return T.quantize_queries(xs32)[0], to_pitched(y), scales
    dtype = getattr(torch, type_name)
    return xs32.to(dtype), to_pitched(y32.to(dtype)), None


def _abi2_launch(torch, lib, xs, y, scales, kb, n_splits, split_len):
    """A version-2 library's partial entry points: no query pitch."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, T._PARTIAL_ENTRY[y.dtype])
    fn.argtypes = ([p, p] + ([p] if scales is not None else []) + [p, p]
                   + [i] * 7 + [p])
    fn.restype = i
    part_v = torch.empty((n_splits, xs.shape[0], kb), dtype=torch.float32,
                         device=y.device)
    part_i = torch.empty_like(part_v, dtype=torch.int32)
    ptrs = [xs.data_ptr(), y.data_ptr()] + (
        [scales.data_ptr()] if scales is not None else [])
    rc = fn(*ptrs, part_v.data_ptr(), part_i.data_ptr(), xs.shape[0],
            y.shape[0], xs.shape[1], y.stride(0), kb, n_splits, split_len,
            torch.cuda.current_stream().cuda_stream)
    T._check(rc, "version-2 topk_dot_partial launch")
    return part_v, part_i


def time_partial(torch, lib, xs, y, scales, k):
    """(median ms, queued, partial values, partial indices, final values,
    final indices) of one build's partial kernel on these inputs, launched with
    its own one-wave split plan; the final top-k is the plain merge of its
    partials."""
    kb = T._next_pow2(k)
    old = lib.oryx_topk_abi() < 3
    T.bind(lib)
    rows, tile = (ABI2_F32_GEOMETRY if old and y.dtype == torch.float32
                  else T.block_geometry(y.dtype))
    per_sm = lib.oryx_topk_partial_blocks_per_sm(
        xs.shape[1], kb, y.element_size())
    if per_sm <= 0:
        raise RuntimeError(f"occupancy query gave {per_sm}")
    sm = torch.cuda.get_device_properties(y.device).multi_processor_count
    n_splits, split_len = T.plan_splits(xs.shape[0], y.shape[0], sm, per_sm,
                                        rows, tile)

    def launch():
        if old:
            return _abi2_launch(torch, lib, xs, y, scales, kb, n_splits,
                                split_len)
        return T.topk_dot_partial(xs, y, kb=kb, n_splits=n_splits,
                                  split_len=split_len, scales=scales, lib=lib)

    ms, (pv, pi), queued = device_ms(torch, launch)
    return (ms, queued, pv, pi) + T.topk_merge_reference(pv, pi, k=k)


def merge_ab(torch, libs, order, pv, pi, k) -> dict:
    """Each build's merge kernel on the same partials, in turns: median ms
    per turn, and whether the outputs are identical to each other and to
    the plain merge's."""
    out = {"S": pv.shape[0], "kb": pv.shape[2]}
    results, out["queued"] = {}, True
    for label in order:
        ms, res, queued = device_ms(
            torch, lambda lib=libs[label]: T.topk_merge(pv, pi, k=k, lib=lib))
        out.setdefault(f"{label}_ms", []).append(ms)
        out["queued"] = out["queued"] and queued
        results[label] = res
    ref = T.topk_merge_reference(pv, pi, k=k)
    out["identical"] = all(
        torch.equal(a, b) for res in results.values() for a, b in zip(res, ref))
    return out


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
    else:
        builds = {"parent": ("topk_dot", (), args.parent.resolve()),
                  "change": ("topk_dot", (), None)}
        order = ["parent", "change", "change", "parent"]
    _build.build_all(variants=builds)
    libs = {label: _build.load(*spec) for label, spec in builds.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    device = torch.cuda.get_device_name(0)
    for name, b, n, f, k in SHAPES:
        for type_name in ("float32", "bfloat16", "int8"):
            xs, y, scales = _inputs(torch, gen, b, n, f, type_name)
            line = {"shape": name, "type": type_name, "B": b, "I": n, "F": f,
                    "k": k, "device": device}
            outs, line["queued"] = {}, True
            for label in order:
                ms, queued, pv, pi, v, ix = time_partial(
                    torch, libs[label], xs, y, scales, k)
                line.setdefault(f"{label}_ms", []).append(ms)
                line["queued"] = line["queued"] and queued
                outs[label] = (pv, pi, v, ix)
            if args.cmd == "ab":
                _, _, par_v, par_i = outs["parent"]
                pv, pi, cv, cix = outs["change"]
                line["identical_topk"] = (torch.equal(par_v, cv)
                                          and torch.equal(par_i, cix))
                line["max_abs_diff"] = (par_v - cv).abs().max().item()
                line["index_mismatches"] = int((par_i != cix).sum().item())
                # the merge of each build on the change's partials
                line["merge"] = merge_ab(torch, libs, order, pv, pi, k)
            print(json.dumps(line), flush=True)
            del xs, y, scales, outs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
