#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (oryx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. environment: the card, its power limit, and the build of every CUDA
   kernel from the sources in this checkout (one nvcc per source, together);
2. kernels: each hand-written kernel held against its plain PyTorch version
   on the card at the serving shapes and at the edge cases, with its time
   (device time by CUDA events, median of 20 launches after warm-up,
   queued behind a spinning kernel; and beside it the host-inclusive time
   of one call on an idle card, ops/timing.py), the plain version's, one
   library call's (torch.matmul + torch.topk; for the
   merge, torch.topk of the union of the partial lists; timed only, at 100k
   items or more) and the least time the card could take (H100 SXM data
   sheet peaks);
3. serving (the main path): a synthetic ALS model of 1M items x 50 features
   and 100k users, written as a model artifact and loaded by
   ALSServingModelManager from a MODEL-REF message, answers 2,048 concurrent
   top_n_async requests in each of score-mode exact and quantized. Kernel
   launch counts are zeroed just before and read just after. Recall@10 is
   held against an exact float64 ranking; then 100 UP messages, one of which
   plants a new best item for a probed user, go through the delta resync
   (scatter_rows on the card) and the new item must be served. The served
   item views must be pitched (ops/transfer.py). After the timed burst of
   score-mode exact, one more burst of the same requests, untimed, runs
   under torch.profiler; its device time by kernel and the share of the
   burst's wall time the card was busy go into the serving line;
4. http (the main path as users reach it): in each score mode the port's
   ServingLayer starts from config (mem:// topics created first, the
   default async frontend on an ephemeral port, the classes and resources
   of apps/spi.py's "als" overlay), its update listener loads the same
   artifact from a MODEL-REF published on the update topic, and once GET
   /ready answers 200 a load generator in separate processes (HTTP/1.1
   keep-alive connections, CLIENT_PROCS x CLIENT_CONNS) sends 2,048 GET
   /recommend/u{j}?howMany=10 for the in-process phase's users. Every
   answer must be 200; recall@10 is held against the same float64
   ranking; kernel launches must equal the batcher's dispatches. In
   score-mode exact one more burst, untimed, runs with the card traced by
   torch.profiler (device time, busy share). Then POST
   /pref must reach the input topic, and an UP row on the update topic
   planting a new best item must come back from /recommend over HTTP;
5. train (the batch layer's trainer, no hand kernel on its path): the port's
   build_and_evaluate at the bench's north star (162,000 x 59,000 x 25M
   synthetic interactions, ml/synth.py seed 7, 50 features, 10 sweeps,
   lambda 0.01, alpha 1, bf16 inputs to f32 products, 2% held out): its
   stages' times, FLOP rate and its share of the bf16 and of the f32 peak,
   held-out AUC (>= 0.87), NaN rows
   (none) and peak card memory; then three more sweeps from the trained
   factors, outside the build's time: one by the host's clock, one with
   the card traced by torch.profiler (kernel time and launches, the card's
   busy share of the sweep), one with host ops traced as well (device
   time and calls by op: gather, bmm, cholesky_ex, solve_triangular,
   scatter, other, each beside its bound); then f32 (TF32 off) and bf16
   builds at the 1M warm-up shape (6,000 x 3,700 x 1M), same checks;
6. lambda (the loop, at the 1M shape): one file:// bus, the als app's
   classes from config. 1M events on the input topic; a full batch
   generation on the card; the serving layer started on the same topics
   (publish to /ready 200); /recommend for 64 users against the exact
   float64 top-10 of the published factors (recall@10 1.0, exact ties
   aside); the speed layer folds 20,000 new events in (64 of them for
   users and items the model never saw) on the card, every UP row held
   against the fold-in's plain version on the CPU (1e-4 relative), and the
   time from the events' write to /recommend answering for a new user;
   50,000 more events and a generation in a fresh batch layer that must
   take the incremental path (warm start from the model dir); serving
   must then serve the new generation. The fused top-k kernels' launches
   in the serving leg are counted as in phases 3 and 4.

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero; without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

SEED = 20240611
N_ITEMS, N_USERS, FEATURES = 1_000_000, 100_000, 50
N_REQUESTS, HOW_MANY, KNOWN_PER_USER = 2048, 10, 5
N_UPDATES = 100
CLIENT_PROCS, CLIENT_CONNS = 4, 16  # the http phase's load generator
MIN_RECALL = {"exact": 0.99, "quantized": 0.95}  # ml/quality.py MIN_SCORE_MODE_RECALL
FLOAT_TOL = 1e-3  # atol and rtol: bf16 products summed in another order

# H100 SXM data sheet (dense): device memory rate and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

KERNEL_SOURCE = "oryx_tpu_torch/ops/csrc/topk_dot.cu"
REPLACES = "oryx_tpu/ops/pallas_topk.py:159"  # _topk_kernel (both variants)
MERGE_REPLACES = "oryx_tpu/ops/pallas_topk.py:123"  # _merge_top

# (name, B, I, F, k, duplicated rows)
CASES = [
    ("serving", 512, 1_000_000, 50, 32, 1),
    ("large-batch", 4096, 1_000_000, 50, 32, 1),
    # a full queue's group, as the batcher now dispatches it: unpadded
    ("queued-batch", 2047, 1_000_000, 50, 32, 1),
    ("batch-64", 64, 1_000_000, 50, 32, 1),
    ("wide", 64, 1_000_000, 250, 128, 1),
    # rows of 10 chunks (bf16), more than the ring has stages
    ("wide-600", 37, 100_000, 600, 128, 1),
    ("single-row", 1, 1_000_000, 50, 10, 1),
    ("ragged", 13, 777, 33, 5, 1),
    ("fewer-items-than-k", 4, 6, 16, 10, 1),
    ("ties", 37, 50_000, 16, 25, 5),
    # every item row identical: every score ties, and the answer is the
    # lowest 128 indices
    ("all-ties", 7, 20_000, 16, 128, 20_000),
]
BIG_ITEMS = 100_000  # time the plain and library forms only at or above


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

NOT_QUEUED: list[str] = []  # device readings that may hold host time


def time_ms(torch, fn, what: str, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn over reps launches (CUDA events, queued
    behind a spinning kernel so that the host's time to issue a launch
    does not count: ops/timing.py device_ms). A reading whose launches
    were not all issued while the card was busy is named in NOT_QUEUED."""
    from oryx_tpu_torch.ops.timing import device_ms

    ms, _out, queued = device_ms(torch, fn, reps, warmup)
    if not queued:
        NOT_QUEUED.append(what)
    return ms


def queued(line: dict, **readings: str) -> dict:
    """{key: whether the reading behind line[key] was queued}"""
    return {key: what not in line["not_queued"]
            for key, what in readings.items()}


def bound(n_bytes: float, n_ops: float, type_name: str) -> tuple[float, str]:
    """(least ms, what bounds it) for n_bytes moved and n_ops done."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[type_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def agree(torch, v, i, v_ref, i_ref, true_score, type_name: str, f: int,
          whole: bool) -> dict:
    """Hold kernel output (v, i) against the plain version's. int8: bit
    equality. bf16: values within FLOAT_TOL (atol and rtol). f32: values
    within 2 f32_tolerance(f) (absolute; ops/topk.py), and a whole call's
    within f32_tolerance(f) of the float64 scores of the items it
    returned. Float: where indices
    differ, the kernel's item must truly (float64) score within the same
    tolerance of the plain version's score at that slot (a near-tie
    resolved the other way)."""
    from oryx_tpu_torch.ops.topk import f32_tolerance

    exact = type_name == "int8"
    check(v.shape == v_ref.shape and i.shape == i_ref.shape, "shapes differ")
    pad, pad_ref = torch.isinf(v), torch.isinf(v_ref)
    check(torch.equal(pad, pad_ref), "-inf padding differs")
    check(torch.equal(i[pad], i_ref[pad]), "padding indices differ")
    fin = ~pad
    err = (v[fin] - v_ref[fin]).abs().max().item() if fin.any() else 0.0
    mism = int((i != i_ref).sum().item())
    if exact:
        check(torch.equal(v, v_ref), f"int8 values differ (max {err})")
        check(mism == 0, f"int8 indices differ at {mism} slots")
        return {"max_abs_err": err, "index_mismatches": 0}
    out = {"max_abs_err": err, "index_mismatches": mism}
    if type_name == "float32":
        tol = f32_tolerance(f)
        atol, rtol = 2 * tol, 0.0
        out["tol"] = atol
        if whole and fin.any():
            rows = torch.arange(v.shape[0], device=v.device)[:, None].expand_as(v)
            true = true_score(rows[fin], i[fin])
            out["max_err_vs_f64"] = (v[fin].double() - true).abs().max().item()
            check(out["max_err_vs_f64"] <= tol,
                  f"f32 values off their float64 scores by "
                  f"{out['max_err_vs_f64']} > {tol}")
    else:
        atol = rtol = FLOAT_TOL
    torch.testing.assert_close(v, v_ref, atol=atol, rtol=rtol)
    if mism:
        where = tuple((i != i_ref).nonzero().T)  # ([split,] row, slot)
        ref = v_ref[where].double()
        gap = (true_score(where[-2], i[where]) - ref).abs()
        check(bool((gap <= atol + rtol * ref.abs()).all()),
              f"index mismatch beyond a near-tie (gap {gap.max().item()})")
    return out


def tf32_control(torch, T, xk, y, k, true_score, f) -> dict:
    """The plain whole call's values with TF32 products (the switch the
    plain version turns off) against their float64 scores: the error that
    f32_tolerance(f) must reject. Timed nowhere; the port never computes so."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err = 0.0
        for lo, hi in T._row_chunks(xk.shape[0], y.shape[0]):
            v, i = torch.topk(xk[lo:hi] @ y.T, min(k, y.shape[0]), dim=1)
            rows = torch.arange(lo, hi, device=v.device)[:, None].expand_as(v)
            err = max(err, (v.double() - true_score(rows.reshape(-1),
                                                    i.reshape(-1)).view_as(v))
                      .abs().max().item())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    tol = T.f32_tolerance(f)
    return {"max_err_vs_f64": err, "tol": tol, "rejected": err > tol}


def kernel_phase(torch, T) -> tuple[list, dict]:
    from oryx_tpu_torch.ops.timing import wall_ms
    from oryx_tpu_torch.ops.transfer import to_pitched

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lines, at_serving, at_single = [], {}, {}
    for name, b, n, f, k, dup in CASES:
        base = torch.randn((-(-n // dup), f), generator=gen, device=dev)
        y32 = base.repeat_interleave(dup, dim=0)[:n].contiguous() if dup > 1 else base
        xs32 = torch.randn((b, f), generator=gen, device=dev)
        for type_name, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16),
                                 ("int8", torch.int8)):
            quant = dtype == torch.int8
            # item views pitched as ops/transfer.py lays them out on the card
            if quant:
                y, scales = T.quantize_queries(y32)  # per-row int8 + f32 scale
                y = to_pitched(y)
                xs_in = xs32
                xk, sx = T.quantize_queries(xs32)
                yf = y.float()
            else:
                y, scales = to_pitched(y32.to(dtype)), None
                xs_in = xk = xs32.to(dtype)
                yf = y.float()
            xkf = xk.float()

            def true_score(rows, idx, _yf=yf, _xkf=xkf, _s=scales):
                """float64 scores of items idx for query rows rows"""
                out, step = [], 1 << 16
                for lo in range(0, rows.numel(), step):
                    r, j = rows[lo:lo + step], idx[lo:lo + step].long()
                    s = (_xkf[r].double() * _yf[j].double()).sum(dim=1)
                    out.append(s * _s[j].double() if _s is not None else s)
                return torch.cat(out) if out else rows.new_empty(0, dtype=torch.float64)

            kb = T._next_pow2(k)
            n_splits, split_len = T.launch_plan(b, y, kb)
            pv, pi = T.topk_dot_partial(xk, y, kb=kb, n_splits=n_splits,
                                        split_len=split_len, scales=scales)
            torch.cuda.synchronize()
            rv, ri = T.topk_dot_partial_reference(
                xk, y, kb=kb, n_splits=n_splits, split_len=split_len,
                scales=scales,
            )
            part = agree(torch, pv, pi, rv, ri, true_score, type_name, f,
                         whole=False)
            mv, mi = T.topk_merge(pv, pi, k=k)
            torch.cuda.synchronize()
            rmv, rmi = T.topk_merge_reference(pv, pi, k=k)
            check(torch.equal(mv, rmv) and torch.equal(mi, rmi),
                  f"{name}/{type_name}: merge differs from its plain version")
            fin = ~torch.isinf(rmv)
            merge_err = ((mv[fin] - rmv[fin]).abs().max().item()
                         if fin.any() else 0.0)
            v, i = T.topk_dot_batch_cuda(xs_in, y, k=k, scales=scales)
            torch.cuda.synchronize()
            vr, ir = T.topk_dot_batch_reference(xs_in, y, k=k, scales=scales)
            whole_true = (
                (lambda r, j: true_score(r, j) * sx[r].double()) if quant
                else true_score
            )
            whole = agree(torch, v, i, vr, ir, whole_true, type_name, f,
                          whole=True)
            if type_name == "float32":
                whole["tf32_control"] = tf32_control(torch, T, xk, y, k,
                                                     true_score, f)
            if dup == n:
                lowest = torch.arange(k, dtype=torch.int32, device=dev)
                check(torch.equal(i, lowest.expand(b, k)),
                      f"{name}/{type_name}: not the lowest {k} indices")

            itemsize = y.element_size()
            in_bytes = b * f * itemsize + n * f * itemsize + (4 * n if quant else 0)
            part_bytes = 8 * n_splits * b * kb
            ops = 2.0 * b * n * f
            nq0 = len(NOT_QUEUED)
            at = f"{name}/{type_name}"

            def whole_fn():
                return T.topk_dot_batch_cuda(xs_in, y, k=k, scales=scales)

            def part_fn():
                return T.topk_dot_partial(
                    xk, y, kb=kb, n_splits=n_splits, split_len=split_len,
                    scales=scales)

            def merge_fn():
                return T.topk_merge(pv, pi, k=k)

            ms = time_ms(torch, whole_fn, f"{at}/whole")
            part_ms = time_ms(torch, part_fn, f"{at}/partial")
            merge_ms = time_ms(torch, merge_fn, f"{at}/merge")
            line = {
                "phase": "kernel", "case": name, "type": type_name,
                "B": b, "I": n, "F": f, "k": k, "kb": kb,
                "splits": n_splits, "split_len": split_len,
                "partial": part, "whole": whole,
                "merge": {"max_abs_err": merge_err},
                "ms": ms, "partial_ms": part_ms, "merge_ms": merge_ms,
                "wall_ms": wall_ms(torch, whole_fn),
                "partial_wall_ms": wall_ms(torch, part_fn),
                "merge_wall_ms": wall_ms(torch, merge_fn),
            }
            line["bound_ms"], line["bound_by"] = bound(
                in_bytes + 8 * b * k, ops, type_name)
            line["partial_bound_ms"], line["partial_bound_by"] = bound(
                in_bytes + part_bytes, ops, type_name)
            # the merge needs only each list's first k entries
            line["merge_bound_ms"], line["merge_bound_by"] = bound(
                8 * n_splits * b * k + 8 * b * k, 0, type_name)
            if n >= BIG_ITEMS:
                reps = 3 if b * n > 1e9 else 5
                line["plain_ms"] = time_ms(torch, lambda: T.topk_dot_batch_reference(
                    xs_in, y, k=k, scales=scales), f"{at}/plain", reps=reps,
                    warmup=1)
                line["library_ms"] = library_ms(torch, xk, y, k, scales,
                                                f"{at}/library")
                line["library_wall_ms"] = wall_ms(
                    torch, library_call(torch, xk, y, k, scales),
                    reps=5 if b > 1000 else 15)
                # one library call computing the merge's function: the
                # top-k of the union of the partial lists
                flat = pv.permute(1, 0, 2).reshape(b, -1).contiguous()
                line["merge_library_ms"] = time_ms(
                    torch, lambda: torch.topk(flat, k, dim=1),
                    f"{at}/merge_library")
                line["merge_library_wall_ms"] = wall_ms(
                    torch, lambda: torch.topk(flat, k, dim=1))
                del flat
            if name == "serving":
                line["partial_plain_ms"] = time_ms(
                    torch, lambda: T.topk_dot_partial_reference(
                        xk, y, kb=kb, n_splits=n_splits, split_len=split_len,
                        scales=scales), f"{at}/partial_plain", reps=5,
                    warmup=1)
                line["merge_plain_ms"] = time_ms(
                    torch, lambda: T.topk_merge_reference(pv, pi, k=k),
                    f"{at}/merge_plain", reps=20, warmup=2)
                at_serving[type_name] = line
            # device readings of this line that may hold host time
            line["not_queued"] = [w.rsplit("/", 1)[1]
                                  for w in NOT_QUEUED[nq0:]]
            if name == "single-row":
                at_single[type_name] = line
            emit(line)
            lines.append(line)
            del y, pv, pi, rv, ri, yf, xkf
        del base, y32, xs32
        torch.cuda.empty_cache()
    return lines, at_serving, at_single


def library_call(torch, xk, y, k, scales):
    """torch.matmul + torch.topk over the same inputs (timed only; the port
    never calls it). The int8 form multiplies the int8 values held as bf16
    (exact) and applies the item scales before the top-k."""
    if scales is None:
        return lambda: torch.topk(torch.matmul(xk, y.T), k, dim=1)
    xb, yb = xk.to(torch.bfloat16), y.to(torch.bfloat16)
    return lambda: torch.topk(torch.matmul(xb, yb.T).float() * scales, k, dim=1)


def library_ms(torch, xk, y, k, scales, what: str):
    return time_ms(torch, library_call(torch, xk, y, k, scales), what,
                   reps=5 if xk.shape[0] > 1000 else 20)


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def write_model(np, root: Path) -> tuple[str, dict]:
    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(SEED)
    y = rng.standard_normal((N_ITEMS, FEATURES), dtype=np.float32)
    x = rng.standard_normal((N_USERS, FEATURES), dtype=np.float32)
    known_idx = rng.integers(0, N_ITEMS, size=(N_USERS, KNOWN_PER_USER))
    x_ids = [f"u{j}" for j in range(N_USERS)]
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    known = {u: [f"i{int(j)}" for j in row] for u, row in zip(x_ids, known_idx)}
    art = ModelArtifact("als", content={"knownItems": known},
                        tensors={"X": x, "Y": y})
    art.set_extension("features", str(FEATURES))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", x_ids)
    art.set_extension("YIDs", y_ids)
    path = root / "model"
    art.write(path)
    return str(path), {"x": x, "y": y, "known_idx": known_idx}


def exact_top(torch, np, model_data, users) -> list:
    """Exact float64 top-HOW_MANY item rows per user, known items excluded
    (torch.matmul in float64 on the card, independent of the kernels)."""
    y64 = torch.from_numpy(model_data["y"]).cuda().double()
    out = []
    for lo in range(0, len(users), 256):
        sel = users[lo:lo + 256]
        x64 = torch.from_numpy(model_data["x"][sel]).cuda().double()
        s = x64 @ y64.T
        known = torch.from_numpy(model_data["known_idx"][sel]).cuda()
        s.scatter_(1, known, float("-inf"))
        out.extend(torch.topk(s, HOW_MANY, dim=1).indices.cpu().numpy())
    del y64
    torch.cuda.empty_cache()
    return out


def device_profile(prof, wall_s: float) -> dict:
    """Device time by kernel from a torch.profiler trace of one burst, and
    its share of the burst's wall time."""
    by_name = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            by_name[ev.key] = (by_name.get(ev.key, 0.0)
                               + ev.self_device_time_total / 1e3)
    device_ms = sum(by_name.values())
    topk_ms = sum(v for k, v in by_name.items() if "topk" in k)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"device_ms": device_ms, "topk_kernels_ms": topk_ms,
            "device_busy_share": device_ms / (wall_s * 1e3),
            "topk_share": topk_ms / (wall_s * 1e3), "by_kernel_ms": top}


def burst(model, vecs, excl):
    """Send every request at once through top_n_async and wait for all:
    (results, send times, completion times, seconds to submit)."""
    done = [0.0] * len(vecs)
    sent = [0.0] * len(vecs)
    all_done = threading.Event()
    remaining = [len(vecs)]
    lock = threading.Lock()

    def finished(j):
        def cb(_f):
            done[j] = time.perf_counter()
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    all_done.set()
        return cb

    futs = []
    for j in range(len(vecs)):
        sent[j] = time.perf_counter()
        fut = model.top_n_async(vecs[j], HOW_MANY, exclude=excl[j])
        fut.add_done_callback(finished(j))
        futs.append(fut)
    submit_s = time.perf_counter() - sent[0]
    check(all_done.wait(300), "requests did not complete")
    return [f.result() for f in futs], sent, done, submit_s


def serve_mode(torch, np, T, mode, path, model_data, users, exact_rows) -> dict:
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.ops.transfer import is_pitched
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    t0 = time.monotonic()
    mgr = ALSServingModelManager(
        load_config(overlay={"oryx.serving.api.score-mode": mode}))
    try:
        mgr.consume_key_message("MODEL-REF", path)
        model = mgr.get_model()
        load_s = time.monotonic() - t0
        t0 = time.monotonic()
        model.top_n(model.get_user_vector("u0"), HOW_MANY)  # builds the view
        torch.cuda.synchronize()
        view_s = time.monotonic() - t0
        y_dev = model._device_view[0]
        check(y_dev.device.type == "cuda", "device view is not on the card")
        check(y_dev.shape[0] == N_ITEMS,
              f"device view holds {y_dev.shape[0]} rows for {N_ITEMS} items")
        check(str(y_dev.dtype) == ("torch.int8" if mode == "quantized"
                                   else "torch.bfloat16"),
              f"{mode} view has type {y_dev.dtype}")
        rows_dev = y_dev.q if mode == "quantized" else y_dev
        check(is_pitched(rows_dev),
              f"{mode} view is not pitched: strides {rows_dev.stride()}")

        batcher = TopKBatcher.shared()
        vecs = [model.get_user_vector(f"u{u}") for u in users]
        excl = [model.state.get_known_items(f"u{u}") for u in users]
        d0 = batcher.dispatches
        T.reset_launches()  # the main path's window opens
        results, sent, done, submit_s = burst(model, vecs, excl)
        torch.cuda.synchronize()
        launches = dict(T.LAUNCHES)  # ... and closes
        by_type = dict(T.PARTIAL_LAUNCHES_BY_TYPE)
        dispatches = batcher.dispatches - d0
        check(dispatches < len(users),
              f"no coalescing: {dispatches} dispatches for {len(users)}")
        check(launches["topk_dot_partial"] == dispatches
              and launches["topk_merge"] == dispatches,
              f"launches {launches} != dispatches {dispatches}")
        wall = max(done) - min(sent)
        traced = None
        if mode == "exact":
            # the same burst again, untimed, under the profiler (which slows
            # the host): how busy the card is while the host serves
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                _r, sent_p, done_p, _s = burst(model, vecs, excl)
                torch.cuda.synchronize()
            traced = device_profile(prof, max(done_p) - min(sent_p))
        lat = sorted((d - s) * 1e3 for d, s in zip(done, sent))

        hits = 0
        for res, want, ex in zip(results, exact_rows, excl):
            ids = [i for i, _ in res]
            check(len(ids) == HOW_MANY, "short answer")
            check(not set(ids) & ex, "a known item was served")
            hits += len(set(ids) & {f"i{int(r)}" for r in want})
        recall = hits / (HOW_MANY * len(results))
        check(recall >= MIN_RECALL[mode],
              f"{mode} recall@10 {recall} < {MIN_RECALL[mode]}")

        # delta resync: 99 moved items and one new best item for a probe
        rng = np.random.default_rng(SEED + 1)
        probe = vecs[0]
        msgs = []
        for j in rng.choice(N_ITEMS, size=N_UPDATES - 1, replace=False):
            vec = rng.standard_normal(FEATURES)
            msgs.append(json.dumps(["Y", f"i{int(j)}", [float(v) for v in vec]]))
        star = 10.0 * probe
        msgs.append(json.dumps(["Y", "i-new", [float(v) for v in star]]))
        version0 = model.served_version()
        T.reset_launches()
        d0 = batcher.dispatches
        t0 = time.monotonic()
        for m in msgs:
            mgr.consume_key_message("UP", m)
        target = model.state.y.get_version()
        served = None
        while time.monotonic() - t0 < 60:
            served = model.top_n(probe, HOW_MANY, exclude=excl[0])
            if model.served_version() == target and served[0][0] == "i-new":
                break
            time.sleep(0.01)
        sync_s = time.monotonic() - t0
        check(served[0][0] == "i-new", f"new item not served: {served[:3]}")
        check(model.last_resync["kind"] == "delta",
              f"resync was {model.last_resync}")
        check(model._device_view[0].shape[0] == N_ITEMS + 1,
              "the delta did not grow the device view by the new item")
        delta_launches = dict(T.LAUNCHES)
        delta_dispatches = batcher.dispatches - d0
        check(delta_launches["topk_dot_partial"] == delta_dispatches,
              "delta-phase launches != dispatches")
        return {
            "phase": "serving", "mode": mode, "items": N_ITEMS,
            "users": N_USERS, "features": FEATURES,
            "load_s": load_s, "view_build_s": view_s,
            "requests": len(users), "dispatches": dispatches,
            "mean_batch": len(users) / dispatches, "launches": launches,
            "partial_launches_by_type": by_type,
            "recall_at_10": recall, "qps": len(users) / wall,
            "wall_s": wall, "submit_s": submit_s,
            "first_done_ms": (min(done) - sent[0]) * 1e3,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "profile": traced,
            "delta": {
                "updates": N_UPDATES, "from_version": version0,
                "to_version": model.served_version(),
                "resync": model.last_resync, "served_after_s": sync_s,
                "dispatches": delta_dispatches, "launches": delta_launches,
            },
        }
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# phase 4: the serving path over HTTP
# ---------------------------------------------------------------------------

# One load-generator process: argv = port, connections; stdin = a count n,
# n lines "index path", then (once it has printed "ready", its connections
# open) a line "go". Prints one JSON line per request: [index, status,
# seconds sent, seconds done, ids] (time.time(), comparable across
# processes on one host).
CLIENT = r"""
import http.client, json, sys, threading, time
port, conns = int(sys.argv[1]), int(sys.argv[2])
n = int(sys.stdin.readline())
paths = [sys.stdin.readline().split(" ", 1) for _ in range(n)]
out = [None] * len(paths)
clients = [http.client.HTTPConnection("127.0.0.1", port, timeout=120)
           for _ in range(conns)]
for c in clients:
    c.connect()
gate = threading.Event()

def run(w):
    c = clients[w]
    for n in range(w, len(paths), conns):
        j, path = paths[n][0], paths[n][1].strip()
        t0 = time.time()
        c.request("GET", path, headers={"Accept": "application/json"})
        r = c.getresponse()
        body = r.read()
        t1 = time.time()
        ids = [p[0] for p in json.loads(body)] if r.status == 200 else []
        out[n] = [int(j), r.status, t0, t1, ids]

threads = [threading.Thread(target=run, args=(w,)) for w in range(conns)]
print("ready", flush=True)
sys.stdin.readline()  # "go"
for t in threads:
    t.start()
for t in threads:
    t.join()
for row in out:
    print(json.dumps(row))
"""


def http_burst(port: int, paths: list[str]) -> list:
    """Send paths over CLIENT_PROCS load-generator processes at once; the
    rows of every process, in any order."""
    procs = []
    try:
        for c in range(CLIENT_PROCS):
            mine = [f"{j} {paths[j]}\n"
                    for j in range(c, len(paths), CLIENT_PROCS)]
            pr = subprocess.Popen(
                [sys.executable, "-c", CLIENT, str(port), str(CLIENT_CONNS)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            pr.stdin.write(f"{len(mine)}\n" + "".join(mine))
            pr.stdin.flush()
            procs.append(pr)
        for pr in procs:  # every connection open before any request
            check(pr.stdout.readline().strip() == "ready",
                  "load generator did not start")
        for pr in procs:
            pr.stdin.write("go\n")
            pr.stdin.flush()
        rows = []
        for pr in procs:
            out, _ = pr.communicate(timeout=600)
            check(pr.returncode == 0, f"load generator exited {pr.returncode}")
            rows.extend(json.loads(line) for line in out.splitlines())
        return rows
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()


def http_get(port: int, path: str, method: str = "GET", body=None):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body,
                  headers={"Accept": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def http_mode(torch, np, T, mode, path, model_data, users, exact_rows) -> dict:
    """Phase 4 in one score mode: ServingLayer from config, MODEL-REF over
    the bus, /ready, a burst of /recommend from other processes, /pref to
    the input topic, an UP row served over HTTP."""
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import ConsumeDataIterator, TopicProducer
    from oryx_tpu_torch.bus import get_broker, topic_admin
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.serving.batcher import TopKBatcher
    from oryx_tpu_torch.serving.server import ServingLayer

    broker = f"mem://chip-smoke-{mode}"
    overlay = dict(app_overlay("als"))
    overlay.update({
        "oryx.update-topic.broker": broker,
        "oryx.input-topic.broker": broker,
        "oryx.serving.api.port": 0,
        "oryx.serving.api.score-mode": mode,
    })
    config = load_config(overlay=overlay)
    topics = {w: config.get_string(f"oryx.{w}-topic.message.topic")
              for w in ("input", "update")}
    for w, topic in topics.items():  # as `setup` would, before serving
        topic_admin.maybe_create(broker, topic)
    t0 = time.monotonic()
    layer = ServingLayer(config)  # loads the model manager by name
    layer.start()
    try:
        start_s = time.monotonic() - t0
        port = layer.port
        update = TopicProducer(get_broker(broker), topics["update"])
        t0 = time.monotonic()
        update.send("MODEL-REF", path)
        status = None
        while time.monotonic() - t0 < 600:
            status, _ = http_get(port, "/ready")
            if status == 200:
                break
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        check(status == 200, f"/ready answered {status} after {ready_s} s")
        y_dev = layer.model_manager.get_model()._device_view[0]
        check(y_dev.device.type == "cuda", "served view is not on the card")

        batcher = TopKBatcher.shared()
        paths = [f"/recommend/u{int(u)}?howMany={HOW_MANY}" for u in users]
        d0, c0 = batcher.dispatches, batcher.coalesced
        T.reset_launches()  # the main path's window opens
        rows = http_burst(port, paths)
        torch.cuda.synchronize()
        launches = dict(T.LAUNCHES)  # ... and closes
        by_type = dict(T.PARTIAL_LAUNCHES_BY_TYPE)
        dispatches = batcher.dispatches - d0
        coalesced = batcher.coalesced - c0
        check(len(rows) == len(paths), f"{len(rows)} answers to {len(paths)}")
        non_200 = sum(1 for r in rows if r[1] != 200)
        check(non_200 == 0, f"{non_200} non-200 answers")
        check(coalesced == len(paths),
              f"{coalesced} requests reached the batcher for {len(paths)}")
        check(0 < dispatches < len(paths),
              f"{dispatches} dispatches for {len(paths)} requests")
        check(launches["topk_dot_partial"] == dispatches
              and launches["topk_merge"] == dispatches,
              f"launches {launches} != dispatches {dispatches}")
        known = model_data["known_idx"]
        hits = 0
        for j, _status, _t0, _t1, ids in rows:
            check(len(ids) == HOW_MANY, "short answer")
            check(not set(ids) & {f"i{int(r)}" for r in known[users[j]]},
                  "a known item was served")
            hits += len(set(ids) & {f"i{int(r)}" for r in exact_rows[j]})
        recall = hits / (HOW_MANY * len(rows))
        check(recall >= MIN_RECALL[mode],
              f"http {mode} recall@10 {recall} < {MIN_RECALL[mode]}")
        wall = max(r[3] for r in rows) - min(r[2] for r in rows)
        lat = sorted((r[3] - r[2]) * 1e3 for r in rows)
        _s, healthz = http_get(port, "/healthz")
        traced = None
        if mode == "exact":
            # the same burst again, untimed, with the card traced (device
            # activity only): how busy the card is at the HTTP edge
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                rows_p = http_burst(port, paths)
                torch.cuda.synchronize()
            traced = device_profile(
                prof, max(r[3] for r in rows_p) - min(r[2] for r in rows_p))

        # a preference write reaches the input topic
        user = f"u{int(users[0])}"
        status, _ = http_get(port, f"/pref/{user}/i1", "POST", b"2.5")
        check(status == 200, f"POST /pref answered {status}")
        with ConsumeDataIterator(get_broker(broker), topics["input"],
                                 start="earliest") as it:
            lines = [km.message for km in it.poll_available()]
        check(f"{user},i1,2.5" in lines, f"input topic holds {lines}")

        # an UP row planting a new best item is served over HTTP
        star = 10.0 * model_data["x"][int(users[0])]
        t0 = time.monotonic()
        update.send("UP", json.dumps(["Y", "i-http-new",
                                      [float(v) for v in star]]))
        first = None
        while time.monotonic() - t0 < 60:
            status, body = http_get(port, f"/recommend/{user}?howMany=3")
            first = json.loads(body)[0][0] if status == 200 else None
            if first == "i-http-new":
                break
            time.sleep(0.01)
        up_s = time.monotonic() - t0
        check(first == "i-http-new", f"planted item not served: {first}")
        return {
            "phase": "http", "mode": mode, "frontend": "async",
            "loops": layer.app.loop_count, "start_s": start_s,
            "ready_s": ready_s, "requests": len(paths),
            "client_processes": CLIENT_PROCS,
            "connections": CLIENT_PROCS * CLIENT_CONNS,
            "non_200": non_200, "qps": len(paths) / wall, "wall_s": wall,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "recall_at_10": recall, "dispatches": dispatches,
            "mean_batch": coalesced / dispatches, "launches": launches,
            "partial_launches_by_type": by_type,
            "latency_budget": json.loads(healthz).get("latency_budget"),
            "profile": traced,
            "pref_to_input_topic": True, "up_served_after_s": up_s,
        }
    finally:
        layer.close()


# ---------------------------------------------------------------------------
# phase 5: train (the batch layer's trainer at the north-star shape)
# ---------------------------------------------------------------------------

# the bench's north star (bench.py:1203-1215): ML-25M shape, 50 features,
# 10 sweeps; and its 1M warm-up shape (bench.py:1184)
TRAIN_SHAPE = (162_000, 59_000, 25_000_000)
SMALL_SHAPE = (6_000, 3_700, 1_000_000)
TRAIN_HP = {"features": 50, "iterations": 10, "lam": 0.01, "alpha": 1.0,
            "seed": 7, "holdout_p": 0.02}
MIN_AUC = 0.87  # tests/test_quality_gate.py floor
ALS_REPLACES = "oryx_tpu/ops/als.py:535"  # _half_step (no Pallas kernel)

# aten ops of the half-step, by what they do
TRAIN_OPS = {
    "gather": ("aten::index",),
    "bmm": ("aten::bmm",),
    "cholesky_ex": ("aten::linalg_cholesky_ex",),
    "solve_triangular": ("aten::linalg_solve_triangular",),
    "scatter": ("aten::index_put_",),
}


def train_op_bounds(u_dev, i_dev, k: int, itemsize: int) -> dict:
    """Per sweep, the least time each op of the half-step could take
    (H100 SXM peaks): gather = the gathered [B,P,K] bytes; bmm = the
    normal-equation FLOPs (ops/flops.py, without the fixed side's gram),
    f32 products for either compute type;
    cholesky = n·K³/3 f32 FLOPs; the two triangular solves = 2·n·K² f32
    FLOPs against reading both factors; scatter = the solved rows read and
    written."""
    from oryx_tpu_torch.ops.flops import als_halfstep_flops

    shapes = [tuple(b[1].shape) for b in list(u_dev) + list(i_dev)]
    n = sum(s[0] for s in shapes)
    gathered = sum(s[0] * s[1] * k for s in shapes)
    bmm_flops = sum(als_halfstep_flops(s[0], s[1], k, 0) for s in shapes)
    out = {
        "gather": bound(gathered * itemsize, 0, "bfloat16"),
        "bmm": bound(0, bmm_flops, "float32"),
        "cholesky_ex": bound(n * k * k * 4, n * k ** 3 / 3, "float32"),
        "solve_triangular": bound(2 * n * k * k * 4, 2 * n * k * k, "float32"),
        "scatter": bound(2 * n * k * 4, 0, "float32"),
    }
    return {name: {"bound_ms": ms, "bound_by": by} for name, (ms, by) in out.items()}


def train_profile(torch, report, compute_dtype: str) -> dict:
    """The build's data, one sweep at a time from its trained Y, untimed by
    the build: one sweep by the host's clock; one traced with the card's
    activity only (kernel time, launches, and the card's busy share of
    that sweep's wall time); one traced with host ops as well, which
    attributes the card's time to the half-step's ops (gather, bmm,
    cholesky_ex, solve_triangular, scatter; the rest is "other"), beside
    each op's bound."""
    from torch.autograd import DeviceType

    from oryx_tpu_torch.ops import als as A

    data, model = report.data, report.model
    k = model.y.shape[1]
    lists = {}
    for tag, ent, oth, n in (("u_buckets", data.users, data.items, data.n_users),
                             ("i_buckets", data.items, data.users, data.n_items)):
        lists[tag] = A._cached_lists(
            tag, data, (1024, 1024, 1024),
            lambda ent=ent, oth=oth, n=n: A.build_bucketed_lists(
                ent, oth, data.values, n, 1024, block=1024, unit=1024),
        )
    u_dev = A._upload_buckets(lists["u_buckets"][0], data.n_users, "cuda")
    i_dev = A._upload_buckets(lists["i_buckets"][0], data.n_items, "cuda")
    y = torch.from_numpy(model.y).cuda()

    def sweep():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A._als_train_bucketed(
            u_dev, i_dev, y, TRAIN_HP["lam"], TRAIN_HP["alpha"],
            implicit=True, iterations=1, blocks_u=lists["u_buckets"][1],
            blocks_i=lists["i_buckets"][1], n_u=data.n_users,
            compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_ms = sweep()
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CUDA]) as prof:
        traced_ms = sweep()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    device_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        sweep()
    events = prof.key_averages()
    by_op = {}
    for name, keys in TRAIN_OPS.items():
        evs = [ev for ev in events if ev.key in keys]
        by_op[name] = {"device_ms": sum(ev.device_time_total for ev in evs) / 1e3,
                       "calls": sum(ev.count for ev in evs)}
    attributed = sum(ev.self_device_time_total for ev in events
                     if ev.device_type == DeviceType.CUDA) / 1e3
    by_op["other"] = {
        "device_ms": attributed - sum(v["device_ms"] for v in by_op.values()),
        "calls": None,
    }
    bounds = train_op_bounds(u_dev, i_dev, k, 2 if compute_dtype == "bfloat16" else 4)
    for name, b in bounds.items():
        by_op[name].update(b)
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:10]
    return {
        "sweep_ms": plain_ms, "traced_sweep_ms": traced_ms,
        "device_ms": device_ms, "device_busy_share": device_ms / traced_ms,
        "kernel_launches": sum(ev.count for ev in kernels),
        "by_op": by_op,
        "top_kernels_ms": {ev.key[:80]: ev.self_device_time_total / 1e3
                           for ev in top},
    }


def one_build(torch, shape, compute_dtype: str, device) -> dict:
    from oryx_tpu_torch.ml.quality import build_and_evaluate
    from oryx_tpu_torch.ops.flops import device_peak_flops

    n_u, n_i, nnz = shape
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = build_and_evaluate(
        n_u, n_i, nnz, features=TRAIN_HP["features"],
        iterations=TRAIN_HP["iterations"], lam=TRAIN_HP["lam"],
        alpha=TRAIN_HP["alpha"], compute_dtype=compute_dtype,
        seed=TRAIN_HP["seed"], holdout_p=TRAIN_HP["holdout_p"],
        device=device)
    t = rep.timings
    rate = t["train_flops"] / t["train_s"]
    peak = device_peak_flops(compute_dtype) if device == "cuda" else None
    peak32 = device_peak_flops("float32") if device == "cuda" else None
    line = {
        "shape": {"users": n_u, "items": n_i, "interactions": nnz,
                  "features": TRAIN_HP["features"],
                  "sweeps": TRAIN_HP["iterations"]},
        "compute_dtype": compute_dtype,
        "tf32": t["tf32"],
        "synth_s": t["synth_s"], "agg_s": rep.agg_s, "lists_s": t["lists_s"],
        "train_s": t["train_s"], "build_s": rep.build_s,
        "wall_s": time.perf_counter() - t0,
        "train_flops": t["train_flops"], "tflops_per_s": rate / 1e12,
        "peak_share": rate / peak if peak else None,
        "f32_peak_share": rate / peak32 if peak32 else None,
        "auc": rep.auc, "nan_rows": rep.nan_rows,
        "aggregated": len(rep.data.values),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if device == "cuda" else None),
    }
    check(rep.nan_rows == 0, f"{compute_dtype} build: {rep.nan_rows} NaN rows")
    check(rep.auc >= MIN_AUC, f"{compute_dtype} build: AUC {rep.auc} < {MIN_AUC}")
    check(not line["tf32"], "TF32 was on while the sweeps ran")
    return line, rep


def train_phase(torch, shape=TRAIN_SHAPE, small=SMALL_SHAPE,
                device="cuda") -> dict:
    """Phase 5: build_and_evaluate at the north-star shape in bf16, one
    profiled sweep, then f32 and bf16 builds at the 1M shape. A small
    build first brings up the card's libraries (cuBLAS, cuSOLVER), so that
    the timed builds do not pay for it."""
    from oryx_tpu_torch.ml.quality import build_and_evaluate

    t0 = time.perf_counter()
    build_and_evaluate(2_000, 1_000, 50_000, features=TRAIN_HP["features"],
                       iterations=2, device=device)
    warmup_s = time.perf_counter() - t0
    big, rep = one_build(torch, shape, "bfloat16", device)
    big["sweeps_per_s"] = TRAIN_HP["iterations"] / big["train_s"]
    prof = train_profile(torch, rep, "bfloat16") if device == "cuda" else None
    if prof is not None:
        big["launches_per_sweep"] = prof["kernel_launches"]
    del rep
    small_f32, _ = one_build(torch, small, "float32", device)
    small_bf16, _ = one_build(torch, small, "bfloat16", device)
    return {"phase": "train", "warmup_s": warmup_s, "bf16": big, "profile": prof,
            "small_f32": small_f32, "small_bf16": small_bf16}


# ---------------------------------------------------------------------------
# phase 6: the lambda loop (batch -> serving -> speed -> batch) on one bus
# ---------------------------------------------------------------------------

LAMBDA_USERS = 64          # /recommend probes against the exact top-10
SPEED_EVENTS, SPEED_NEW = 20_000, 64
DELTA_EVENTS = 50_000
FOLD_RTOL = 1e-4  # relative to the row's largest entry, on top of ...
UP_QUANTUM = 1e-6  # ... one unit of the UP codec's rounding (6 decimals),
# which a difference in the 7th decimal can flip on either side


def event_lines(np, users, items, values, t0_ms: int) -> list:
    return [f"u{u},i{i},{v:g},{t0_ms + j}"
            for j, (u, i, v) in enumerate(zip(users.tolist(), items.tolist(),
                                               values.tolist()))]


def published_factors(np, root: Path, ts: int) -> dict:
    """Generation ts's model as it went out on the update topic: the
    artifact's factors rounded as the UP rows round them (apps/updates.py)
    and held in float32 as the serving state holds them."""
    from oryx_tpu_torch.apps.updates import ROUND_DECIMALS
    from oryx_tpu_torch.common.artifact import ModelArtifact

    art = ModelArtifact.read(root / str(ts))
    pub = lambda a: np.round(np.asarray(a, np.float64), ROUND_DECIMALS).astype(
        np.float32).astype(np.float64)  # noqa: E731
    yids = art.get_extension_list("YIDs")
    return {"x": pub(art.tensors["X"]), "y": pub(art.tensors["Y"]),
            "row": {u: j for j, u in enumerate(art.get_extension_list("XIDs"))},
            "yids": yids, "col": {i: j for j, i in enumerate(yids)}}


def served_recall(np, port, model: dict, users: list) -> tuple | None:
    """(strict recall@10, recall@10 counting a served item whose exact
    score ties the 10th within 1e-6 relative) of /recommend against the
    exact float64 top-10 of the published factors, without the items
    /knownItems names for the user; None while an answer is not 200."""
    hits = tie_hits = total = 0
    for u in users:
        status, body = http_get(port, f"/knownItems/{u}")
        if status != 200:
            return None
        s = model["y"] @ model["x"][model["row"][u]]
        for i in json.loads(body):
            if i in model["col"]:
                s[model["col"][i]] = -np.inf
        top = {model["yids"][j] for j in np.argsort(-s, kind="stable")[:HOW_MANY]}
        tenth = np.sort(s)[-HOW_MANY]
        status, body = http_get(port, f"/recommend/{u}?howMany={HOW_MANY}")
        if status != 200:
            return None
        ids = [r[0] for r in json.loads(body)]
        check(len(ids) == HOW_MANY, f"short answer for {u}")
        for i in ids:
            hits += i in top
            tie_hits += i in top or (
                i in model["col"]
                and s[model["col"][i]] >= tenth - 1e-6 * abs(tenth))
        total += HOW_MANY
    return hits / total, tie_hits / total


def lambda_phase(torch, np, T, root: Path, device="cuda",
                 shape=SMALL_SHAPE, speed_events=SPEED_EVENTS,
                 delta_events=DELTA_EVENTS) -> dict:
    """Phase 6: the whole loop on one file:// bus with the als app's
    classes (apps/spi.py), each layer built from config."""
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.apps.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.apps.als.state import state_from_arrays
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import TopicProducer, get_broker, topic_admin
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.metrics import get_registry
    from oryx_tpu_torch.layers import BatchLayer, SpeedLayer
    from oryx_tpu_torch.ml.synth import synthesize_interactions
    from oryx_tpu_torch.serving.server import ServingLayer

    bus = f"file://{root / 'bus'}"
    overlay = dict(app_overlay("als"))
    overlay.update({
        "oryx.id": "smoke-lambda",
        "oryx.input-topic.broker": bus, "oryx.update-topic.broker": bus,
        "oryx.batch.storage.data-dir": f"file://{root / 'data'}",
        "oryx.batch.storage.model-dir": f"file://{root / 'model'}",
        "oryx.monitoring.quarantine.dir": f"file://{root / 'quarantine'}",
        "oryx.serving.api.port": 0,
        "oryx.speed.streaming.generation-interval-sec": 3600,
        "oryx.batch.streaming.generation-interval-sec": 3600,
        "oryx.als.hyperparams.features": TRAIN_HP["features"],
        "oryx.als.hyperparams.iterations": TRAIN_HP["iterations"],
        "oryx.als.hyperparams.lambda": TRAIN_HP["lam"],
        "oryx.als.hyperparams.alpha": TRAIN_HP["alpha"],
        "oryx.als.compute-dtype": "bfloat16",
        "oryx.serving.min-model-load-fraction": 1.0,
        "oryx.speed.min-model-load-fraction": 1.0,
    })
    cfg = load_config(overlay=overlay)
    topics = {w: cfg.get_string(f"oryx.{w}-topic.message.topic")
              for w in ("input", "update")}
    for topic in topics.values():  # as `setup` would
        topic_admin.maybe_create(bus, topic)
    cpu = device == "cpu"  # a CPU rehearsal names the device; the card
    # run builds every layer from config alone, as the CLI does

    def batch_layer():
        return BatchLayer(cfg, update=ALSUpdate(cfg, device="cpu") if cpu else None)

    inputs = TopicProducer(get_broker(bus), topics["input"])
    incremental = get_registry().counter("oryx_batch_incremental_total")
    out = {"phase": "lambda", "shape": {"users": shape[0], "items": shape[1],
                                        "interactions": shape[2]}}
    layers = []
    try:
        # a. the events, behind a batch consumer that already exists
        batch = batch_layer()
        layers.append(batch)
        batch.ensure_streams()
        users, items, values = synthesize_interactions(*shape, seed=TRAIN_HP["seed"])
        ts = int(time.time() * 1000)  # 13-digit generation stamps
        t0 = time.perf_counter()
        inputs.send_batch((None, line) for line in event_lines(
            np, users, items, values, ts - 86_400_000))
        out["write_s"] = time.perf_counter() - t0

        # b. a full generation, trained on the card
        d0 = incremental.value(kind="delta")
        t0 = time.perf_counter()
        n_new = batch.run_generation(ts)
        out["generation_full_s"] = time.perf_counter() - t0
        t_published = time.monotonic()
        check(n_new == shape[2], f"generation 1 read {n_new} records")
        check(incremental.value(kind="full") >= 1, "no full build counted")
        batch.close()

        # c. serving on the same topics
        serving = ServingLayer(
            cfg, model_manager=ALSServingModelManager(cfg, device="cpu")
            if cpu else None)
        layers.append(serving)
        serving.start()
        port = serving.port
        status = None
        while time.monotonic() - t_published < 300:
            status, _ = http_get(port, "/ready")
            if status == 200:
                break
            time.sleep(0.05)
        out["publish_to_ready_s"] = time.monotonic() - t_published
        check(status == 200, f"/ready answered {status}")

        # d. /recommend against the exact top-10 of the published factors
        model_root = root / "model"
        probe = [f"u{int(u)}" for u in np.random.default_rng(SEED).choice(
            np.unique(users), LAMBDA_USERS, replace=False)]
        T.reset_launches()  # the serving leg's window opens
        got = served_recall(np, port, published_factors(np, model_root, ts), probe)
        check(got is not None, "/recommend or /knownItems did not answer 200")
        strict, recall = got
        out["recall_at_10"] = recall
        out["recall_at_10_strict"] = strict
        check(recall == 1.0, f"lambda recall@10 {recall} (strict {strict})")

        # e. the speed layer folds new events in, on the card
        speed = SpeedLayer(cfg, manager=ALSSpeedModelManager(cfg, device="cpu")
                           if cpu else None)
        layers.append(speed)
        speed.start()
        mgr = speed.manager
        folds = []
        real = mgr.build_updates

        def build_updates(batch_records):
            # the state as this micro-batch finds it, for the plain fold
            # below (the listener applies the batch's own rows later)
            st = mgr.state
            x, xids, _ = st.x.snapshot()
            y, yids, _ = st.y.snapshot()
            before = state_from_arrays(st.features, st.implicit, xids, x, yids, y)
            # ... and the very Cholesky factors the card will use: the same
            # inputs, not a second factorization of the same Gram matrices
            for mine, theirs in ((before.yty, st.yty), (before.xtx, st.xtx)):
                mine._chol, mine._built_version = theirs.get(), mine._store.version
            t = time.perf_counter()
            built = real(batch_records)
            if device == "cuda":
                torch.cuda.synchronize()
            folds.append((batch_records, time.perf_counter() - t, built, before))
            return built
        mgr.build_updates = build_updates
        t0 = time.monotonic()
        while time.monotonic() - t0 < 300:
            st = mgr.state
            if (st is not None and st.fraction_loaded() >= 1.0
                    and speed._update_consumer.lag() == 0):
                break
            time.sleep(0.05)
        check(mgr.state is not None and mgr.state.fraction_loaded() >= 1.0,
              "speed model never loaded")
        rng = np.random.default_rng(SEED + 5)
        su = rng.choice(users, speed_events)
        si = rng.choice(items, speed_events)
        lines = event_lines(np, su, si, np.full(speed_events, 2.0), ts)
        half = SPEED_NEW // 2
        known_item = f"i{int(items[0])}"
        for j in range(half):  # new users with known items, known users
            lines[j] = f"u-new-{j},{known_item},3,{ts + j}"  # with new items
            lines[half + j] = f"{probe[j]},i-new-{j},3,{ts + half + j}"
        t_write = time.monotonic()
        inputs.send_batch((None, line) for line in lines)
        n_speed = speed.run_batch()
        check(n_speed == speed_events, f"speed read {n_speed} events")
        status = None
        while time.monotonic() - t_write < 60:
            status, body = http_get(port, f"/recommend/u-new-0?howMany={HOW_MANY}")
            if status == 200:
                break
            time.sleep(0.005)
        out["event_to_served_s"] = time.monotonic() - t_write
        check(status == 200, f"/recommend/u-new-0 answered {status}")

        # f. every speed UP row against the fold-in's plain version: the
        # same manager code on device="cpu" from the same state
        twin = ALSSpeedModelManager(cfg, device="cpu")
        n_rows = worst = worst_abs = 0
        for records, _dt, got, before in folds:
            twin.state = before
            ref = twin.build_updates(records)
            check(len(got) == len(ref), "card and CPU fold-ins differ in rows")
            for (k1, m1), (k2, m2) in zip(got, ref):
                a, b = json.loads(m1), json.loads(m2)
                check(k1 == k2 == "UP" and a[:2] == b[:2], "row order differs")
                va, vb = np.asarray(a[2]), np.asarray(b[2])
                diff = float(np.abs(va - vb).max())
                worst_abs = max(worst_abs, diff)
                worst = max(worst, max(0.0, diff - UP_QUANTUM)
                            / max(float(np.abs(vb).max()), 1e-30))
                n_rows += 1
        check(n_rows > 0, "the speed layer published no rows")
        check(worst <= FOLD_RTOL, f"speed UP rows {worst} from the plain fold-in")
        events = sum(len(f[0]) for f in folds)
        out["speed"] = {
            "events": events, "up_rows": n_rows,
            "build_s": sum(f[1] for f in folds),
            "events_per_s": events / sum(f[1] for f in folds),
            "max_rel_err_vs_plain": worst, "max_abs_diff_vs_plain": worst_abs,
            "new_user_served": True,
        }
        speed.close()
        layers.remove(speed)

        # g. a delta generation in a fresh batch layer (a restart: the
        # snapshot and the warm-start factors come from disk)
        rng = np.random.default_rng(SEED + 6)
        du = rng.choice(users, delta_events)
        di = rng.choice(items, delta_events)
        inputs.send_batch((None, line) for line in event_lines(
            np, du, di, np.full(delta_events, 1.0), ts + 1))
        batch = batch_layer()
        layers.append(batch)
        upd, warm = batch.update, []
        load_prev = upd._load_prev_factors

        def load_prev_factors(model_dir):
            load_prev(model_dir)
            warm.append(upd._prev_y is not None)
        upd._load_prev_factors = load_prev_factors
        t0 = time.perf_counter()
        batch.run_generation(ts + 1)
        out["generation_delta_s"] = time.perf_counter() - t0
        out["delta_builds"] = incremental.value(kind="delta") - d0
        check(out["delta_builds"] == 1,
              f"delta builds {out['delta_builds']} (not incremental)")
        out["delta_sweeps"] = get_registry().gauge(
            "oryx_batch_warm_iterations").value()
        out["warm_start_from_model_dir"] = warm == [True]
        check(warm == [True], f"no warm start from the model dir: {warm}")
        batch.close()

        # h. serving takes the new generation
        model2 = published_factors(np, model_root, ts + 1)
        t0 = time.monotonic()
        recall2 = None
        while time.monotonic() - t0 < 120:
            got = served_recall(np, port, model2, probe)
            recall2 = None if got is None else got[1]
            if recall2 == 1.0:
                break
            time.sleep(0.1)
        out["generation_2_served_after_s"] = time.monotonic() - t0
        out["recall_at_10_generation_2"] = recall2
        check(recall2 == 1.0, f"generation 2 not served: recall {recall2}")
        if device == "cuda":
            torch.cuda.synchronize()
        out["launches"] = dict(T.LAUNCHES)  # ... and closes
        out["partial_launches_by_type"] = dict(T.PARTIAL_LAUNCHES_BY_TYPE)
        if device == "cuda":
            check(all(v > 0 for v in out["launches"].values()),
                  f"the serving leg launched {out['launches']}")
    finally:
        for layer in layers:
            layer.close()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from oryx_tpu_torch.ops import _build
    from oryx_tpu_torch.ops import topk as T
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    t_start = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.monotonic()
    build = _build.build_all()
    emit({"phase": "environment", "device": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build, "build_wall_s": time.monotonic() - t0})

    t0 = time.monotonic()
    lines, at_serving, at_single = kernel_phase(torch, T)
    emit({"phase": "kernels-done", "checks": len(lines),
          "seconds": time.monotonic() - t0})

    t0 = time.monotonic()
    serving = {}
    with tempfile.TemporaryDirectory(prefix="oryx-smoke-") as tmp:
        path, model_data = write_model(np, Path(tmp))
        emit({"phase": "model-written", "seconds": time.monotonic() - t0})
        users = np.random.default_rng(SEED + 2).choice(
            N_USERS, size=N_REQUESTS, replace=False)
        exact_rows = exact_top(torch, np, model_data, users)
        for mode in ("exact", "quantized"):
            serving[mode] = serve_mode(torch, np, T, mode, path, model_data,
                                       users, exact_rows)
            emit(serving[mode])
        emit({"phase": "serving-done", "seconds": time.monotonic() - t0})
        t0 = time.monotonic()
        # the shared batcher must still be open: a closed one stays closed
        for mode in ("exact", "quantized"):
            served = http_mode(torch, np, T, mode, path, model_data, users,
                               exact_rows)
            emit(served)
            serving["http-" + mode] = served
    emit({"phase": "http-done", "seconds": time.monotonic() - t0})

    t0 = time.monotonic()
    trained = train_phase(torch)
    trained["seconds"] = time.monotonic() - t0
    emit(trained)
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    root = Path(__file__).resolve().parent / "build" / "smoke-lambda"
    shutil.rmtree(root, ignore_errors=True)
    try:
        loop = lambda_phase(torch, np, T, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    loop["seconds"] = time.monotonic() - t0
    emit(loop)
    serving["lambda"] = loop
    TopKBatcher.shared().close()

    launches = {
        name: sum(run["launches"][name] for run in serving.values())
        for name in T.LAUNCHES
    }
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    bf, i8 = at_serving["bfloat16"], at_serving["int8"]
    bf1 = at_single["bfloat16"]
    kernels = [
        {
            "name": "topk_dot_partial", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": launches["topk_dot_partial"],
            "max_abs_err": max(l["partial"]["max_abs_err"] for l in lines),
            "ms": bf["partial_ms"], "wall_ms": bf["partial_wall_ms"],
            "plain_ms": bf["partial_plain_ms"],
            "bound_ms": bf["partial_bound_ms"],
            "bound_by": bf["partial_bound_by"],
            "library_ms": bf["library_ms"],
            "library_wall_ms": bf["library_wall_ms"],
            "queued": queued(bf, ms="partial", plain_ms="partial_plain",
                             library_ms="library"),
            # per instantiation; score-mode exact serves the bf16 view,
            # quantized the int8 one, and no serving mode the f32 one
            "variants": [
                {"type": t, "launches": n_launch,
                 "ms": at_serving[t]["partial_ms"],
                 "wall_ms": at_serving[t]["partial_wall_ms"],
                 "plain_ms": at_serving[t]["partial_plain_ms"],
                 "bound_ms": at_serving[t]["partial_bound_ms"],
                 "library_ms": at_serving[t]["library_ms"],
                 "queued": queued(at_serving[t], ms="partial",
                                  plain_ms="partial_plain",
                                  library_ms="library")}
                for t, n_launch in (
                    (t, sum(run["partial_launches_by_type"][t]
                            for run in serving.values()))
                    for t in ("bfloat16", "int8", "float32")
                )
            ],
            "shape": {"B": bf["B"], "I": bf["I"], "F": bf["F"], "k": bf["k"]},
            "checked": True,
        },
        {
            "name": "topk_merge", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": MERGE_REPLACES,
            "launches": launches["topk_merge"],
            "max_abs_err": max(l["merge"]["max_abs_err"] for l in lines),
            "ms": bf["merge_ms"], "wall_ms": bf["merge_wall_ms"],
            "plain_ms": bf["merge_plain_ms"],
            "bound_ms": bf["merge_bound_ms"], "bound_by": bf["merge_bound_by"],
            "library_ms": bf["merge_library_ms"],
            "library_wall_ms": bf["merge_library_wall_ms"],
            "queued": queued(bf, ms="merge", plain_ms="merge_plain",
                             library_ms="merge_library"),
            "shape": {"S": bf["splits"], "B": bf["B"], "kb": bf["kb"],
                      "k": bf["k"]},
            "int8_ms": i8["merge_ms"],
            # B=1 (single-row case): one request in a dispatch
            "b1": {"S": bf1["splits"], "kb": bf1["kb"], "k": bf1["k"],
                   "ms": bf1["merge_ms"], "wall_ms": bf1["merge_wall_ms"],
                   "bound_ms": bf1["merge_bound_ms"],
                   "library_ms": bf1["merge_library_ms"],
                   "library_wall_ms": bf1["merge_library_wall_ms"],
                   "whole_call_ms": bf1["ms"],
                   "whole_call_wall_ms": bf1["wall_ms"],
                   "whole_call_library_ms": bf1["library_ms"],
                   "whole_call_library_wall_ms": bf1["library_wall_ms"],
                   "queued": queued(bf1, ms="merge", library_ms="merge_library",
                                    whole_call_ms="whole",
                                    whole_call_library_ms="library")},
            "checked": True,
        },
    ]
    # every device reading whose calls were not all issued while the card
    # was busy with the calls before them
    emit({"phase": "timing", "not_queued": NOT_QUEUED})
    emit({"phase": "done", "seconds": time.monotonic() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
