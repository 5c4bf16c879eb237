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
   planting a new best item must come back from /recommend over HTTP.

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero; without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
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
    TopKBatcher.shared().close()
    emit({"phase": "http-done", "seconds": time.monotonic() - t0})

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
