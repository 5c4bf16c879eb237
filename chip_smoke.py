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
2a. kernel-shard and kernel-big-view: the serving catalog in 4 row shards
   (bf16 and int8; B = 512, k = 32): every shard's partial lists, indices
   rebased to global rows, merged by one topk_merge against its plain
   version, and the sharded call bit-identical to the unsharded one; the
   merge's time, plain and library times and bound at that shape. Then a
   20M x 128 bf16 view (5.12 GB, made on the card from a seeded
   generator) scored by the partial kernel and the merge, held against
   the library's f32 product and torch.topk block by block;
2b. gate: ml/quality.py's evaluate_score_mode_recall on the card at the
   JAX package's standing corpus (100,000 x 50, 256 queries, k = 10) and
   at the serving catalog's width (1M x 50): quantized (the int8 kernels
   through topk_dot_batch) and approx recall@10 >= 0.95, and the smoke's
   own exact-mode row (the bf16 kernels over the bf16 view, the same
   re-rank) >= 0.99; eval seconds and the launches the line caused;
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
3b. serving-sharded: phase 3's catalog at oryx.serving.api.sync.shard-count
   2 and 4, in score modes exact and quantized (one serving-shard-run line
   each): the shards on the card and pitched, the answers of 512 user
   vectors bit-identical to the unsharded view's, 2,048 concurrent
   requests (S partial launches and one merge launch a dispatch, counted
   as in phase 3; recall@10 1.0 against float64), no library top-k or
   sort among the device kernels of a traced burst, and a dirty row of
   shard 0 (and its restore) that moves shard 0's bytes alone;
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
   torch.profiler (device time, busy share). Each http line splits the
   timed burst's dispatch cycles by the batcher's own accounting: the
   dispatch records (common/perfstats.py; their count must equal the
   dispatches, each with occupancy 1.0), oryx_device_dispatch_seconds p50
   and p99, oryx_device_idle_gap_seconds summed by cause, the dispatcher
   thread's own pieces (wait, stage, issue, sync, distribute; they do
   not overlap) and the share of the window from first launch to last
   read-back that they account for, and the burn-triggered profile
   captures in the burst; beside it /healthz's mfu, occupancy, slo_burn
   and the latency budget's queue_wait and device. In score-mode quantized
   one GET /debug/profile?seconds=2 runs during one more burst: its
   dispatch records and its torch.profiler trace (which must hold top-k
   kernels). Each burst runs with the live quality sampler at its default
   1% and reports, once the sampler drained, its samples, drops, live
   recall@10 (held to the floors above from 20 samples) and margin p50;
   in score-mode quantized the burst runs again with the sampler at 10%
   and off, each with its qps. Then POST
   /pref must reach the input topic, and an UP row on the update topic
   planting a new best item must come back from /recommend over HTTP;
4a. lsh: the same model served with oryx.als.sample-rate = 0.3 (LSH
   candidates scored on the host, no device view), 512 requests over
   HTTP with the sampler at 5% and again with it off: qps, p50/p99,
   recall@10 against the float64 ranking, the sampler's live LSH recall,
   the partition build's seconds;
4b. wedge: the serving layer again, its batcher set to declare a wedge
   after 2 s and probe every 1 s, and a one-shot 5 s latency fault armed
   at serving.device (common/faults.py): the stuck request must get 503
   with Retry-After, /healthz must report device-down (503) while the card
   is down, /debug/flight must hold the health-degraded and wedge events,
   and after the probe recovers the card a burst of 256 must be all 200;
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
5b. train-mesh and collectives: train_als_tp on a (2, 2) mesh whose four
   cells share the card, at the 1M shape (50 features, 5 sweeps), against
   single-device train_als from the same initial Y (factors within the
   CPU parity test's rtol 2e-3 / atol 2e-4; held-out AUC within 0.005 on
   the same negatives); then two gloo ranks on the card: a Gram summed
   across the process boundary over CUDA tensors against the local Gram,
   a barrier, a host all-gather and a broadcast;
5c. attention (ops/attention.py; torch.matmul in f32 with TF32 off, no
   hand kernel): ring and Ulysses attention at B = 1, H = 8, S = 16,384,
   D = 128, f32, with the sequence split over a data axis of 4 cells on
   the card, causal and not, beside the exact path: each call's time
   (after a warm-up call) and peak card memory, every output within
   2e-5 (atol and rtol) of float64 on 64 seeded query rows; then
   oryx_tpu_torch.dryrun.dryrun_multichip(4) on the card (the mesh ALS
   step and the TP trainer, sharded serving bit-identical to unsharded,
   the fold-in batch, ring and Ulysses, the partitioned candidate search,
   the chunked MODEL-REF relay, the row-sharded trainer);
6. lambda (the loop, at the 1M shape's users and items): one file:// bus,
   the als app's classes from config. 500,000 events on the input topic
   (cut from 1M to fit phases 5c and 11); a full batch
   generation on the card; the serving layer started on the same topics
   (publish to /ready 200); /recommend for 64 users against the exact
   float64 top-10 of the published factors (recall@10 1.0, exact ties
   aside); the speed layer folds 20,000 new events in (64 of them for
   users and items the model never saw) on the card, every UP row held
   against the fold-in's plain version on the CPU (1e-4 relative), and the
   time from the events' write to /recommend answering for a new user;
   50,000 more events and a generation in a fresh batch layer that must
   take the incremental path (warm start from the model dir); serving
   must then serve the new generation. The update topic's max message size
   is 16 KiB, so the generation's model message goes out as MODEL-CHUNKs +
   MODEL-REF, and the serving layer reaches /ready with the model
   directory moved away (the artifact relay alone); the drift gauges of
   /healthz quality must be finite after the speed layer's events; then
   a second serving layer runs with the model gate in hold mode: armed at
   generation 1, it holds the delta generation, and POST
   /control/model/approve and /control/model/rollback are each timed to
   the generation being served, with recall@10 against both generations'
   factors. The fused top-k kernels' launches in the serving leg are
   counted as in phases 3 and 4;
7. kmeans (torch ops on the card, no hand kernel): the port's
   build_and_evaluate_kmeans at the bench's shape (5M planted points x 20
   dims, k = 100, 10 Lloyd iterations, k-means|| init): build seconds
   (upload, init and Lloyd apart), SSE ratio against the planted centers
   (<= 1.05), silhouette (>= 0.5), peak card memory; one Lloyd iteration
   from the built centers over 200,000 of the points against float64
   numpy (1e-4 of the largest center entry; a point whose two nearest
   centers tie within 1e-5 of |x|^2 + max |c|^2 goes where the card put
   it); one more build traced by torch.profiler (the card's busy share,
   device time by op). Then the kmeans app on a file:// bus: a
   KMeansUpdate generation over 200,000 of the points through
   BatchLayer, the serving layer to /ready, 256 GET /assign against the
   float64 nearest published center, and 1,000 speed events around one
   center whose UP serving must apply (the center moves to
   ClusterInfo.update's value). The mesh leg: train_kmeans at the
   bench's shape on a (2, 1) mesh of the card against one device from
   the same generator seed: centers within 1e-4 of the largest center
   entry, the SSE ratio beside it;
8. rdf (torch ops on the card): build_and_evaluate_rdf at UCI-covertype
   shape (581,012 x 54, 7 classes, 10% label noise, 10% held out; 10
   trees, depth 10, 32 bins, 14 features a node, entropy): build seconds
   (binning and growth apart), held-out accuracy (>= 0.88), peak card
   memory; route_binned_device on the card against the host's
   route_binned over the held-out rows (identical leaves); one more
   growth traced by torch.profiler. Then the rdf app on a file:// bus:
   an RDFUpdate generation over 100,000 covertype-width lines, the
   serving layer to /ready, 256 GET /predict and 256 GET
   /classificationDistribution against the host routing of the published
   forest (labels equal, probabilities within 1e-6), and 1,000 labeled
   speed events whose UP counts serving must add to its leaves. The mesh
   leg: grow_forest at the build's shape with the tree axis over a (2, 1)
   mesh of the card against one device from the same seed: the same
   forest, array for array;
9. seq (run after phase 6 and before 7: it serves through the shared
   batcher, which closes after it; the GRU trainer has no hand kernel, its
   serving reaches the top-k kernels): build_and_evaluate_seq at its
   defaults (2,000 items, 3,000 sessions, dim 32, window 8, 12 epochs) must
   reach hit-rate@10 >= 0.65 (the JAX package's calibrated floor), and at
   bench.py's accelerator shape (20,000 items, 20,000 sessions of 10, 10
   epochs) > 0.5; one more epoch there traced by torch.profiler (the card's
   busy share, device time by op); from the trained weights, 2 epochs of
   train_gru over the first 16,384 examples on the card and on the CPU
   (E and GRU weights within 1e-3). Then the seq app on a file:// bus: a
   SeqUpdate generation over bench.py's ingest shape with its sessions cut
   to 20,000 (x 12 events over 50,000 items = 240,000 events;
   oryx.seq.hyperparams.epochs cut to 5), the serving layer to /ready (at
   a load fraction of 1.0), 256 GET /recommend-next against
   a float64 GRU and full-catalog ranking of the published weights
   (recall@10 >= 0.99, the exact mode's floor: its candidates come from a
   bf16 scan, so a served item may differ from float64's only within that
   scan's rounding, 2^-7 of sum |h_i e_i|; values within 1e-4), a burst of
   1,024 over HTTP (cut from 2,048; qps, p50/p99, all 200), the encode's
   own time per request, and 1,000 speed events folded on the card, one of
   them a never-seen item: serving must apply every UP row and recommend
   the new item. The kernel launches of the app's serving leg count
   toward the kernels line, where each kernel also carries its readings
   in the seq case of phase 2 (512 x 50,000 x 32, k = 32);
10. kafka (run after phase 6): the ALS loop deployed as users deploy it,
   separate `python -m oryx_tpu_torch.cli` processes joined only by
   kafka:// topics on one tests/torch_kafka_testbroker.py broker on
   127.0.0.1 (the input topic at 4 partitions, the update topic at 1 with
   a 16 KiB max message, so the model goes out as MODEL-CHUNKs +
   MODEL-REF): `setup`; `config`, which must name the kafka:// URIs;
   `input` of phase 6's users and items, its events cut to 250,000
   (events/s produced); `batch`, its group
   reset to the earliest offset, until its first generation is on the
   topic, then SIGTERM; `serving` with oryx.serving.api.processes = 2 on
   one port in score-mode exact, then quantized: each replica's /ready,
   the replicas as new compute apps in nvidia-smi, a burst of 2,048
   /recommend on 64 connections (qps, p50/p99, every answer 200, recall@10
   against the float64 ranking of the published UP rows >= 0.99 exact,
   >= 0.95 quantized), and each replica's kernel launches read from its
   /metrics (they count toward the kernels line); `speed` folding 20,000
   events from `input` and one gzip, snappy, lz4 and zstd batch of a
   foreign producer (lz4 and zstd where the system library is found):
   both replicas must serve the new users (seconds from the write);
   `tail` across the batch and speed legs (MODEL-REF and UP lines);
   `perf --url` and `loadtest` against the replicas; `flight --kind
   process-start --kind generation` (both replicas' starts and the
   generation). Then the fleet leg (`fleet-burst`, `fleet-kill`,
   `fleet-canary` and `fleet` lines): phases 3-4's catalog, its items
   cut from 1M to 500,000 (x 50) to fit phases 5c and 11,
   published as MODEL-CHUNKs + MODEL-REF on a kafka:// topic of the same
   broker, `cli fleet --replicas 2 --policy hash --shards 2` with both
   replicas on the card, their views row-sharded 2 ways (each replica's
   /ready, the front's /fleet/healthz, each replica's /healthz shards and
   the front's oryx_fleet_replica_shards, 2 partial launches a merge), 2,048
   exact /recommend through the front (qps, p50/p99, statuses, recall@10
   1.0 against float64, the split by the front's own count, each
   replica's bf16 and merge launches from /fleet/metrics), each of 32
   users sent twice to the replica the ring names, one replica SIGKILLed
   under traffic (seconds to ejection, readmission and its /ready; no
   non-shed 5xx); then a quantized fleet with the canary plane on (the
   gate in hold mode on r1, canary traffic fraction 0.5, the quality
   sampler at 1.0): a clean generation 2 promoted on both replicas, a
   corrupted generation 3 (tools/chaos.py's construction) adopted on the
   canary only and rolled back as a pointer swap (the replicas'
   oryx_fleet_distribution_bytes unchanged), the flight rings reading
   canary-start, quality-alarm, canary-rollback in order, no non-shed
   5xx; then the canary SIGKILLed after the rollback: restarted with the
   fleet's promoted and vetoed generations, it is readmitted and serves
   generation 2, never 3 (`fleet-canary-kill` line). The fleet's launches
   count toward the kernels line. Then,
   in-process on the same broker, the wordcount
   example app over 10,000 lines (/distinct against a plain count) and
   `import-pmml` of a 100 x 20 k-means PMML served on the card (256
   /assign against the float64 nearest center). The line names the
   crc32c tier and whether the file:// buses ran through the native
   appender;
11. pod (phase 10's last leg, on its broker and its 250,000 events, on
   topics of its own): `python -m oryx_tpu_torch.cli pod --compute 2
   --serving` with two ALS candidates (lambda 0.01 and 500) searched in
   parallel by process group (oryx.ml.eval.parallelism = 2), both compute
   ranks on the card over gloo: both ranks joined, the search's two
   groups, one MODEL-REF and one TRACE on the pod's update topic (the
   leader alone publishes), the winner equal to a one-process serial
   search of the leader's persisted window with the same seeds (lambda
   equal, factors within the mesh parity tolerance), the serving child's
   /ready, 512 exact requests on it and 512 quantized on one more
   serving process on the pod's topic (qps, p50/p99, recall@10 against
   float64, each process's kernel launches, which count toward the
   kernels line), the generation's seconds; then compute rank 1
   SIGKILLed: the pod exits nonzero within 30 s and its serving child
   with it.

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. With --ab-parent DIR the script runs the
http A/B instead (cli() and AB_VARIANTS below). Any failed check raises, so the script exits
non-zero; without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import gzip
import itertools
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

SEED = 20240611
# scratch for the flight rings and profile traces (listed in .gitignore)
SMOKE_BUILD = Path(__file__).resolve().parent / "build"
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
    # the seq app's /recommend-next: a batcher group over its catalog at the
    # GRU's width (F = 32, 50,000 items)
    ("seq", 512, 50_000, 32, 32, 1),
]
BIG_ITEMS = 100_000  # time the plain and library forms only at or above
# (and in the seq case)


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


def kernel_phase(torch, T) -> tuple[list, dict, dict, dict]:
    from oryx_tpu_torch.ops.timing import wall_ms
    from oryx_tpu_torch.ops.transfer import to_pitched

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lines, at_serving, at_single, at_seq = [], {}, {}, {}
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
            if n >= BIG_ITEMS or name == "seq":
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
            if name in ("serving", "seq"):
                line["partial_plain_ms"] = time_ms(
                    torch, lambda: T.topk_dot_partial_reference(
                        xk, y, kb=kb, n_splits=n_splits, split_len=split_len,
                        scales=scales), f"{at}/partial_plain", reps=5,
                    warmup=1)
                line["merge_plain_ms"] = time_ms(
                    torch, lambda: T.topk_merge_reference(pv, pi, k=k),
                    f"{at}/merge_plain", reps=20, warmup=2)
                (at_serving if name == "serving" else at_seq)[type_name] = line
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
    return lines, at_serving, at_single, at_seq


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
# phase 2a: the cross-shard merge, and a view past 4 GiB
# ---------------------------------------------------------------------------

SHARD_CASE = (4, 512, 32)  # shards, B, k over the serving catalog
BIG_VIEW = (20_000_000, 128, 64, 32)  # items, F, B, k: a 5.12 GB bf16 view


def cross_shard_case(torch, np, T) -> dict:
    """The serving catalog (1M x 50) split in SHARD_CASE's 4 row shards on
    the card, in both shard types: each shard's partial lists (indices
    rebased to global rows) stacked and merged by one topk_merge, held
    against the merge's plain version, and the whole sharded call held
    bit-identical to the unsharded one; the merge's time at that shape, its
    plain version's, its bound and the library call's (torch.topk of the
    union of the lists). Comparison launches: not counted."""
    from oryx_tpu_torch.ops.als import topk_dot_batch
    from oryx_tpu_torch.ops.shard_topk import _shard_partials
    from oryx_tpu_torch.ops.timing import wall_ms
    from oryx_tpu_torch.ops.transfer import (
        quantized_device_put, sharded_device_put, staged_device_put,
    )

    s, b, k = SHARD_CASE
    rng = np.random.default_rng(SEED + 5)
    y = rng.standard_normal((N_ITEMS, FEATURES), dtype=np.float32)
    xs = torch.from_numpy(rng.standard_normal((b, FEATURES), dtype=np.float32)).cuda()
    out = {"phase": "kernel-shard", "shards": s, "B": b, "I": N_ITEMS,
           "F": FEATURES, "k": k}
    for type_name, quant in (("bfloat16", False), ("int8", True)):
        sm = sharded_device_put(y, s, dtype=None if quant else torch.bfloat16,
                                quantize=quant)
        full = (quantized_device_put(y) if quant
                else staged_device_put(y, dtype=torch.bfloat16))
        v1, i1 = topk_dot_batch(xs, sm, k=k)
        v0, i0 = topk_dot_batch(xs, full, k=k)
        torch.cuda.synchronize()
        check(torch.equal(v0, v1) and torch.equal(i0, i1),
              f"kernel-shard/{type_name}: sharded answers differ from unsharded")
        xq = T.quantize_queries(xs)[0] if quant else xs.to(torch.bfloat16)
        kb = T._next_pow2(k)
        parts = [_shard_partials(xq, sh, sm.plan.lo(j), kb)
                 for j, sh in enumerate(sm.shards)]
        pv = torch.cat([p[0] for p in parts])
        pi = torch.cat([p[1] for p in parts])
        mv, mi = T.topk_merge(pv, pi, k=k)
        rmv, rmi = T.topk_merge_reference(pv, pi, k=k)
        torch.cuda.synchronize()
        check(torch.equal(mv, rmv) and torch.equal(mi, rmi),
              f"kernel-shard/{type_name}: merge differs from its plain version")
        flat = pv.permute(1, 0, 2).reshape(b, -1).contiguous()
        at = f"kernel-shard/{type_name}"
        nq0 = len(NOT_QUEUED)
        row = {
            "lists": int(pv.shape[0]),
            "lists_per_shard": [int(p[0].shape[0]) for p in parts],
            "max_abs_err": 0.0,
            "ms": time_ms(torch, lambda: T.topk_merge(pv, pi, k=k), f"{at}/merge"),
            "wall_ms": wall_ms(torch, lambda: T.topk_merge(pv, pi, k=k)),
            "plain_ms": time_ms(torch, lambda: T.topk_merge_reference(pv, pi, k=k),
                                f"{at}/merge_plain", reps=5, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.topk(flat, k, dim=1),
                                  f"{at}/merge_library"),
        }
        # the merge needs only each list's first k entries
        row["bound_ms"], row["bound_by"] = bound(
            8 * pv.shape[0] * b * k + 8 * b * k, 0, type_name)
        row["not_queued"] = [w.rsplit("/", 1)[1] for w in NOT_QUEUED[nq0:]]
        out[type_name] = row
        del sm, full, parts, pv, pi, flat
        torch.cuda.empty_cache()
    return out


def big_view_case(torch, T) -> dict:
    """BIG_VIEW: a 20M x 128 bf16 item view (5.12 GB, past the JAX
    package's 4 GiB chunking threshold) made on the card from a seeded
    generator, scored by topk_dot_partial + topk_merge in one call, and
    held, block of query rows by block, against the library's f32 product
    (TF32 off) and torch.topk over item chunks. Launches: not counted."""
    from oryx_tpu_torch.ops.transfer import is_pitched

    n, f, b, k = BIG_VIEW
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    y = torch.randn((n, f), generator=gen, device="cuda", dtype=torch.bfloat16)
    xs = torch.randn((b, f), generator=gen, device="cuda").to(torch.bfloat16)
    check(is_pitched(y), "the big view is not pitched")
    kb = T._next_pow2(k)
    n_splits, split_len = T.launch_plan(b, y, kb)

    def kernel():
        pv, pi = T.topk_dot_partial(xs, y, kb=kb, n_splits=n_splits,
                                    split_len=split_len)
        return T.topk_merge(pv, pi, k=k)

    v, i = kernel()
    torch.cuda.synchronize()
    ref_v, ref_i = [], []
    chunk = 4_000_000
    for lo in range(0, b, 16):
        cv, ci = [], []
        for c in range(0, n, chunk):
            s = T._scores(xs[lo:lo + 16], y[c:c + chunk])
            tv, ti = torch.topk(s, k, dim=1)
            cv.append(tv)
            ci.append(ti + c)
        cv, ci = torch.cat(cv, 1), torch.cat(ci, 1)
        tv, o = torch.topk(cv, k, dim=1)
        ref_v.append(tv)
        ref_i.append(ci.gather(1, o).to(torch.int32))
    xf = xs.float()

    def true_score(rows, idx):
        return (xf[rows].double() * y[idx.long()].double()).sum(dim=1)

    agreed = agree(torch, v, i, torch.cat(ref_v), torch.cat(ref_i), true_score,
                   "bfloat16", f, whole=True)
    nq0 = len(NOT_QUEUED)
    out = {"phase": "kernel-big-view", "I": n, "F": f, "B": b, "k": k,
           "view_bytes": y.nbytes, "splits": n_splits, "split_len": split_len,
           **agreed,
           "ms": time_ms(torch, kernel, "big-view/whole", reps=5, warmup=1),
           "library_ms": time_ms(
               torch, lambda: torch.topk(torch.matmul(xs, y.T), k, dim=1),
               "big-view/library", reps=5, warmup=1)}
    out["bound_ms"], out["bound_by"] = bound(
        y.nbytes + xs.nbytes + 8 * b * k, 2.0 * b * n * f, "bfloat16")
    out["not_queued"] = [w.rsplit("/", 1)[1] for w in NOT_QUEUED[nq0:]]
    del y, xs, v, i
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 2b: the score-mode recall gate on the card
# ---------------------------------------------------------------------------

# (items, queries): the JAX package's standing corpus (ml/quality.py's
# defaults), then the serving catalog's full width
GATE_SHAPES = ((100_000, 256), (N_ITEMS, 256))
GATE_SEED = 23  # ml/quality.py evaluate_score_mode_recall's corpus seed


def gate_phase(torch, np, T) -> dict:
    """evaluate_score_mode_recall on the card at each GATE_SHAPES corpus
    (quantized: the int8 kernels through topk_dot_batch; approx: exact,
    as off the TPU), and beside it the smoke's own exact-mode row: the
    same corpus and re-rank, scored through topk_dot_batch over the bf16
    view (the bf16 kernels). Launch counts cover the whole phase."""
    from oryx_tpu_torch.ml.quality import (
        MIN_SCORE_MODE_RECALL,
        evaluate_score_mode_recall,
        mean_recall_at_k,
        recall_corpus,
        rescored_topk,
    )
    from oryx_tpu_torch.ops.als import topk_dot_batch, topk_dot_batch_xla
    from oryx_tpu_torch.ops.transfer import staged_device_put

    rows = []
    T.reset_launches()  # the gate's window opens
    for n_items, n_queries in GATE_SHAPES:
        before = dict(T.PARTIAL_LAUNCHES_BY_TYPE)
        rep = evaluate_score_mode_recall(n_items=n_items, n_queries=n_queries,
                                         seed=GATE_SEED)
        t0 = time.perf_counter()
        y, xs = recall_corpus(n_items, rep.features, n_queries, GATE_SEED)
        xs_d = torch.from_numpy(xs).cuda()
        _, exact_idx = topk_dot_batch_xla(xs_d, torch.from_numpy(y).cuda(),
                                          k=rep.k)
        y_bf = staged_device_put(y, dtype=torch.bfloat16, device="cuda")
        _, e_idx = topk_dot_batch(xs_d, y_bf, k=min(n_items, rep.k + 8))
        recall_e = mean_recall_at_k(
            rescored_topk(y, xs, e_idx.cpu().numpy(), rep.k),
            exact_idx.cpu().numpy(), rep.k)
        exact_s = time.perf_counter() - t0
        launched = {t: T.PARTIAL_LAUNCHES_BY_TYPE[t] - before[t]
                    for t in before}
        row = {"items": n_items, "features": rep.features,
               "queries": n_queries, "k": rep.k,
               "recall_quantized": rep.recall_quantized,
               "recall_approx": rep.recall_approx, "recall_exact": recall_e,
               "eval_s": rep.eval_s, "exact_row_s": exact_s,
               "partial_launches_by_type": launched}
        rows.append(row)
        emit({"phase": "gate-row", **row})
        check(launched["int8"] > 0 and launched["bfloat16"] > 0,
              f"gate at {n_items} items launched {launched}")
        for name in ("recall_quantized", "recall_approx"):
            check(row[name] >= MIN_SCORE_MODE_RECALL,
                  f"gate at {n_items} items: {name} {row[name]}")
        check(recall_e >= MIN_RECALL["exact"],
              f"gate at {n_items} items: exact recall {recall_e}")
        del y_bf, xs_d
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"phase": "gate", "min_recall": MIN_SCORE_MODE_RECALL,
            "min_exact_recall": MIN_RECALL["exact"], "rows": rows,
            "launches": dict(T.LAUNCHES),  # ... and closes
            "partial_launches_by_type": dict(T.PARTIAL_LAUNCHES_BY_TYPE)}


# ---------------------------------------------------------------------------
# the live quality plane, read around a burst
# ---------------------------------------------------------------------------

MIN_LIVE_SAMPLES = 20  # live recall is held to MIN_RECALL from this many


def quality_mark() -> dict:
    """Open a burst's quality window: the sampler's windows start empty
    (as at a generation boundary) and the cumulative counts are kept."""
    from oryx_tpu_torch.common.metrics import get_registry
    from oryx_tpu_torch.common.qualitystats import get_qualitystats

    qs = get_qualitystats()
    check(qs.flush(120), "the quality sampler did not drain")
    qs.note_generation()
    reg = get_registry()
    return {"samples": qs.samples_processed(),
            "dropped": reg.counter("oryx_quality_sample_drops_total").value(),
            "margins": reg.histogram("oryx_live_score_margin").bucket_counts()}


def quality_read(port: int, mode: str, mark: dict) -> dict:
    """The burst's quality from /healthz ``quality`` once the sampler has
    drained: samples and drops in the burst, live recall@10 of ``mode``,
    the margin histogram's p50 (the bucket bound it falls under). Holds
    live recall to MIN_RECALL[mode] from MIN_LIVE_SAMPLES samples."""
    from oryx_tpu_torch.common.metrics import get_registry
    from oryx_tpu_torch.common.qualitystats import get_qualitystats

    qs = get_qualitystats()
    check(qs.flush(300), "the quality sampler did not drain")
    _s, body = http_get(port, "/healthz")
    q = json.loads(body)["quality"]
    n = q["samples"] - mark["samples"]
    after = get_registry().histogram("oryx_live_score_margin").bucket_counts()
    delta = [(ub, c - c0) for (ub, c), (_u, c0) in zip(after, mark["margins"])]
    total = delta[-1][1]
    p50 = next((ub for ub, c in delta if c >= total / 2), None) if total else None
    live = qs.live_recall(mode)
    out = {"sample_rate": q["sample_rate"], "samples": n,
           "dropped": q["dropped"] - int(mark["dropped"]),
           "live_recall_at_10": None if live != live else live,
           "healthz_live_recall_at_10": q["live_recall_at_10"],
           "margin_p50_at_most": p50}
    if mode in MIN_RECALL and n >= MIN_LIVE_SAMPLES:
        check(live >= MIN_RECALL[mode],
              f"live {mode} recall@10 {live} < {MIN_RECALL[mode]} ({n} samples)")
    return out


def set_sample_rate(config, rate: float) -> None:
    """Reconfigure the quality sampler of this process (the serving
    layer's config with oryx.monitoring.quality.sample-rate replaced)."""
    from oryx_tpu_torch.common.qualitystats import configure_qualitystats

    configure_qualitystats(
        config.overlay({"oryx.monitoring.quality.sample-rate": rate}))


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def model_artifact(np, items=N_ITEMS, users=N_USERS, features=FEATURES):
    """The serving catalog: a seeded N(0,1) ALS model, each user with
    KNOWN_PER_USER known items. (artifact, {"x", "y", "known_idx"})."""
    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(SEED)
    y = rng.standard_normal((items, features), dtype=np.float32)
    x = rng.standard_normal((users, features), dtype=np.float32)
    known_idx = rng.integers(0, items, size=(users, KNOWN_PER_USER))
    x_ids = [f"u{j}" for j in range(users)]
    y_ids = [f"i{j}" for j in range(items)]
    known = {u: [f"i{int(j)}" for j in row] for u, row in zip(x_ids, known_idx)}
    art = ModelArtifact("als", content={"knownItems": known},
                        tensors={"X": x, "Y": y})
    art.set_extension("features", str(features))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", x_ids)
    art.set_extension("YIDs", y_ids)
    return art, {"x": x, "y": y, "known_idx": known_idx}


def write_model(np, root: Path) -> tuple[str, dict]:
    art, data = model_artifact(np)
    path = root / "model"
    art.write(path)
    return str(path), data


def exact_top(torch, np, model_data, users, device="cuda") -> list:
    """Exact float64 top-HOW_MANY item rows per user, known items excluded
    (torch.matmul in float64 on the card, independent of the kernels)."""
    y64 = torch.from_numpy(model_data["y"]).to(device).double()
    out = []
    for lo in range(0, len(users), 256):
        sel = users[lo:lo + 256]
        x64 = torch.from_numpy(model_data["x"][sel]).to(device).double()
        s = x64 @ y64.T
        known = torch.from_numpy(model_data["known_idx"][sel]).to(device)
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
# phase 3b: the serving path over row-sharded views
# ---------------------------------------------------------------------------

SHARD_COUNTS = (2, 4)
# device kernels of the library's top-k and sorts, which the sharded path
# must not run
LIBRARY_SELECT = ("sort", "gathertopk", "sbtopk", "mbtopk")


def shard_phase(torch, np, T, path, users, exact_rows) -> dict:
    """Phase 3's catalog served at oryx.serving.api.sync.shard-count 2 and 4
    in score modes exact and quantized: the view's shards on the card, the
    sharded kernel answers bit-identical to the unsharded view's (the same
    store snapshot, 512 user vectors, k = 32), 2,048 concurrent requests
    with recall@10 1.0 against float64 and S partial launches and one
    merge launch a dispatch, no library top-k or sort on the card (one
    traced burst), and a dirty row of shard 0 that moves shard 0's bytes
    alone (and its restore). One manager loads the artifact; each run is
    an ALSServingModel over its state."""
    from oryx_tpu_torch.apps.als.serving import (
        ALSServingModel, ALSServingModelManager, SyncConfig,
    )
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.ops.als import topk_dot_batch
    from oryx_tpu_torch.ops.transfer import (
        QuantizedMatrix, ShardedMatrix, is_pitched, quantized_device_put,
        quantized_scatter_bytes, scatter_transfer_bytes, staged_device_put,
    )
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    out = {"phase": "serving-sharded", "items": N_ITEMS, "features": FEATURES,
           "requests": len(users), "runs": []}
    launches = {"topk_dot_partial": 0, "topk_merge": 0}
    by_type = {"float32": 0, "bfloat16": 0, "int8": 0}
    t0 = time.monotonic()
    mgr = ALSServingModelManager(load_config())
    mgr.consume_key_message("MODEL-REF", path)
    state = mgr.get_model().state
    mgr.close()
    out["load_s"] = time.monotonic() - t0
    mat, _ids, _ver = state.y.snapshot()
    mat = np.asarray(mat, dtype=np.float32)
    vecs = [state.x.get(f"u{u}") for u in users]
    excl = [state.get_known_items(f"u{u}") for u in users]
    xs = torch.from_numpy(np.stack(vecs[:512])).cuda()
    row0 = state.y.get("i0").copy()
    batcher = TopKBatcher.shared()
    for mode in ("exact", "quantized"):
        quant = mode == "quantized"
        full = (quantized_device_put(mat) if quant
                else staged_device_put(mat, dtype=torch.bfloat16))
        v0, i0 = topk_dot_batch(xs, full, k=32)
        for shards in SHARD_COUNTS:
            model = ALSServingModel(state, sync=SyncConfig(shard_count=shards),
                                    score_mode=mode)
            try:
                t0 = time.monotonic()
                model.build_views()
                torch.cuda.synchronize()
                run = {"mode": mode, "shards": shards,
                       "view_build_s": time.monotonic() - t0}
                y_dev = model._device_view[0]
                check(isinstance(y_dev, ShardedMatrix) and y_dev.n_shards == shards
                      and y_dev.shape[0] == N_ITEMS,
                      f"{mode}/{shards}: not a {shards}-shard view")
                for sh in y_dev.shards:
                    rows = sh.q if quant else sh
                    check(rows.device.type == "cuda" and is_pitched(rows)
                          and isinstance(sh, QuantizedMatrix) == quant,
                          f"{mode}/{shards}: a shard is not a pitched card view")
                run["shard_rows"] = [int(sh.shape[0]) for sh in y_dev.shards]
                v1, i1 = topk_dot_batch(xs, y_dev, k=32)
                torch.cuda.synchronize()
                check(torch.equal(v0, v1) and torch.equal(i0, i1),
                      f"{mode}/{shards}: sharded answers differ from the "
                      "unsharded view's")
                run["bit_identical_rows"] = int(xs.shape[0])

                d0 = batcher.dispatches
                T.reset_launches()  # the main path's window opens
                results, sent, done, _submit = burst(model, vecs, excl)
                torch.cuda.synchronize()
                run_launches = dict(T.LAUNCHES)  # ... and closes
                run_types = dict(T.PARTIAL_LAUNCHES_BY_TYPE)
                dispatches = batcher.dispatches - d0
                check(run_launches["topk_merge"] == dispatches and
                      run_launches["topk_dot_partial"] == shards * dispatches,
                      f"{mode}/{shards}: launches {run_launches} for "
                      f"{dispatches} dispatches")
                for name in launches:
                    launches[name] += run_launches[name]
                for name in by_type:
                    by_type[name] += run_types[name]
                hits = 0
                for res, want, ex in zip(results, exact_rows, excl):
                    ids = [i for i, _ in res]
                    check(len(ids) == HOW_MANY and not set(ids) & ex,
                          f"{mode}/{shards}: a short answer or a known item")
                    hits += len(set(ids) & {f"i{int(r)}" for r in want})
                wall = max(done) - min(sent)
                lat = sorted((d - s) * 1e3 for d, s in zip(done, sent))
                run.update({
                    "dispatches": dispatches, "launches": run_launches,
                    "launches_per_dispatch": {
                        k: v / dispatches for k, v in run_launches.items()},
                    "recall_at_10": hits / (HOW_MANY * len(results)),
                    "qps": len(results) / wall, "p50_ms": quantile(lat, 0.5),
                    "p99_ms": quantile(lat, 0.99),
                })
                check(run["recall_at_10"] == 1.0,
                      f"{mode}/{shards}: recall@10 {run['recall_at_10']}")

                acts = [torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    burst(model, vecs[:256], excl[:256])
                    torch.cuda.synchronize()
                names = [ev.key for ev in prof.key_averages()
                         if ev.self_device_time_total > 0]
                library = [nm for nm in names if any(
                    w in nm.lower().replace("_", "") for w in LIBRARY_SELECT)]
                run["device_kernels"] = sorted(set(names))[:12]
                check(names and not library,
                      f"{mode}/{shards}: library selection on the card: {library}")

                # a dirty row of shard 0 (global row 0), then its restore
                probe = vecs[0]
                deltas = []
                for vec in (10.0 * probe, row0):
                    old = list(model._device_view[0].shards)
                    state.y.set("i0", np.asarray(vec, dtype=np.float32))
                    target = state.y.get_version()
                    t0 = time.monotonic()
                    while model.served_version() != target:
                        check(time.monotonic() - t0 < 60,
                              f"{mode}/{shards}: the delta never served")
                        model.top_n(probe, HOW_MANY)
                        time.sleep(0.01)
                    lr = model.last_resync
                    new = model._device_view[0]
                    per_row = (quantized_scatter_bytes(1, FEATURES) if quant
                               else scatter_transfer_bytes(1, 2, FEATURES))
                    check(lr["kind"] == "delta"
                          and lr["shard_bytes"] == {0: per_row}
                          and new.shards[0] is not old[0]
                          and all(new.shards[j] is old[j]
                                  for j in range(1, shards)),
                          f"{mode}/{shards}: the delta moved {lr}")
                    deltas.append({"shard_bytes": lr["shard_bytes"],
                                   "seconds": lr["seconds"]})
                run["delta"] = deltas
                out["runs"].append(run)
                emit({"phase": "serving-shard-run", **run})
            finally:
                model.close()
        del full
        torch.cuda.empty_cache()
    out["launches"], out["partial_launches_by_type"] = launches, by_type
    return out


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
    status, _headers, data = http_get_full(port, path, method, body)
    return status, data


def http_get_full(port: int, path: str, method: str = "GET", body=None):
    """One request: (status, headers, body)."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body,
                  headers={"Accept": "application/json"})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def quantile(vals: list, q: float) -> float:
    """Nearest-rank quantile of a sorted non-empty list."""
    return vals[min(len(vals) - 1, int(q * len(vals)))]


TIMELINE_PIECES = ("wait", "stage", "issue", "sync", "distribute")


def timeline_pieces(timeline, t_a: float, t_b: float) -> dict:
    """Seconds of each piece of the batcher's dispatcher timeline that
    fall inside [t_a, t_b] (time.monotonic)."""
    pieces = dict.fromkeys(TIMELINE_PIECES, 0.0)
    for piece, t0, t1 in list(timeline):
        pieces[piece] += max(0.0, min(t1, t_b) - max(t0, t_a))
    return pieces


def burn_captures(flight_dir: str, since_wall: float) -> int:
    """Burn-triggered profile captures (common/perfattr.py) in the flight
    ring since since_wall (time.time()), once every running capture has
    ended (each records its event when its window closes)."""
    from oryx_tpu_torch.common.flightrec import read_events

    for t in threading.enumerate():
        if t.name == "oryx-burn-capture":
            t.join(timeout=60)
    return sum(1 for e in read_events(flight_dir)
               if e.get("kind") == "profile-capture"
               and e.get("ts_ms", 0) >= since_wall * 1e3)


_BROKERS = itertools.count()


def start_http_layer(mode: str, path: str, extra: dict | None = None):
    """A ServingLayer from config in one score mode, on a mem:// broker of
    its own (a broker is process-global: a second layer on the same name
    would replay the first's update topic), with the model published as
    MODEL-REF and /ready 200. Returns (layer, config, broker, topics,
    update producer, start seconds, ready seconds)."""
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import TopicProducer, get_broker, topic_admin
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.serving.server import ServingLayer

    broker = f"mem://chip-smoke-{mode}-{next(_BROKERS)}"
    overlay = dict(app_overlay("als"))
    overlay.update({
        "oryx.update-topic.broker": broker,
        "oryx.input-topic.broker": broker,
        "oryx.serving.api.port": 0,
        "oryx.serving.api.score-mode": mode,
        "oryx.monitoring.flight.dir": str(SMOKE_BUILD / "smoke-flight"),
        "oryx.monitoring.profile.enabled": True,
        "oryx.monitoring.profile.dir": str(SMOKE_BUILD / "smoke-profile"),
    })
    overlay.update(extra or {})
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
        update = TopicProducer(get_broker(broker), topics["update"])
        t0 = time.monotonic()
        update.send("MODEL-REF", path)
        status = None
        while time.monotonic() - t0 < 600:
            status, _ = http_get(layer.port, "/ready")
            if status == 200:
                break
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        check(status == 200, f"/ready answered {status} after {ready_s} s")
    except BaseException:
        layer.close()
        raise
    return layer, config, broker, topics, update, start_s, ready_s


def dispatch_cycle(recs: list, pa, timeline) -> dict:
    """Where the burst's dispatch cycles went, from the batcher's own
    accounting. The window runs from the burst's first launch to its last
    results on the host. Dispatch seconds (common/perfstats.py records)
    and idle gaps by cause (common/perfattr.py; the first launch's gap,
    which spans the idle time before the burst, is left out) are the
    card's view: with the depth-1 pipeline a dispatch's interval spans
    the next cycle, so the two overlap and are not summed. The share is
    built from the dispatcher thread's timeline instead (serving/
    batcher.py): its pieces run in sequence on one thread, each is
    clipped to the window, and their sum over the window is the share
    of the burst the loop accounts for; the rest is its bookkeeping."""
    recs = sorted(recs, key=lambda r: r.t_start)
    t_a = recs[0].t_start
    t_b = max(r.t_start + r.wall_s for r in recs)
    gaps = pa.idle_gaps_since(recs[1].t_start) if len(recs) > 1 else {}
    by_cause = {c: gaps.get(c, 0.0) for c in (
        "empty_queue", "host_serialize", "compile_stall", "failover_backoff",
        "unattributed")}
    pieces = timeline_pieces(timeline, t_a, t_b)
    walls = sorted(r.wall_s for r in recs)
    window = t_b - t_a
    return {
        "dispatches": len(recs),
        "dispatch_seconds_p50": quantile(walls, 0.50),
        "dispatch_seconds_p99": quantile(walls, 0.99),
        "dispatch_seconds_sum": sum(walls),
        "idle_gap_seconds": by_cause,
        "window_s": window,
        "dispatcher_seconds": pieces,
        "accounted_share": sum(pieces.values()) / window,
        "mean_cycle_ms": window / len(recs) * 1e3,
        "mean_piece_ms": {k: v / len(recs) * 1e3 for k, v in pieces.items()},
    }


def http_mode(torch, np, T, mode, path, model_data, users, exact_rows) -> dict:
    """Phase 4 in one score mode: ServingLayer from config, MODEL-REF over
    the bus, /ready, a burst of /recommend from other processes (with the
    quality sampler's reading; quantized: again at 10% and off), /pref to
    the input topic, an UP row served over HTTP."""
    from oryx_tpu_torch.bus import ConsumeDataIterator, get_broker
    from oryx_tpu_torch.common.perfattr import get_perfattr
    from oryx_tpu_torch.common.perfstats import get_perfstats
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    layer, config, broker, topics, update, start_s, ready_s = \
        start_http_layer(mode, path)
    try:
        port = layer.port
        y_dev = layer.model_manager.get_model()._device_view[0]
        check(y_dev.device.type == "cuda", "served view is not on the card")

        batcher = TopKBatcher.shared()
        paths = [f"/recommend/u{int(u)}?howMany={HOW_MANY}" for u in users]
        d0, c0 = batcher.dispatches, batcher.coalesced
        mark = quality_mark()  # the sampler at the layer's default rate
        t_burst, t_wall = time.monotonic(), time.time()
        T.reset_launches()  # the main path's window opens
        rows = http_burst(port, paths)
        torch.cuda.synchronize()
        launches = dict(T.LAUNCHES)  # ... and closes
        captures = burn_captures(
            config.get_string("oryx.monitoring.flight.dir"), t_wall)
        recs = [r for r in get_perfstats().records_since(t_burst)
                if r.kind == "serving"]
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
        check(len(recs) == dispatches,
              f"{len(recs)} dispatch records for {dispatches} dispatches")
        check(all(r.score_mode == mode and r.occupancy == 1.0 for r in recs),
              "a dispatch record with another mode or occupancy")
        cycle = dispatch_cycle(recs, get_perfattr(), batcher.timeline)
        check(0.0 < cycle["accounted_share"] <= 1.0 + 1e-9,
              f"dispatcher pieces overlap: share {cycle['accounted_share']}")
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
        healthz = json.loads(healthz)
        check("mfu" in healthz and healthz["mfu"] > 0,
              f"/healthz mfu {healthz.get('mfu')}")
        check(healthz.get("occupancy", {}).get("mean") == 1.0,
              f"/healthz occupancy {healthz.get('occupancy')}")
        check("serving-latency" in healthz.get("slo_burn", {}),
              f"/healthz slo_burn {healthz.get('slo_burn')}")
        budget = healthz.get("latency_budget", {}).get("phases", {})
        check("queue_wait" in budget and "device" in budget,
              f"latency budget phases {sorted(budget)}")
        quality = quality_read(port, mode, mark)
        quality_bursts = []
        if mode == "quantized":
            # the same burst with the sampler at 10%, then off: what the
            # shadow rescoring costs the host-bound dispatcher
            for rate in (0.1, 0.0):
                set_sample_rate(config, rate)
                mark_b = quality_mark()
                rows_b = http_burst(port, paths)
                check(all(r[1] == 200 for r in rows_b),
                      f"a non-200 answer at sample rate {rate}")
                wall_b = max(r[3] for r in rows_b) - min(r[2] for r in rows_b)
                quality_bursts.append({
                    "qps": len(rows_b) / wall_b,
                    **quality_read(port, mode, mark_b)})
            set_sample_rate(config, config.get_float(
                "oryx.monitoring.quality.sample-rate"))
        capture = None
        if mode == "quantized":
            # one /debug/profile window inside one more burst, untimed
            capture = profile_capture(port, paths)
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
            "dispatch_cycle": cycle,
            "burn_captures": captures,
            "budget_queue_wait": budget["queue_wait"],
            "budget_device": budget["device"],
            "healthz_mfu": healthz["mfu"],
            "healthz_occupancy": healthz["occupancy"],
            "slo_burn": healthz["slo_burn"],
            "latency_budget": healthz.get("latency_budget"),
            "quality": quality, "quality_bursts": quality_bursts,
            "debug_profile": capture,
            "profile": traced,
            "pref_to_input_topic": True, "up_served_after_s": up_s,
        }
    finally:
        layer.close()


def profile_capture(port: int, paths: list[str]) -> dict:
    """GET /debug/profile?seconds=2 while a burst runs: the dispatch
    records it holds and the torch.profiler trace it wrote."""
    got = {}

    def capture():
        got["response"] = http_get_full(port, "/debug/profile?seconds=2")

    t = threading.Thread(target=capture)
    t.start()
    time.sleep(0.2)
    rows = http_burst(port, paths)
    t.join(timeout=120)
    check("response" in got, "/debug/profile did not answer")
    status, _headers, body = got["response"]
    check(status == 200, f"/debug/profile answered {status}")
    check(all(r[1] == 200 for r in rows), "non-200 during the capture")
    meta = json.loads(body)["oryx"]
    check(meta["dispatch_records"] >= 1,
          f"the capture holds {meta['dispatch_records']} dispatch records")
    trace = meta["torch_trace_path"]
    check(trace is not None and Path(trace).is_file(),
          f"no torch trace at {trace}")
    with open(trace, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events
                  if e.get("cat") == "kernel" and "topk" in e.get("name", ""))
    check(kernels >= 1, "the torch trace holds no top-k kernel")
    return {"window_seconds": meta["window_seconds"],
            "dispatch_records": meta["dispatch_records"],
            "by_kind": meta["by_kind"], "torch_trace_path": trace,
            "trace_topk_kernels": kernels}


# ---------------------------------------------------------------------------
# phase 4a: LSH candidate sampling over HTTP
# ---------------------------------------------------------------------------

LSH_RATE = 0.3  # upstream Oryx's published setting (BASELINE.md:23)
LSH_REQUESTS = 512
LSH_QUALITY_RATE = 0.05  # each LSH sample rescores a fresh 1M x 50 snapshot


def lsh_phase(torch, np, T, path, model_data, users, exact_rows) -> dict:
    """The phase-3 model served with oryx.als.sample-rate = LSH_RATE: the
    candidate partitions are scored on the host (the mode's design in
    both packages; no device view is built). LSH_REQUESTS over HTTP, their
    recall@10 against the exact float64 ranking, the shadow sampler's
    live recall for "lsh", the same burst's qps with the sampler off, and
    the partition build's seconds. No recall floor: LSH trades recall for
    host work by construction."""
    from oryx_tpu_torch.serving.viewsync import view_sync_metrics

    rebuild = view_sync_metrics()[3]  # oryx_lsh_rebuild_seconds
    c0, s0 = rebuild.count(), rebuild.sum()
    layer, config, _b, _t, _u, start_s, ready_s = start_http_layer(
        "exact", path, extra={"oryx.als.sample-rate": LSH_RATE,
                              "oryx.monitoring.quality.sample-rate":
                              LSH_QUALITY_RATE})
    try:
        port = layer.port
        model = layer.model_manager.get_model()
        check(model._device_view is None and model._partition_view is not None,
              "the LSH model built a device view or no partition view")
        lsh = model._lsh
        sel = list(range(LSH_REQUESTS))
        paths = [f"/recommend/u{int(users[j])}?howMany={HOW_MANY}" for j in sel]
        mark = quality_mark()
        T.reset_launches()
        rows = http_burst(port, paths)
        launches = dict(T.LAUNCHES)
        check(len(rows) == len(paths), f"{len(rows)} answers to {len(paths)}")
        non_200 = sum(1 for r in rows if r[1] != 200)
        check(non_200 == 0, f"{non_200} non-200 LSH answers")
        known = model_data["known_idx"]
        hits = 0
        for j, _status, _t0, _t1, ids in rows:
            check(not set(ids) & {f"i{int(r)}" for r in known[users[j]]},
                  "a known item was served")
            hits += len(set(ids) & {f"i{int(r)}" for r in exact_rows[j]})
        wall = max(r[3] for r in rows) - min(r[2] for r in rows)
        lat = sorted((r[3] - r[2]) * 1e3 for r in rows)
        quality = quality_read(port, "lsh", mark)
        check(quality["samples"] > 0, "no LSH answer was shadow-sampled")
        # the same burst with the sampler off: each LSH sample copies the
        # whole 1M x 50 store for its exact reference
        set_sample_rate(config, 0.0)
        rows_off = http_burst(port, paths)
        check(all(r[1] == 200 for r in rows_off), "a non-200 LSH answer")
        wall_off = max(r[3] for r in rows_off) - min(r[2] for r in rows_off)
        lat_off = sorted((r[3] - r[2]) * 1e3 for r in rows_off)
        return {
            "phase": "lsh", "sample_rate": LSH_RATE, "items": N_ITEMS,
            "hashes": lsh.num_hashes, "partitions": lsh.num_partitions,
            "max_bits_differing": lsh.max_bits_differing,
            "candidate_partitions": len(lsh.candidate_indices(
                model_data["x"][int(users[0])])),
            "host_scorers": model._num_cores or os.cpu_count(),
            "start_s": start_s, "ready_s": ready_s,
            "requests": len(paths), "non_200": non_200,
            "qps": len(paths) / wall, "wall_s": wall,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "recall_at_10": hits / (HOW_MANY * len(rows)),
            "quality": quality,
            "sampler_off": {"qps": len(rows_off) / wall_off,
                            "p50_ms": lat_off[len(lat_off) // 2],
                            "p99_ms": lat_off[min(len(lat_off) - 1,
                                                  int(0.99 * len(lat_off)))]},
            "lsh_rebuilds": rebuild.count() - c0,
            "lsh_rebuild_seconds": rebuild.sum() - s0,
            "launches": launches,
        }
    finally:
        layer.close()


# ---------------------------------------------------------------------------
# phase 4b: the wedge watchdog over HTTP
# ---------------------------------------------------------------------------

WEDGE_FAULT_S = 5.0  # a dispatch stuck this long, past the 2 s timeout


def wedge_phase(torch, np, path, users) -> dict:
    """The serving layer again, with a batcher that declares a wedge after
    2 s and probes every 1 s. A one-shot 5 s latency fault at
    serving.device holds one dispatch: its request must get 503 with
    Retry-After, /healthz must report device-down while the card is down,
    /debug/flight must hold the health-degraded event, and once the probe
    recovers the card a burst must be all 200."""
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import TopicProducer, get_broker, topic_admin
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.faults import get_injector
    from oryx_tpu_torch.serving.batcher import TopKBatcher
    from oryx_tpu_torch.serving.server import ServingLayer

    broker = f"mem://chip-smoke-wedge-{next(_BROKERS)}"
    overlay = dict(app_overlay("als"))
    overlay.update({
        "oryx.update-topic.broker": broker,
        "oryx.input-topic.broker": broker,
        "oryx.serving.api.port": 0,
        "oryx.monitoring.flight.dir": str(SMOKE_BUILD / "smoke-flight-wedge"),
    })
    config = load_config(overlay=overlay)
    for w in ("input", "update"):
        topic_admin.maybe_create(
            broker, config.get_string(f"oryx.{w}-topic.message.topic"))
    saved = TopKBatcher._shared
    batcher = TopKBatcher(device_timeout=2.0, probe_interval=1.0)
    TopKBatcher._shared = batcher
    layer = ServingLayer(config)
    stop = threading.Event()
    seen: list = []
    try:
        layer.start()
        port = layer.port
        TopicProducer(get_broker(broker),
                      config.get_string("oryx.update-topic.message.topic")
                      ).send("MODEL-REF", path)
        t0 = time.monotonic()
        while http_get(port, "/ready")[0] != 200:
            check(time.monotonic() - t0 < 600, "wedge phase: never ready")
            time.sleep(0.05)
        probe_paths = [f"/recommend/u{int(u)}?howMany={HOW_MANY}"
                       for u in users[:8]]
        for p in probe_paths:
            check(http_get(port, p)[0] == 200, "wedge phase: warm-up failed")

        def poll():
            while not stop.is_set():
                status, body = http_get(port, "/healthz")
                seen.append((time.monotonic(), status,
                             json.loads(body).get("degraded", [])))
                time.sleep(0.05)

        poller = threading.Thread(target=poll)
        poller.start()
        get_injector().arm("serving.device", kind="latency",
                           latency_s=WEDGE_FAULT_S)
        t_stuck = time.monotonic()
        status, headers, body = http_get_full(port, probe_paths[0])
        stuck_s = time.monotonic() - t_stuck
        check(status == 503, f"the stuck request answered {status}: {body!r}")
        retry_after = headers.get("Retry-After")
        check(retry_after is not None, "the 503 carries no Retry-After")
        check(batcher.device_failovers == 1,
              f"{batcher.device_failovers} failovers")
        deadline = time.monotonic() + 30
        while batcher._device_down.is_set() or not any(
                "device-down" in d for _t, _s, d in seen):
            check(time.monotonic() < deadline, "the card never came back")
            time.sleep(0.02)
        recovered_s = time.monotonic() - t_stuck
        stop.set()
        poller.join(timeout=60)
        down = [(t, s) for t, s, d in seen if "device-down" in d]
        check(down and all(s == 503 for _t, s in down),
              "/healthz never reported device-down with 503")
        events = []
        deadline = time.monotonic() + 30
        while not any(e["kind"] == "health-degraded" for e in events):
            check(time.monotonic() < deadline,
                  "/debug/flight holds no health-degraded event")
            status, body = http_get(port, "/debug/flight")
            check(status == 200, f"/debug/flight answered {status}")
            events = json.loads(body)["events"]
            time.sleep(0.1)
        wedge_events = [e.get("state") for e in events if e["kind"] == "wedge"]
        check("wedged" in wedge_events, f"wedge events {wedge_events}")
        rows = http_burst(port, [probe_paths[j % len(probe_paths)]
                                 for j in range(256)])
        non_200 = sum(1 for r in rows if r[1] != 200)
        check(non_200 == 0, f"{non_200} non-200 answers after recovery")
        return {
            "phase": "wedge", "device_timeout_s": batcher.device_timeout,
            "probe_interval_s": batcher.probe_interval,
            "fault_latency_s": WEDGE_FAULT_S, "stuck_request_status": 503,
            "retry_after": retry_after, "stuck_request_s": stuck_s,
            "healthz_device_down_polls": len(down),
            "device_down_s": max(t for t, _s in down) - min(t for t, _s in down),
            "recovered_after_s": recovered_s,
            "flight_events": sorted({e["kind"] for e in events}),
            "wedge_events": wedge_events,
            "failovers": batcher.device_failovers,
            "burst_after_recovery": len(rows), "non_200_after": non_200,
        }
    finally:
        stop.set()
        get_injector().disarm()
        layer.close()
        batcher.close()
        TopKBatcher._shared = saved


# ---------------------------------------------------------------------------
# phase 5: train (the batch layer's trainer at the north-star shape)
# ---------------------------------------------------------------------------

# the bench's north star (bench.py:1203-1215): ML-25M shape, 50 features,
# 10 sweeps; and its 1M warm-up shape (bench.py:1184)
TRAIN_SHAPE = (162_000, 59_000, 25_000_000)
SMALL_SHAPE = (6_000, 3_700, 1_000_000)
# phase 6's loop: SMALL_SHAPE's users and items, its events cut from 1M to
# 500,000 to leave the time phases 5c and 11 take: with 1M events (and the
# seq burst at 2,048) the whole smoke took 1,013.9 s on an H100 80GB HBM3
# at 700 W against the 950 s it is held to, phase 6 46.1 s of that more
# than at 500,000 (at 250,000 the delta generation's window passes
# max-drift-fraction of the state)
LAMBDA_SHAPE = (6_000, 3_700, 500_000)
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
# phase 5b: the multi-device trainer and the collectives on one card
# ---------------------------------------------------------------------------

MESH_SHAPE = (2, 2)  # (data, model) cells, all on the one card
# tests/test_torch_als_tp.py's tolerance, at its sweep count: the sums run
# in another order, and each sweep carries the last one's rounding on (at
# 10 sweeps on an H100, one factor of 299,900 lay 2.33e-4 from the
# single-device one, past the 2.22e-4 allowed)
MESH_TOL = {"rtol": 2e-3, "atol": 2e-4}
MESH_SWEEPS = 5
MESH_AUC_GAP = 0.005
# At the batch layer's depth (TRAIN_HP["iterations"]) the TP trainer is
# held to a float64 run from the same Y (als_probe.f64_reference): at most
# twice as far from it as the single-device trainer. Rounding grows with
# the sweeps at lambda 0.01 for both trainers alike, and either may lie
# nearer (als_probe tp on an H100: at 10 sweeps TP lay 0.52-0.59x as far
# from float64 as single-device did, the two 5.1e-4 apart; at 20 sweeps
# 1.2e-2 apart, 0.67-1.13x; 1.13x at 600 x 370 x 20,000 on a CPU).
MESH_WITNESS_RATIO = 2.0


def mesh_train_phase(torch, np, shape=SMALL_SHAPE, device="cuda") -> dict:
    """train_als_tp on a (2, 2) mesh over the card at the 1M shape, 50
    features, MESH_SWEEPS sweeps, against single-device train_als from the
    same resume_y: the factors within MESH_TOL (the CPU parity test's
    tolerance at its sweep count) and the held-out AUC within
    MESH_AUC_GAP. Then both at the batch layer's 10 sweeps beside a
    float64 run: the TP factors at most MESH_WITNESS_RATIO times as far
    from it as the single-device ones, and the AUC within MESH_AUC_GAP."""
    from oryx_tpu_torch.ml.quality import holdout_auc
    from oryx_tpu_torch.ml.synth import synthesize_interactions
    from oryx_tpu_torch.ops.als import aggregate_interactions, train_als, train_als_tp
    from oryx_tpu_torch.ops.als_probe import f64_reference
    from oryx_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    n_u, n_i, nnz = shape
    k = TRAIN_HP["features"]
    users, items, values = synthesize_interactions(n_u, n_i, nnz,
                                                   seed=TRAIN_HP["seed"])
    rng = np.random.default_rng(TRAIN_HP["seed"] + 1_000_003)
    test_mask = rng.random(nnz) < TRAIN_HP["holdout_p"]
    tr = ~test_mask
    data = aggregate_interactions(users[tr], items[tr], values[tr], implicit=True)
    y0 = (np.random.default_rng(SEED + 7).standard_normal((data.n_items, k))
          * 0.1 + 1 / np.sqrt(k)).astype(np.float32)
    kw = dict(features=k, lam=TRAIN_HP["lam"], alpha=TRAIN_HP["alpha"],
              iterations=MESH_SWEEPS, implicit=True, resume_y=y0)
    mesh = make_mesh(MeshSpec(*MESH_SHAPE), [torch.device(device)] * 4)
    one_t, tp_t = {}, {}
    one = train_als(data, device=device, timings=one_t, **kw)
    tp = train_als_tp(data, mesh, timings=tp_t, **kw)
    # both models scored on the same users and the same sampled negatives
    # (auc_mean_per_user draws them from RandomManager.get_random)
    from oryx_tpu_torch.common.rng import RandomManager

    def aucs(models):
        auc, draw = {}, RandomManager.get_random
        try:
            for name, model in models:
                RandomManager.get_random = classmethod(
                    lambda cls: np.random.default_rng(SEED + 12))
                auc[name] = float(holdout_auc(
                    model, users, items, test_mask,
                    np.random.default_rng(TRAIN_HP["seed"] + 11)))
        finally:
            RandomManager.get_random = draw
        return auc

    auc = aucs((("single", one), ("tp", tp)))
    dx, dy = np.abs(tp.x - one.x), np.abs(tp.y - one.y)
    out = {"phase": "train-mesh", "mesh": list(MESH_SHAPE),
           "shape": {"users": n_u, "items": n_i, "interactions": nnz,
                     "features": k, "sweeps": MESH_SWEEPS},
           "single_train_s": one_t["train_s"], "tp_train_s": tp_t["train_s"],
           "tp_lists_s": tp_t["lists_s"],
           "max_abs_dx": float(dx.max()), "max_abs_dy": float(dy.max()),
           "auc": auc, "tol": MESH_TOL}
    np.testing.assert_allclose(tp.x, one.x, **MESH_TOL)
    np.testing.assert_allclose(tp.y, one.y, **MESH_TOL)
    check(abs(auc["tp"] - auc["single"]) <= MESH_AUC_GAP,
          f"tensor-parallel AUC {auc['tp']} vs single-device {auc['single']}")
    check(auc["tp"] >= MIN_AUC, f"tensor-parallel AUC {auc['tp']} < {MIN_AUC}")

    deep = dict(kw, iterations=TRAIN_HP["iterations"])
    one, tp = train_als(data, device=device, **deep), train_als_tp(data, mesh, **deep)
    t0 = time.monotonic()
    x64, y64, f64_failed = f64_reference(
        data, y0, lam=TRAIN_HP["lam"], alpha=TRAIN_HP["alpha"],
        iterations=TRAIN_HP["iterations"], device=device)
    dist = {name: max(float(np.abs(m.x - x64).max()), float(np.abs(m.y - y64).max()))
            for name, m in (("single", one), ("tp", tp))}
    auc = aucs((("single", one), ("tp", tp)))
    out["deep"] = {
        "sweeps": TRAIN_HP["iterations"], "f64_s": time.monotonic() - t0,
        "f64_failed_rows": f64_failed, "max_abs_d_to_f64": dist,
        "max_abs_d_tp_single": max(float(np.abs(tp.x - one.x).max()),
                                   float(np.abs(tp.y - one.y).max())),
        "ratio": MESH_WITNESS_RATIO, "auc": auc}
    check(f64_failed == 0, f"{f64_failed} rows failed in float64")
    check(dist["tp"] <= MESH_WITNESS_RATIO * dist["single"],
          f"TP factors {dist['tp']} from float64, single-device {dist['single']}")
    check(abs(auc["tp"] - auc["single"]) <= MESH_AUC_GAP,
          f"10-sweep TP AUC {auc['tp']} vs single-device {auc['single']}")
    return out


COLLECTIVES = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.ops.vector import gram
from oryx_tpu_torch.parallel.distributed import (
    barrier, global_mesh, host_allgather, host_broadcast_bytes,
    init_distributed, shutdown_distributed)
from oryx_tpu_torch.parallel.mesh import DATA_AXIS, MeshSpec, split_rows

rank, port = int(sys.argv[2]), sys.argv[3]
assert init_distributed(load_config(overlay={
    "oryx.compute.distributed.coordinator-address": f"localhost:{port}",
    "oryx.compute.distributed.num-processes": 2,
    "oryx.compute.distributed.process-id": rank}))
card = torch.device("cuda:0")
mesh = global_mesh(MeshSpec(data=2, model=2), [card, card])
host = torch.from_numpy(np.random.default_rng(3).standard_normal(
    (4096, 50)).astype(np.float32))
blocks = split_rows(host.to(card), mesh, DATA_AXIS)
g = mesh.psum({c: gram(blocks.block(*c)) for c in mesh.cells()}, DATA_AXIS)
want = gram(host.to(card))
for c in mesh.cells():
    assert g[c].device == card
    err = (g[c] - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item(), err
barrier("smoke")
assert host_allgather(np.asarray([rank, 7])).tolist() == [[0, 7], [1, 7]]
assert host_broadcast_bytes(b"from-0" if rank == 0 else None, 0) == b"from-0"
shutdown_distributed()
print("COLLECTIVES_OK", rank, err, flush=True)
"""


def collectives_phase(torch) -> dict:
    """Two ranks sharing the card (so gloo: NCCL takes one rank per card):
    a Gram sum across the process boundary over CUDA tensors against the
    exact local Gram, a barrier, a host all-gather and a broadcast."""
    from oryx_tpu_torch.common.executil import free_port_run
    from oryx_tpu_torch.parallel.distributed import default_backend

    repo = str(Path(__file__).resolve().parent)
    port = free_port_run(1)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", COLLECTIVES, repo, str(r), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"COLLECTIVES_OK {r}" in text,
              f"collectives rank {r} exited {p.returncode}: {text[-2000:]}")
    errs = [float(t.split(f"COLLECTIVES_OK {r} ")[1].split()[0])
            for r, t in enumerate(outs)]
    return {"phase": "collectives", "ranks": 2, "backend": default_backend(2),
            "devices": "cuda:0 shared", "gram_max_abs_err": errs,
            "seconds": time.monotonic() - t0}


# ---------------------------------------------------------------------------
# phase 5c: sequence-parallel attention and the multi-device dry run
# ---------------------------------------------------------------------------

ATTN_SHAPE = (1, 8, 16_384, 128)  # B, H, S, D; f32
ATTN_CELLS = 4  # the "data" axis the sequence splits over, all on the card
ATTN_ROWS = 64  # seeded query rows held to a float64 computation
# f32 products (TF32 off) and an f32 softmax against float64: the JAX
# package's attention tests hold the ring to the exact path at 2e-5
ATTN_TOL = {"atol": 2e-5, "rtol": 2e-5}
DRYRUN_CELLS = 4


def attention_rows_f64(torch, q, k, v, rows, causal: bool):
    """Float64 attention of query rows ``rows`` against every key."""
    q64 = q[..., rows, :].double()
    s = torch.matmul(q64, k.double().transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    if causal:
        cols = torch.arange(k.shape[-2], device=s.device)
        keep = cols[None, :] <= torch.as_tensor(rows, device=s.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v.double())


def attention_phase(torch, np, shape=ATTN_SHAPE, cells=ATTN_CELLS,
                    rows=ATTN_ROWS, dryrun_cells=DRYRUN_CELLS,
                    device="cuda") -> dict:
    """Phase 5c: ring and Ulysses attention (ops/attention.py) with the
    sequence over a data axis of ``cells`` cells on the card, causal and
    not, TF32 off, each call timed (host clock around a synchronised call,
    after one warm-up call) with its peak card memory, beside the exact
    path's; all three held against float64 on ``rows`` seeded query rows.
    Then dryrun_multichip over ``dryrun_cells`` cells on the card."""
    from oryx_tpu_torch.dryrun import dryrun_multichip
    from oryx_tpu_torch.ops.attention import attention, ring_attention, ulysses_attention
    from oryx_tpu_torch.parallel.mesh import DATA_AXIS, MeshSpec, make_mesh

    cuda = device == "cuda"
    b, h, s, d = shape
    out = {"phase": "attention", "shape": {"B": b, "H": h, "S": s, "D": d},
           "dtype": "float32", "cells": cells, "rows_checked": rows,
           "tolerance": ATTN_TOL, "tf32": torch.backends.cuda.matmul.allow_tf32}
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    mesh = make_mesh(MeshSpec(cells, 1), [device] * cells)
    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    q, k, v = (torch.randn(shape, generator=g).to(device) for _ in range(3))
    picked = sorted(np.random.default_rng(SEED + 40).choice(s, rows, replace=False).tolist())

    def whole(res):
        if isinstance(res, torch.Tensor):
            return res
        return mesh.all_gather(res.shards, DATA_AXIS, dim=res.dim)[mesh.cells()[0]]

    calls = {"exact": lambda c: attention(q, k, v, causal=c),
             "ring": lambda c: ring_attention(q, k, v, mesh, causal=c),
             "ulysses": lambda c: ulysses_attention(q, k, v, mesh, causal=c)}
    for causal in (False, True):
        ref = attention_rows_f64(torch, q, k, v, picked, causal)
        line = {}
        for name, fn in calls.items():
            fn(causal)  # warm-up
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = fn(causal)
            if cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
            got = whole(res)[..., picked, :].double()
            del res
            err = (got - ref).abs()
            lim = ATTN_TOL["atol"] + ATTN_TOL["rtol"] * ref.abs()
            line[name] = {"ms": ms, "peak_mem_bytes": peak,
                          "max_abs_err": float(err.max()),
                          "worst_err_over_tol": float((err / lim).max())}
            check(bool((err <= lim).all()),
                  f"{name} attention (causal={causal}) off float64 by "
                  f"{float(err.max())}")
        out["causal" if causal else "full"] = line
    del q, k, v
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    dry = dryrun_multichip(dryrun_cells, device=device)
    out["dryrun"] = {**dry, "seconds": time.monotonic() - t0}
    return out


# ---------------------------------------------------------------------------
# phase 6: the lambda loop (batch -> serving -> speed -> batch) on one bus
# ---------------------------------------------------------------------------

LAMBDA_USERS = 64          # /recommend probes against the exact top-10
# the update topic's max message size in the loop: a generation's model
# message (the ALS skeleton: ids, hyperparameters, training profile; ~80
# KB at 6,000 users x 3,700 items) goes out as MODEL-CHUNKs + MODEL-REF
LAMBDA_MAX_MESSAGE = 16 << 10
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


def generation_served(port: int, layer, generation: int, t0: float,
                      limit_s: float = 120) -> float:
    """Seconds from t0 until /healthz names ``generation`` as served and
    the served view has caught up with the model state."""
    while time.monotonic() - t0 < limit_s:
        hz = json.loads(http_get(port, "/healthz")[1])
        model = layer.model_manager.get_model()
        if (hz.get("model_generation") == generation and model is not None
                and model.served_version() == model.state.y.get_version()):
            return time.monotonic() - t0
        time.sleep(0.02)
    raise AssertionError(f"generation {generation} not served in {limit_s} s")


def http_json(port: int, path: str, doc: dict) -> dict:
    """POST a JSON body; the JSON answer (which must be 200)."""
    status, body = http_get(port, path, "POST", json.dumps(doc).encode())
    check(status == 200, f"POST {path} answered {status}: {body[:200]}")
    return json.loads(body)


def lambda_phase(torch, np, T, root: Path, device="cuda",
                 shape=LAMBDA_SHAPE, speed_events=SPEED_EVENTS,
                 delta_events=DELTA_EVENTS) -> dict:
    """Phase 6: the whole loop on one file:// bus with the als app's
    classes (apps/spi.py), each layer built from config."""
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.apps.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.apps.als.state import state_from_arrays
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import (
        ConsumeDataIterator, TopicProducer, get_broker, topic_admin)
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
        "oryx.monitoring.flight.dir": f"file://{root / 'flight'}",
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
        "oryx.update-topic.message.max-size": LAMBDA_MAX_MESSAGE,
        "oryx.update-topic.artifact-transfer": True,
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

        # c. serving on the same topics, with the batch layer's model
        # directory moved away: the model reaches it through the artifact
        # relay alone (the MODEL-CHUNKs ahead of the MODEL-REF)
        model_root = root / "model"
        model_root.rename(root / "model-away")
        serving = ServingLayer(
            cfg, model_manager=ALSServingModelManager(cfg, device="cpu")
            if cpu else None)
        layers.append(serving)
        serving.start()
        port = serving.port
        wait_ready(port, t_published)
        out["publish_to_ready_s"] = time.monotonic() - t_published
        (root / "model-away").rename(model_root)
        with ConsumeDataIterator(get_broker(bus), topics["update"],
                                 start="earliest") as it:
            keys = [km.key for km in it.poll_available()]
        out["relay"] = {"max_message_bytes": LAMBDA_MAX_MESSAGE,
                        "chunks": keys.count("MODEL-CHUNK"),
                        "model_refs": keys.count("MODEL-REF"),
                        "publish_to_ready_s": out["publish_to_ready_s"]}
        check(keys.count("MODEL-CHUNK") > 1 and keys.count("MODEL-REF") == 1,
              f"generation 1 was not chunked: {out['relay']}")

        # d. /recommend against the exact top-10 of the published factors
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
        # the batch stamped its training profile into the artifact and the
        # speed layer fed this process's live input sketch: the drift
        # gauges are finite
        _s, body = http_get(port, "/healthz")
        quality = json.loads(body)["quality"]
        out["quality"] = quality
        drift = quality.get("input_drift", {})
        check(len(drift) == 3 and all(
            isinstance(v, (int, float)) for v in drift.values()),
            f"input drift gauges not finite: {quality}")
        speed.close()
        layers.remove(speed)

        # the model gate: a second serving layer in hold mode replays the
        # topic (an unarmed gate adopts generation 1), then is armed at it
        serving.close()
        layers.remove(serving)
        gated_cfg = cfg.overlay({"oryx.serving.model-gate.mode": "hold"})
        t0 = time.monotonic()
        serving = ServingLayer(
            gated_cfg, model_manager=ALSServingModelManager(
                gated_cfg, device="cpu") if cpu else None)
        layers.append(serving)
        serving.start()
        port = serving.port
        wait_ready(port, t0)
        gate = {"ready_s": time.monotonic() - t0,
                "arm": http_json(port, "/control/model/approve",
                                 {"generation": ts})}
        check(gate["arm"]["generation"] == ts, f"gate not armed: {gate}")

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

        # h. the gate holds the new generation's MODEL-REF; approve adopts
        # it and a rollback re-adopts generation 1's. The ALS model
        # message is a skeleton (ids, hyperparameters, the training
        # profile): the factor rows stream as UP rows, which the gate
        # does not hold, so each step's recall is printed against both
        # generations' factors
        t0 = time.monotonic()
        while time.monotonic() - t0 < 120:
            held = json.loads(http_get(port, "/healthz")[1])
            if held.get("model_gate", {}).get("pending_generation") == ts + 1:
                break
            time.sleep(0.05)
        check(held["model_gate"]["pending_generation"] == ts + 1
              and held["model_generation"] == ts,
              f"generation 2 not held: {held.get('model_gate')}")
        gate["held"] = held["model_gate"]
        models = {g: published_factors(np, model_root, g) for g in (ts, ts + 1)}

        def recalls() -> dict:
            got = {f"vs_generation_{g - ts + 1}": served_recall(
                np, port, m, probe) for g, m in models.items()}
            return {k: None if v is None else v[1] for k, v in got.items()}

        gate["recall_at_10_held"] = recalls()
        for step, target, doc in (
                ("approve", ts + 1, {"generation": ts + 1}),
                ("rollback", ts, {"reason": "smoke"})):
            t0 = time.monotonic()
            gate[step] = http_json(port, f"/control/model/{step}", doc)
            gate[f"{step}_post_s"] = time.monotonic() - t0
            gate[f"{step}_to_served_s"] = generation_served(
                port, serving, target, t0)
            gate[f"recall_at_10_after_{step}"] = recalls()
        recall2 = gate["recall_at_10_after_approve"]["vs_generation_2"]
        out["generation_2_served_after_s"] = gate["approve_to_served_s"]
        out["recall_at_10_generation_2"] = recall2
        check(recall2 == 1.0, f"generation 2 not served: recall {recall2}")
        gate["healthz"] = json.loads(http_get(port, "/healthz")[1])["model_gate"]
        out["gate"] = gate
        check(gate["healthz"]["vetoed"] == [ts + 1]
              and gate["healthz"]["generations"] == [ts],
              f"gate after rollback: {gate['healthz']}")
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


# ---------------------------------------------------------------------------
# phase 10: the deployment over kafka:// through the CLI (after phase 6)
# ---------------------------------------------------------------------------

KAFKA_MAX_MESSAGE = 16 << 10  # the update topic's: the model goes out chunked
# phase 6's users and items, its events cut from 1M to 250,000 to make room
# for the fleet leg
KAFKA_SHAPE = (6_000, 3_700, 250_000)
KAFKA_PARTITIONS = {"input": 4, "update": 1}  # the reference's
KAFKA_REPLICAS = 2
KAFKA_BATCH_INTERVAL_S = 5  # the first generation starts this long after batch
KAFKA_BURST = 2048
KAFKA_SPEED_EVENTS = 20_000
KAFKA_TAIL_S = 2
WORDCOUNT_LINES = 10_000
PMML_CENTERS = (100, 20)  # k-means centers x dimensions
PMML_ASSIGN = 256


def load_test_broker():
    """tests/torch_kafka_testbroker.py, by path (the tests are no package
    the smoke imports)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "torch_kafka_testbroker.py"
    spec = importlib.util.spec_from_file_location("torch_kafka_testbroker", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def foreign_batch(wire, lines: list, codec: int, compress) -> bytes:
    """A record batch as a foreign producer writes it (null keys, the codec
    in the attributes, CRC-32C over attributes..end; the layout of
    tests/test_kafka.py's _foreign_batch)."""
    body = wire.Writer()
    for i, line in enumerate(lines):
        value = line.encode()
        rec = (wire.Writer().i8(0).varint(i * 17).varint(i).varint(-1)
               .varint(len(value)).raw(value).varint(0).done())
        body.varint(len(rec)).raw(rec)
    n = len(lines)
    crced = (wire.Writer().i16(codec).i32(n - 1).i64(1_700_000_000_000)
             .i64(1_700_000_000_000 + (n - 1) * 17).i64(-1).i16(-1).i32(-1)
             .i32(n).raw(compress(body.done())).done())
    after = wire.Writer().i32(-1).i8(2).u32(wire.crc32c(crced)).raw(crced).done()
    return wire.Writer().i64(0).i32(len(after)).raw(after).done()


def snappy_literals(data: bytes) -> bytes:
    """Valid snappy of literal elements only (what a lazy compressor may
    emit): the uncompressed length as a uvarint, then 60-byte literals."""
    out, n = bytearray(), len(data)
    while True:
        out.append((n & 0x7F) | (0x80 if n >> 7 else 0))
        n >>= 7
        if not n:
            break
    for pos in range(0, len(data), 60):
        chunk = data[pos:pos + 60]
        out.append((len(chunk) - 1) << 2)
        out += chunk
    return bytes(out)


def replica_scrape(port: int, want: int, limit_s: float = 60) -> dict:
    """{replica name: {"pid", "healthz", "launches", "by_type"}} of every
    replica behind the shared port: /healthz and /metrics on one
    keep-alive connection reach one replica; new connections spread
    across the replicas (SO_REUSEPORT)."""
    import http.client
    import re

    pat = re.compile(r'oryx_cuda_kernel_launches_total\{kernel="(\w+)",type="(\w+)"\} (\S+)')
    seen: dict = {}
    t0 = time.monotonic()
    while len(seen) < want and time.monotonic() - t0 < limit_s:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            c.request("GET", "/healthz")
            r = c.getresponse()
            hz = json.loads(r.read())
            c.request("GET", "/metrics")
            text = c.getresponse().read().decode()
        except (OSError, ValueError):
            time.sleep(0.1)
            continue
        finally:
            c.close()
        launches = {"topk_dot_partial": 0, "topk_merge": 0}
        by_type = {"float32": 0, "bfloat16": 0, "int8": 0}
        for kernel, typ, v in pat.findall(text):
            launches[kernel] += int(float(v))
            if kernel == "topk_dot_partial":
                by_type[typ] = int(float(v))
        seen[hz.get("replica")] = {"healthz": hz, "launches": launches,
                                   "by_type": by_type}
    check(len(seen) == want, f"reached replicas {sorted(seen)}, not {want}")
    return seen


class TopicLog:
    """The records of partition 0 of one topic, pulled incrementally."""

    def __init__(self, broker, topic: str):
        self.broker, self.topic, self.rows = broker, topic, []

    def pull(self) -> list:
        """The records that arrived since the last pull."""
        new = []
        while True:
            at = self.rows[-1][0] + 1 if self.rows else 0
            recs = self.broker.read(self.topic, 0, at, 10_000)
            if not recs:
                return new
            self.rows.extend(recs)
            new.extend(recs)

    def keys(self) -> list:
        return [k for _, k, _ in self.rows]


def on_one_replica(port: int, path: str) -> tuple:
    """(replica name, status, body) of GET /healthz and then GET path on
    one keep-alive connection, so one replica answers both; (None, None,
    None) while nothing listens."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", "/healthz")
        hz = json.loads(c.getresponse().read())
        c.request("GET", path, headers={"Accept": "application/json"})
        r = c.getresponse()
        return hz.get("replica"), r.status, r.read()
    except (OSError, ValueError):
        return None, None, None
    finally:
        c.close()


def compute_apps() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def plain_wordcount(lines: list) -> dict:
    """Per word, how many distinct other words share a line with it."""
    others: dict = {}
    for line in lines:
        words = set(line.split())
        for w in words:
            others.setdefault(w, set()).update(words - {w})
    return {w: len(o) for w, o in others.items() if o}


# -- phase 10's fleet leg: `cli fleet` over card replicas at 500k x 50 -------

FLEET_REPLICAS = 2
# the fleet's catalog: the serving catalog's users and width, its items
# cut from 1M to 500,000 to fit phases 5c and 11 (each of the leg's four
# generations is published, deflated, fetched and loaded at this size)
FLEET_SHAPE = (500_000, N_USERS, FEATURES)
FLEET_SHARDS = 2  # the exact fleet's device-view shards per replica
FLEET_PROBE_S = 0.5  # the front's /healthz probe interval in this leg
FLEET_CLIENTS = 2  # in-process client threads behind the kill and canary legs
FLEET_CANARY = {  # the canary leg's replica and controller settings
    "oryx.serving.api.score-mode": "quantized",
    "oryx.fleet.canary.enabled": True,
    "oryx.fleet.canary.traffic-fraction": 0.5,
    "oryx.fleet.canary.min-samples": 8,
    # the verdict must be the quality gate's: a replica's first requests
    # after a generation swap are slow and must not trip the latency leg
    "oryx.fleet.canary.max-latency-burn": 1e9,
    "oryx.fleet.canary.hold-timeout-sec": 240,
    "oryx.monitoring.quality.sample-rate": 1.0,
    "oryx.monitoring.quality.window-sec": 60,
    "oryx.monitoring.quality.alarm-burn-rate": 5,
    "oryx.monitoring.slo.quality.objective": 0.95,
    "oryx.monitoring.slo.quality.recall-floor": 0.9,
    "oryx.monitoring.slo.fast-window-sec": 60,
}
FLEET_LIMIT_S = 300  # any one wait of the leg


def canary_artifact(np, gen: int, items: int, users: int, features: int,
                    corrupted: bool):
    """A generation of the canary leg, built as tools/chaos.py's
    degraded-model generations are: X[:, 0] = 0, and Y[:, 0] = 0 (clean)
    or +-1000 (corrupted: the huge coordinate sets every row's int8 scale,
    so the quantized scan sees ties while the exact scores are untouched)."""
    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(gen)
    x = rng.standard_normal((users, features), dtype=np.float32)
    x[:, 0] = 0.0
    y = rng.standard_normal((items, features), dtype=np.float32)
    y[:, 0] = (1000.0 * rng.choice(np.array([-1.0, 1.0], np.float32), size=items)
               if corrupted else 0.0)
    art = ModelArtifact("als", tensors={"X": x, "Y": y})
    art.set_extension("features", str(features))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", [f"u{j}" for j in range(users)])
    art.set_extension("YIDs", [f"i{j}" for j in range(items)])
    return art


def write_fleet_generation(gen: int, items: int, users: int, features: int,
                           path: str) -> None:
    """The serialized artifact of one generation of the fleet leg, to
    ``path`` (run in a process of its own, so the three serialize at once),
    with the batch layer's own serializer."""
    import numpy as np

    art = (model_artifact(np, items, users, features)[0] if gen == 1 else
           canary_artifact(np, gen, items, users, features, corrupted=gen == 3))
    Path(path).write_text(art.to_string())


FLEET_WRITER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.write_fleet_generation(*map(int, sys.argv[2:6]), sys.argv[6])
"""


class FleetTraffic:
    """Client threads sending GET /recommend through the front on
    keep-alive connections, counting answers: 200, a shed (503 with
    Retry-After), any other 5xx, anything else, and transport errors."""

    def __init__(self, port: int, paths: list, threads: int = FLEET_CLIENTS):
        self.port, self.paths = port, paths
        self.counts = {"ok": 0, "shed": 0, "non_shed_5xx": 0, "other": 0,
                       "client_error": 0}
        self.lock = threading.Lock()
        self.go = threading.Event()
        self.stopped = threading.Event()
        self.busy = 0
        self.threads = [threading.Thread(target=self._run, args=(w, threads),
                                         daemon=True) for w in range(threads)]
        for t in self.threads:
            t.start()

    def _run(self, w: int, n: int) -> None:
        import http.client

        conn, j = None, w
        while not self.stopped.is_set():
            if not self.go.wait(0.05):
                continue
            with self.lock:
                self.busy += 1
            try:
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                      timeout=120)
                conn.request("GET", self.paths[j % len(self.paths)],
                             headers={"Accept": "application/json"})
                r = conn.getresponse()
                shed = r.getheader("Retry-After") is not None
                r.read()
                key = ("ok" if r.status == 200 else
                       "shed" if r.status == 503 and shed else
                       "non_shed_5xx" if r.status >= 500 else "other")
            except (OSError, http.client.HTTPException):
                key = "client_error"
                if conn is not None:
                    conn.close()
                conn = None
            with self.lock:
                self.counts[key] += 1
                self.busy -= 1
            j += n

    def pause(self) -> None:
        """Stop sending; return once no request is in flight."""
        self.go.clear()
        while True:
            with self.lock:
                if self.busy == 0:
                    return
            time.sleep(0.01)

    def snapshot(self) -> dict:
        with self.lock:
            return dict(self.counts)

    def close(self) -> dict:
        self.pause()
        self.stopped.set()
        for t in self.threads:
            t.join(timeout=30)
        return self.snapshot()


def fleet_metrics(port: int) -> dict:
    """{replica: {"launches", "by_type", "dist_bytes"}} from the front's
    federated /fleet/metrics (every routable replica's /metrics with a
    replica label)."""
    import re

    status, body = http_get(port, "/fleet/metrics")
    check(status == 200, f"/fleet/metrics answered {status}")
    out: dict = {}
    sample = re.compile(r"^(\w+)\{([^}]*)\} (\S+)")
    for line in body.decode().splitlines():
        m = sample.match(line)
        if m is None:
            continue
        name, labels = m.group(1), dict(re.findall(r'(\w+)="([^"]*)"', m.group(2)))
        rep = out.setdefault(labels.get("replica"), {
            "launches": {"topk_dot_partial": 0, "topk_merge": 0},
            "by_type": {"float32": 0, "bfloat16": 0, "int8": 0},
            "dist_bytes": 0.0})
        if name == "oryx_cuda_kernel_launches_total":
            rep["launches"][labels["kernel"]] += int(float(m.group(3)))
            if labels["kernel"] == "topk_dot_partial":
                rep["by_type"][labels["type"]] += int(float(m.group(3)))
        elif name == "oryx_fleet_distribution_bytes":
            rep["dist_bytes"] += float(m.group(3))
    return out


def front_answers(port: int) -> dict:
    """The front's oryx_fleet_front_requests_total by replica that answered
    (its own /metrics)."""
    import re

    _, body = http_get(port, "/metrics")
    pat = re.compile(r'oryx_fleet_front_requests_total\{replica="([^"]*)"\} (\S+)')
    return {r: float(v) for r, v in pat.findall(body.decode())}


def front_gauge(port: int, name: str) -> dict:
    """{replica: value} of one per-replica series on the front's own
    /metrics."""
    import re

    _, body = http_get(port, "/metrics")
    pat = re.compile(name + r'\{replica="([^"]*)"\} (\S+)')
    return {r: float(v) for r, v in pat.findall(body.decode())}


def fleet_status(port: int) -> dict:
    status, body = http_get(port, "/fleet/status")
    check(status == 200, f"/fleet/status answered {status}")
    return {r["id"]: r for r in json.loads(body)["replicas"]}


def wait_for(what: str, pred, alive, limit_s: float = FLEET_LIMIT_S,
             every: float = 0.05) -> float:
    """Poll ``pred`` until true; the seconds it took. Fails past the limit
    or when a process of the phase died."""
    t0 = time.monotonic()
    while True:
        alive(what)
        if pred():
            return time.monotonic() - t0
        check(time.monotonic() - t0 < limit_s, f"{what}: not within {limit_s} s")
        time.sleep(every)


def replica_pid(fleet_pid: int, rid: str) -> int:
    """The pid of the fleet's replica ``rid`` (its command line names it)."""
    kids = subprocess.run(["pgrep", "-P", str(fleet_pid)], capture_output=True,
                          text=True).stdout.split()
    for pid in kids:
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if f"oryx.fleet.replica.id={rid}".encode() in cmd:
            return int(pid)
    raise AssertionError(f"no process of replica {rid} under {fleet_pid}: {kids}")


def fleet_leg(torch, np, root: Path, srv, broker, start, stop, alive,
              device="cuda", shape=FLEET_SHAPE,
              burst=N_REQUESTS) -> dict:
    """`python -m oryx_tpu_torch.cli fleet --replicas 2 --policy hash` on the
    card at the serving catalog's width, its model published as MODEL-CHUNKs
    + MODEL-REF on a kafka:// topic of phase 10's broker: a timed exact
    burst through the front, hash stickiness, a replica SIGKILLed under
    traffic; then a second fleet in quantized mode with the canary plane
    on: a clean generation promoted, a corrupted one rolled back. The
    caller (kafka_phase) stops the processes it started on failure."""
    from oryx_tpu_torch.bus.broker import topics
    from oryx_tpu_torch.common.artifact import publish_model_ref
    from oryx_tpu_torch.common.executil import free_port_run
    from oryx_tpu_torch.common.flightrec import read_events
    from oryx_tpu_torch.common.freshness import publish_stamp
    from oryx_tpu_torch.fleet.ring import HashRing

    cuda = device == "cuda"
    items, users, features = shape
    repo = Path(__file__).resolve().parent
    t_leg = time.monotonic()
    out: dict = {"phase": "fleet", "replicas": FLEET_REPLICAS, "policy": "hash",
                 "shape": {"items": items, "users": users, "features": features},
                 "probe_interval_s": FLEET_PROBE_S}

    # the three generations, serialized by three processes at once
    t0 = time.monotonic()
    gen_files = {g: root / f"fleet-gen-{g}.json" for g in (1, 2, 3)}
    writers = [subprocess.Popen(
        [sys.executable, "-c", FLEET_WRITER, str(repo), str(g), str(items),
         str(users), str(features), str(f)]) for g, f in gen_files.items()]
    _, data = model_artifact(np, items, users, features)
    probe = np.random.default_rng(SEED + 2).choice(users, size=burst, replace=False)
    ref_rows = exact_top(torch, np, data, probe, device=device)
    ref = [{f"i{int(j)}" for j in row} for row in ref_rows]
    paths = [f"/recommend/u{int(u)}?howMany={HOW_MANY}" for u in probe]
    for w in writers:
        check(w.wait(timeout=FLEET_LIMIT_S) == 0, "a fleet generation writer failed")
    out["serialize_s"] = time.monotonic() - t0
    out["artifact_mb"] = gen_files[1].stat().st_size / 1e6

    for t in ("FleetInput", "FleetUpdate"):
        topics.maybe_create(srv.uri, t, 1)
    max_message = 16 << 20  # the update topic's default max message size

    class _Producer:
        def send(self, key, message):
            broker.send("FleetUpdate", key, message)

    def publish(gen: int) -> float:
        """MODEL-CHUNKs + MODEL-REF of generation ``gen`` (its path never
        exists here: the replicas resolve it from the artifact relay), then
        its stamp; the seconds the publish took."""
        serialized = gen_files[gen].read_text()
        t = time.monotonic()
        publish_model_ref(_Producer(), serialized,
                          str(root / "fleet-models" / f"gen-{gen}"), max_message)
        broker.send("FleetUpdate", "TRACE", publish_stamp(generation=gen))
        return time.monotonic() - t

    out["publish_s"] = {1: publish(1)}
    front_port = free_port_run(1)
    base_port = free_port_run(FLEET_REPLICAS)

    def fleet_conf(name: str, extra: dict) -> Path:
        conf = root / f"{name}.conf"
        conf.write_text("\n".join(f"{k} = {json.dumps(v)}" for k, v in {
            "oryx.id": "smoke-fleet",
            "oryx.input-topic.broker": srv.uri, "oryx.update-topic.broker": srv.uri,
            "oryx.input-topic.message.topic": "FleetInput",
            "oryx.update-topic.message.topic": "FleetUpdate",
            "oryx.serving.api.read-only": True,
            "oryx.serving.min-model-load-fraction": 1.0,
            "oryx.fleet.base-port": base_port,
            "oryx.fleet.data-dir": str(root / name),
            "oryx.fleet.front.probe-interval-sec": FLEET_PROBE_S,
            "oryx.monitoring.flight.dir": str(root / name / "front-flight"),
            "oryx.compute.platform": "auto" if cuda else "cpu",
            **extra,
        }.items()) + "\n")
        return conf

    def start_fleet(name: str, extra: dict, shards: int = 1) -> tuple:
        """Start `cli fleet`; (process, {replica: seconds to /ready},
        seconds to /fleet/healthz 200)."""
        before = compute_apps() if cuda else []
        t0 = time.monotonic()
        p = start(name, "fleet", "--app", "als", "--conf",
                  str(fleet_conf(name, extra)), "--replicas", str(FLEET_REPLICAS),
                  "--policy", "hash", "--front-port", str(front_port),
                  "--shards", str(shards))
        front_s = wait_for(f"{name}: /fleet/healthz",
                           lambda: _status(front_port, "/fleet/healthz") == 200, alive)
        ready = {}
        for i in range(FLEET_REPLICAS):
            wait_for(f"{name}: r{i} /ready",
                     lambda: _status(base_port + i, "/ready") == 200, alive)
            ready[f"r{i}"] = time.monotonic() - t0
        if cuda:
            after = compute_apps()
            check(len(after) - len(before) >= FLEET_REPLICAS,
                  f"{name}: replicas not on the card: {before} -> {after}")
        return p, ready, front_s

    # 1. the exact fleet, its views row-sharded: start, timed burst,
    # stickiness, kill
    p, ready, front_s = start_fleet("fleet-exact", {}, shards=FLEET_SHARDS)
    line = {"ready_s": ready, "front_healthz_s": front_s, "shards": FLEET_SHARDS}
    line["replica_healthz_shards"] = {
        f"r{i}": json.loads(http_get(base_port + i, "/healthz")[1]).get("shards")
        for i in range(FLEET_REPLICAS)}
    line["front_replica_shards"] = front_gauge(
        front_port, "oryx_fleet_replica_shards")
    check(line["replica_healthz_shards"] == {
        f"r{i}": FLEET_SHARDS for i in range(FLEET_REPLICAS)}
          and line["front_replica_shards"] == {
              f"r{i}": float(FLEET_SHARDS) for i in range(FLEET_REPLICAS)},
          f"shards: /healthz {line['replica_healthz_shards']}, front "
          f"{line['front_replica_shards']}")
    answered0 = front_answers(front_port)
    rows = http_burst(front_port, paths)
    answered = front_answers(front_port)
    lat = sorted((r[3] - r[2]) * 1e3 for r in rows)
    wall = max(r[3] for r in rows) - min(r[2] for r in rows)
    statuses = {}
    for r in rows:
        statuses[r[1]] = statuses.get(r[1], 0) + 1
    hits = sum(len(ref[r[0]] & set(r[4])) for r in rows)
    split = {k: answered.get(k, 0.0) - answered0.get(k, 0.0)
             for k in sorted(set(answered) | set(answered0))}
    fm = fleet_metrics(front_port)
    line.update({
        "requests": len(rows), "connections": CLIENT_PROCS * CLIENT_CONNS,
        "qps": len(rows) / wall, "p50_ms": quantile(lat, 0.5),
        "p99_ms": quantile(lat, 0.99), "statuses": statuses,
        "recall_at_10": hits / (HOW_MANY * len(rows)),
        "split_by_replica": split,
        "launches_by_replica": {k: v["launches"] for k, v in fm.items()},
        "bf16_by_replica": {k: v["by_type"]["bfloat16"] for k, v in fm.items()},
    })
    out["exact"] = line
    emit({"phase": "fleet-burst", **line})
    check(statuses == {200: len(rows)}, f"fleet burst statuses {statuses}")
    check(line["recall_at_10"] == 1.0, f"fleet recall@10 {line['recall_at_10']}")
    check(all(split.get(f"r{i}", 0) > 0 for i in range(FLEET_REPLICAS))
          and split.get("none", 0) == 0, f"fleet split {split}")
    if cuda:
        # a sharded dispatch: a partial launch per shard, one merge
        check(all(fm.get(f"r{i}", {}).get("by_type", {}).get("bfloat16", 0) > 0
                  and fm[f"r{i}"]["launches"]["topk_merge"] > 0
                  and fm[f"r{i}"]["launches"]["topk_dot_partial"]
                  == FLEET_SHARDS * fm[f"r{i}"]["launches"]["topk_merge"]
                  for i in range(FLEET_REPLICAS)),
              f"a replica's launches are not {FLEET_SHARDS} partials a merge: {fm}")
    exact_fm = fm

    # hash stickiness: each user, sent twice, answered twice by the
    # replica the ring names (the front's own count says which)
    ring = HashRing([f"r{i}" for i in range(FLEET_REPLICAS)])
    sticky = {}
    for u in [f"u{int(v)}" for v in probe[:32]]:
        a0 = front_answers(front_port)
        for _ in range(2):
            check(http_get(front_port, f"/recommend/{u}?howMany={HOW_MANY}")[0]
                  == 200, f"/recommend/{u} through the front")
        a1 = front_answers(front_port)
        moved = {k: a1[k] - a0.get(k, 0.0) for k in a1 if a1[k] != a0.get(k, 0.0)}
        check(moved == {ring.lookup(u): 2.0}, f"{u} answered by {moved}")
        sticky[ring.lookup(u)] = sticky.get(ring.lookup(u), 0) + 1
    line["sticky_users_by_replica"] = sticky

    # a replica SIGKILLed under traffic: ejected, restarted, readmitted
    traffic = FleetTraffic(front_port, paths)
    traffic.go.set()
    time.sleep(1.0)
    victim = f"r{FLEET_REPLICAS - 1}"
    os.kill(replica_pid(p.pid, victim), signal.SIGKILL)
    t_kill = time.monotonic()
    eject_s = wait_for("the killed replica's ejection",
                       lambda: not fleet_status(front_port)[victim]["routable"],
                       alive, every=0.02)
    readmit_s = eject_s + wait_for(
        "the restarted replica's readmission",
        lambda: fleet_status(front_port)[victim]["routable"], alive, every=0.02)
    wait_for("the restarted replica's /ready",
             lambda: _status(base_port + FLEET_REPLICAS - 1, "/ready") == 200, alive)
    ready_again_s = time.monotonic() - t_kill
    time.sleep(1.0)
    counts = traffic.close()
    line["kill"] = {"replica": victim, "eject_s": eject_s, "readmit_s": readmit_s,
                    "ready_again_s": ready_again_s, "answers": counts}
    emit({"phase": "fleet-kill", **line["kill"]})
    check(counts["non_shed_5xx"] == 0 and counts["client_error"] == 0
          and counts["other"] == 0 and counts["ok"] > 0,
          f"answers through the kill: {counts}")
    stop("fleet-exact")

    # 2. the canary fleet: r0 adopts first, r1 holds until promoted
    p, ready, front_s = start_fleet("fleet-canary", FLEET_CANARY)
    line = {"ready_s": ready, "front_healthz_s": front_s}
    out["canary"] = line
    line["arm_s"] = wait_for(
        "the hold replica armed at generation 1",
        lambda: (fleet_status(front_port)["r1"]["model_gate"] or {})
        .get("watermark") == 1, alive)
    front_flight = root / "fleet-canary" / "front-flight"

    def events(kind: str, ring_dir=front_flight) -> list:
        return [e for e in read_events(str(ring_dir)) if e.get("kind") == kind]

    def generations() -> dict:
        return {k: v["model_generation"] for k, v in fleet_status(front_port).items()}

    traffic = FleetTraffic(front_port, paths)
    traffic.go.set()
    out["publish_s"][2] = publish(2)
    line["publish_to_promoted_s"] = wait_for(
        "generation 2 promoted on both replicas",
        lambda: generations() == {"r0": 2, "r1": 2}
        and any(e.get("generation") == 2 for e in events("canary-promote")),
        alive, every=0.1)
    traffic.pause()

    # the corrupted generation: adopted on the canary only, refused by
    # the quality gate, rolled back as a pointer swap
    out["publish_s"][3] = publish(3)
    t_pub = time.monotonic()
    line["publish_to_canary_start_s"] = wait_for(
        "generation 3's canary split",
        lambda: any(e.get("generation") == 3 for e in events("canary-start"))
        and (fleet_status(front_port)["r1"]["model_gate"] or {})
        .get("pending_generation") == 3, alive, every=0.1)
    bytes_before = {k: v["dist_bytes"] for k, v in fleet_metrics(front_port).items()}
    traffic.go.set()
    wait_for("generation 3 rolled back",
             lambda: bool(events("canary-rollback"))
             and generations() == {"r0": 2, "r1": 2}, alive, every=0.1)
    line["publish_to_rolled_back_s"] = time.monotonic() - t_pub
    time.sleep(1.0)
    counts = traffic.close()
    fm = fleet_metrics(front_port)
    bytes_after = {k: v["dist_bytes"] for k, v in fm.items()}
    status = fleet_status(front_port)
    front_ev = read_events(str(front_flight))
    canary_ring = read_events(str(root / "fleet-canary" / "r0" / "flight"))
    starts = [e for e in front_ev if e["kind"] == "canary-start"
              and e.get("generation") == 3]
    alarms = [e for e in canary_ring if e["kind"] == "quality-alarm"
              and e.get("generation") == 3]
    rollbacks = [e for e in front_ev if e["kind"] == "canary-rollback"]
    line.update({
        "answers": counts, "dist_bytes_before_rollback": bytes_before,
        "dist_bytes_after_rollback": bytes_after,
        "rollback_event": rollbacks[-1] if rollbacks else None,
        "story": [(e["kind"], e.get("generation"), e["ts_ms"])
                  for e in sorted(starts[:1] + alarms[:1] + rollbacks[:1],
                                  key=lambda e: e["ts_ms"])],
        "model_gate": {k: v["model_gate"] for k, v in status.items()},
        "launches_by_replica": {k: v["launches"] for k, v in fm.items()},
        "int8_by_replica": {k: v["by_type"]["int8"] for k, v in fm.items()},
    })
    emit({"phase": "fleet-canary", **line})
    check(counts["non_shed_5xx"] == 0 and counts["client_error"] == 0
          and counts["other"] == 0 and counts["ok"] > 0,
          f"answers through the canary leg: {counts}")
    check(bytes_after == bytes_before,
          f"the rollback moved distribution bytes: {bytes_before} -> {bytes_after}")
    check(len(rollbacks) == 1 and rollbacks[0].get("generation") == 3
          and rollbacks[0].get("rolled_back_to") == 2
          and not rollbacks[0].get("quarantined"),
          f"rollback events {rollbacks}")
    check(not any(e.get("generation") == 3 for e in front_ev
                  if e["kind"] == "canary-promote"), "generation 3 promoted")
    check(starts and alarms and rollbacks
          and starts[0]["ts_ms"] <= alarms[0]["ts_ms"] <= rollbacks[0]["ts_ms"],
          f"flight story out of order: {line['story']}")
    check(3 in (status["r0"]["model_gate"] or {}).get("vetoed", []),
          f"generation 3 not vetoed on the canary: {status['r0']['model_gate']}")
    if cuda:
        check(all(fm.get(f"r{i}", {}).get("by_type", {}).get("int8", 0) > 0
                  for i in range(FLEET_REPLICAS)),
              f"a canary-fleet replica launched no int8 kernel: {fm}")

    # the canary SIGKILLed after the rollback: restarted with the fleet's
    # decisions, it replays the topic and serves generation 2, never 3
    traffic = FleetTraffic(front_port, paths)
    traffic.go.set()
    time.sleep(1.0)
    os.kill(replica_pid(p.pid, "r0"), signal.SIGKILL)
    t_kill = time.monotonic()
    eject_s = wait_for("the killed canary's ejection",
                       lambda: not fleet_status(front_port)["r0"]["routable"],
                       alive, every=0.02)
    readmit_s = eject_s + wait_for(
        "the restarted canary's readmission",
        lambda: fleet_status(front_port)["r0"]["routable"], alive, every=0.02)
    wait_for("the restarted canary's /ready",
             lambda: _status(base_port, "/ready") == 200, alive)
    ready_again_s = time.monotonic() - t_kill
    # it is ready at generation 1 and replays on: 2 (the promoted one),
    # then 3, which it must refuse. Served generations are polled until it
    # serves 2 with its update topic read to the end, then for as long
    # again as generation 2 took to arrive (an adopted 3 would be served
    # within that); generation 3 must never be served.
    served = []

    def serving(gen: int) -> bool:
        hz = json.loads(http_get(base_port, "/healthz")[1])
        g = hz.get("model_generation")
        if not served or served[-1] != g:
            served.append(g)
        check(g != 3, f"the restarted canary served vetoed generation 3: {hz}")
        return g == gen and hz.get("update_lag") == 0

    to_gen2_s = wait_for("the restarted canary serving generation 2",
                         lambda: serving(2), alive, every=0.25)
    t_watch = time.monotonic()
    while time.monotonic() - t_watch < max(5.0, to_gen2_s):
        alive("the restarted canary's watch")
        serving(2)
        time.sleep(0.25)
    counts = traffic.close()
    hz = json.loads(http_get(base_port, "/healthz")[1])
    gate = hz.get("model_gate") or {}
    kill = {"replica": "r0", "eject_s": eject_s, "readmit_s": readmit_s,
            "ready_again_s": ready_again_s,
            "ready_to_generation_2_s": to_gen2_s,
            "watched_s": time.monotonic() - t_watch,
            "served_generations": served, "answers": counts,
            "model_generation": hz.get("model_generation"), "model_gate": gate}
    line["kill_after_rollback"] = kill
    emit({"phase": "fleet-canary-kill", **kill})
    check(hz.get("model_generation") == 2 and 3 not in gate.get("generations", [3])
          and 3 in gate.get("vetoed", []),
          f"the restarted canary serves {hz.get('model_generation')}, gate {gate}")
    check(counts["non_shed_5xx"] == 0 and counts["client_error"] == 0
          and counts["other"] == 0 and counts["ok"] > 0,
          f"answers through the kill after the rollback: {counts}")
    fm_kill = fleet_metrics(front_port)
    stop("fleet-canary")
    launches = {"topk_dot_partial": 0, "topk_merge": 0}
    by_type = {"float32": 0, "bfloat16": 0, "int8": 0}
    # the restarted canary is a process of its own, with counts of its own
    restarted = {"r0": fm_kill["r0"]} if "r0" in fm_kill else {}
    for fmr in (exact_fm, fm, restarted):
        for v in fmr.values():
            for k in launches:
                launches[k] += v["launches"][k]
            for k in by_type:
                by_type[k] += v["by_type"][k]
    out["launches"], out["partial_launches_by_type"] = launches, by_type
    # every merge of the sharded exact fleet merged its replica's shards
    out["sharded_merges"] = sum(v["launches"]["topk_merge"]
                                for v in exact_fm.values())
    out["seconds"] = time.monotonic() - t_leg
    return out


POD_COMPUTE = 2  # compute ranks of the pod, both on the card (gloo)
# the pod's batch interval: its first generation starts this long after
# the members start, and the next one no sooner than this after the first
# published, so the leg's bursts read one generation
POD_INTERVAL_S = 15
POD_LAMBDAS = [0.01, 500.0]
POD_REQUESTS = 512
POD_KILL_LIMIT_S = 30  # a SIGKILLed compute rank ends the pod within this
POD_INPUT_PARTITIONS = 4


def log_wall(line: str) -> float:
    """The wall-clock seconds of a CLI log line's asctime prefix."""
    import datetime as _dt

    stamp = _dt.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
    return stamp.timestamp()


def pod_leg(np, root: Path, srv, broker, conf: Path, events: list, start,
            stop, alive, procs: dict, device="cuda",
            requests=POD_REQUESTS) -> dict:
    """Phase 11 (the last leg of phase 10, on its broker): `cli pod
    --compute 2 --serving` over phase 10's events on topics of its own,
    both compute ranks on the card joined over gloo, two ALS candidates
    (lambda 0.01 and 500) searched in parallel by process group. Checks:
    both ranks joined; two groups built one candidate each; one MODEL-REF
    and one TRACE on the pod's update topic (the leader alone publishes);
    the winner equal to a one-process serial search of the same window,
    each candidate seeded as a member seeds it (the same lambda; every factor within the mesh parity
    tolerance); the serving child's /ready; 512 exact requests on it and
    512 quantized ones on a second serving process on the same topic
    (qps, p50/p99, recall@10 against float64, each one's kernel
    launches); then a compute rank SIGKILLed tears the pod down, rc != 0,
    within POD_KILL_LIMIT_S."""
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.bus.broker import topics
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.ioutil import choose_free_port
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.layers.datastore import load_all_data
    from oryx_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    cuda = device == "cuda"
    logs = root / "logs"
    t_leg = time.monotonic()
    out = {"phase": "pod", "compute": POD_COMPUTE, "events": len(events),
           "interval_s": POD_INTERVAL_S, "lambdas": POD_LAMBDAS}
    port, qport = choose_free_port(), choose_free_port()
    sets = {
        "oryx.id": "smoke-pod",
        "oryx.input-topic.message.topic": "PodInput",
        "oryx.update-topic.message.topic": "PodUpdate",
        "oryx.batch.storage.data-dir": str(root / "pod-data"),
        "oryx.batch.storage.model-dir": str(root / "pod-model"),
        "oryx.batch.streaming.generation-interval-sec": POD_INTERVAL_S,
        "oryx.ml.eval.candidates": 2,
        "oryx.ml.eval.parallelism": 2,
        "oryx.ml.eval.hyperparam-search": "grid",
        "oryx.als.hyperparams.lambda": POD_LAMBDAS,
        "oryx.serving.api.processes": 1,
        "oryx.serving.api.port": port,
    }
    flags = ["--app", "als", "--conf", str(conf)]
    for k, v in sets.items():
        flags += ["--set", f"{k}={json.dumps(v)}"]
    topics.maybe_create(srv.uri, "PodInput", POD_INPUT_PARTITIONS)
    topics.maybe_create(srv.uri, "PodUpdate", 1)
    t0 = time.monotonic()
    broker.send_batch("PodInput", [(None, e) for e in events])
    check(sum(broker.end_offsets("PodInput")) == len(events), "pod input short")
    out["produce_s"] = time.monotonic() - t0
    # the leader's group reads from the earliest offset; the other member's
    # group of its own is moved to the leader's start by the pod window
    broker.commit_offsets("OryxGroup-smoke-pod-batch", "PodInput",
                          {p: 0 for p in range(POD_INPUT_PARTITIONS)})

    t0 = time.monotonic()
    pod = start("pod", "pod", "--compute", str(POD_COMPUTE), "--serving", *flags)
    start("pod-quantized", "serving", *flags, "--set",
          "oryx.serving.api.score-mode=quantized", "--set",
          f"oryx.serving.api.port={qport}")
    upd = TopicLog(broker, "PodUpdate")
    t_ref = n_rows = None
    while time.monotonic() - t0 < 600:
        alive("the pod's generation ran")
        upd.pull()
        keys = upd.keys()
        if t_ref is None and "MODEL-REF" in keys:
            t_ref = time.monotonic() - t0
            art = ModelArtifact.read(next(m for _, k, m in upd.rows
                                          if k == "MODEL-REF"))
            n_rows = (len(art.get_extension_list("XIDs"))
                      + len(art.get_extension_list("YIDs")))
        if t_ref is not None and keys.count("UP") >= n_rows:
            break
        time.sleep(0.1)
    t_pub = time.monotonic()
    check(t_ref is not None and keys.count("UP") >= n_rows,
          f"the pod published {len(keys)} records")
    gen_ts = int(Path(next(m for _, k, m in upd.rows if k == "MODEL-REF")).name)
    out["generation"] = {"ts": gen_ts, "start_to_model_ref_s": t_ref,
                         "start_to_published_s": t_pub - t0,
                         "chunks": keys.count("MODEL-CHUNK"),
                         "up_rows": keys.count("UP")}

    # the float64 ranking of the published UP rows
    x, y, known = {}, {}, {}
    for _, k, m in upd.rows:
        if k == "UP":
            row = json.loads(m)
            (x if row[0] == "X" else y)[row[1]] = row[2]
            if row[0] == "X":
                known[row[1]] = set(row[3])
    yids = sorted(y)
    ymat = np.asarray([y[i] for i in yids], np.float64)
    col = {i: j for j, i in enumerate(yids)}
    probe = [str(u) for u in np.random.default_rng(SEED + 16).choice(
        sorted(x), requests, replace=False)]
    ref = {}
    for u in probe:
        sc = ymat @ np.asarray(x[u], np.float64)
        for i in known[u]:
            sc[col[i]] = -np.inf
        ref[u] = {yids[j] for j in np.argsort(-sc, kind="stable")[:HOW_MANY]}
    paths = [f"/recommend/{u}?howMany={HOW_MANY}" for u in probe]

    # the serving child and the quantized process, each to /ready, a burst
    out["serving"] = {}
    launches = {"topk_dot_partial": 0, "topk_merge": 0}
    by_type = {"float32": 0, "bfloat16": 0, "int8": 0}
    for mode, p_ in (("exact", port), ("quantized", qport)):
        t1 = time.monotonic()
        while time.monotonic() - t1 < 300:
            alive(f"the pod's {mode} serving loaded")
            if _status(p_, "/ready") == 200:
                break
            time.sleep(0.05)
        check(_status(p_, "/ready") == 200, f"pod {mode} serving never ready")
        line = {"ready_after_publish_s": time.monotonic() - t_pub}
        rows = http_burst(p_, paths)
        check(all(r[1] == 200 for r in rows),
              f"pod {mode}: non-200 {sorted({r[1] for r in rows if r[1] != 200})}")
        lat = sorted((r[3] - r[2]) * 1e3 for r in rows)
        wall = max(r[3] for r in rows) - min(r[2] for r in rows)
        hits = sum(len(ref[probe[r[0]]] & set(r[4])) for r in rows)
        recall = hits / (HOW_MANY * len(rows))
        check(recall >= MIN_RECALL[mode], f"pod {mode} recall@10 {recall}")
        rep = replica_scrape(p_, 1)
        (only,) = rep.values()
        line.update({"requests": len(rows), "qps": len(rows) / wall,
                     "p50_ms": quantile(lat, 0.5), "p99_ms": quantile(lat, 0.99),
                     "recall_at_10": recall, "launches": only["launches"],
                     "partial_launches_by_type": only["by_type"]})
        for kk in launches:
            launches[kk] += only["launches"][kk]
        for kk in by_type:
            by_type[kk] += only["by_type"][kk]
        out["serving"][mode] = line
    if cuda:
        check(all(v > 0 for v in launches.values()) and by_type["bfloat16"] > 0
              and by_type["int8"] > 0, f"the pod's serving launched {launches} {by_type}")
    out["launches"], out["partial_launches_by_type"] = launches, by_type
    upd.pull()
    keys = upd.keys()
    out["published"] = {k: keys.count(k) for k in ("MODEL", "MODEL-REF", "TRACE")}
    check(keys.count("MODEL") + keys.count("MODEL-REF") == 1
          and keys.count("TRACE") == 1 and keys.count("UP") == n_rows,
          f"not one leader publish: {out['published']}, {keys.count('UP')} UP rows")

    # the members' logs: both joined, two groups, one candidate each
    log = (logs / "pod.log").read_text(errors="replace").splitlines()
    joined = sorted(ln.split("process ")[-1] for ln in log
                    if "joined process group (gloo)" in ln)
    searches = [ln for ln in log if "pod parallel candidate search" in ln]
    evals = [ln for ln in log if "-> eval" in ln]
    out["joined"] = joined
    out["groups"] = [ln.split("; ", 1)[1] for ln in searches]
    check(joined == [f"{r}/{POD_COMPUTE}" for r in range(POD_COMPUTE)],
          f"ranks joined: {joined}")
    check(len(searches) == POD_COMPUTE and len(evals) == POD_COMPUTE
          and all("2 groups over 2 processes" in ln for ln in searches),
          f"the process-group search: {searches} {evals}")
    out["search_s"] = max(log_wall(e) for e in evals) - min(log_wall(ln) for ln in searches)

    # a compute rank SIGKILLed: the pod tears down, rc != 0
    kids = [int(p_) for p_ in subprocess.run(
        ["pgrep", "-P", str(pod.pid)], capture_output=True, text=True).stdout.split()]
    rank1 = [k for k in kids if "process-id=1" in
             Path(f"/proc/{k}/cmdline").read_bytes().decode(errors="replace")]
    check(len(rank1) == 1, f"compute rank 1 among {kids}")
    t1 = time.monotonic()
    os.kill(rank1[0], signal.SIGKILL)
    try:
        rc = pod.wait(timeout=POD_KILL_LIMIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    procs.pop("pod", None)
    out["kill"] = {"rc": rc, "teardown_s": time.monotonic() - t1,
                   "serving_child_gone": _status(port, "/ready") is None}
    check(rc not in (None, 0), f"the pod did not tear down: rc {rc}")
    check(out["kill"]["serving_child_gone"], "the pod's serving child outlived it")
    stop("pod-quantized")

    # the same window and seeds in one process, searched serially on the
    # group's mesh shape: the generation seeded as a pod member seeds it
    # (the pod config), each candidate from MLUpdate._pod_candidate_seed
    window = load_all_data(str(root / "pod-data"))
    check(len(window) == len(events), f"the leader persisted {len(window)} records")
    cfg = load_config(str(conf), overlay={
        **sets, "oryx.batch.storage.model-dir": str(root / "pod-ref"),
        "oryx.ml.eval.parallelism": 1,
        "oryx.compute.distributed.num-processes": POD_COMPUTE})

    class _SerialPodSearch(ALSUpdate):
        def _build_one(self, i, *a):
            RandomManager.use_test_seed(self._pod_candidate_seed(gen_ts, i))
            return super()._build_one(i, *a)

    class _Sink:
        topic = "none"

        def send(self, key, message):
            pass

        def send_batch(self, records):
            pass

    t1 = time.monotonic()
    _SerialPodSearch(cfg, device=device,
                     mesh=make_mesh(MeshSpec(1, 1), [device])
                     ).run_update(gen_ts, window, [], str(root / "pod-ref"), _Sink())
    out["one_process_search_s"] = time.monotonic() - t1
    pod_art = ModelArtifact.read(root / "pod-model" / str(gen_ts))
    ref_art = ModelArtifact.read(root / "pod-ref" / str(gen_ts))
    lam = pod_art.extensions.get("lambda")
    check(lam == ref_art.extensions.get("lambda") == "0.01",
          f"pod winner lambda {lam}, one process {ref_art.extensions.get('lambda')}")
    diffs = {}
    for t in ("X", "Y"):
        a, b = np.asarray(pod_art.tensors[t]), np.asarray(ref_art.tensors[t])
        check(a.shape == b.shape, f"{t} {a.shape} vs {b.shape}")
        diffs[t] = float(np.abs(a - b).max())
        check(np.allclose(a, b, **MESH_TOL), f"pod {t} off the one-process search by {diffs[t]}")
    out["winner"] = {"lambda": lam, "max_factor_diff": diffs, "tolerance": MESH_TOL}
    out["seconds"] = time.monotonic() - t_leg
    return out


def _status(port: int, path: str):
    """The status of GET path, or None while nothing listens."""
    try:
        return http_get(port, path)[0]
    except OSError:
        return None


def kafka_phase(np, root: Path, device="cuda", shape=KAFKA_SHAPE,
                burst=KAFKA_BURST, speed_events=KAFKA_SPEED_EVENTS,
                wordcount_lines=WORDCOUNT_LINES, centers=PMML_CENTERS,
                assign_requests=PMML_ASSIGN, max_message=KAFKA_MAX_MESSAGE,
                fleet_shape=FLEET_SHAPE) -> dict:
    """Phase 10: the ALS loop deployed as separate `python -m
    oryx_tpu_torch.cli` processes joined only by kafka:// topics on one
    test broker (tests/torch_kafka_testbroker.py) on 127.0.0.1; then the
    example app and an imported PMML model on the same broker."""
    from oryx_tpu_torch.apps.example.serving import ExampleServingModelManager
    from oryx_tpu_torch.apps.kmeans.serving import KMeansServingModelManager
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import compress, filelog, kafkawire
    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.ioutil import choose_free_port
    from oryx_tpu_torch.layers import BatchLayer
    from oryx_tpu_torch.ml.synth import synthesize_interactions
    from oryx_tpu_torch.serving.server import ServingLayer

    cuda = device == "cuda"
    repo = Path(__file__).resolve().parent
    logs = root / "logs"
    for d in (logs, root / "tmp"):
        d.mkdir(parents=True, exist_ok=True)
    # every child keeps its scratch (the artifact relay's cache) in root
    env = dict(os.environ, TMPDIR=str(root / "tmp"), PYTHONPATH=str(repo))
    procs: dict = {}

    def start(name: str, *args, **kw) -> subprocess.Popen:
        out = kw.pop("stdout", None) or open(logs / f"{name}.out", "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "oryx_tpu_torch.cli", *args], cwd=repo,
            env=env, stdout=out, stderr=open(logs / f"{name}.log", "w"),
            start_new_session=True, **kw)
        procs[name] = p
        return p

    def run(name: str, *args, stdin: str | None = None, timeout=300) -> tuple:
        t = time.monotonic()
        with open(logs / f"{name}.log", "w") as err:
            p = subprocess.run(
                [sys.executable, "-m", "oryx_tpu_torch.cli", *args], cwd=repo,
                env=env, input=stdin, text=True, stdout=subprocess.PIPE,
                stderr=err, timeout=timeout)
        check(p.returncode == 0, f"cli {args[0]} exited {p.returncode}: "
              + (logs / f"{name}.log").read_text()[-2000:])
        return p.stdout, time.monotonic() - t

    def stop(name: str, sig=signal.SIGTERM) -> int:
        p = procs.pop(name)
        if p.poll() is None:
            os.killpg(p.pid, sig)
        try:
            return p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            return p.wait(timeout=30)

    def alive(what: str) -> None:
        for name, p in procs.items():
            check(p.poll() is None, f"{name} exited {p.returncode} while {what}: "
                  + (logs / f"{name}.log").read_text()[-3000:])

    testbroker = load_test_broker()
    srv = testbroker.LocalKafkaTestBroker().start()
    out = {"phase": "kafka", "broker": srv.uri,
           "shape": {"users": shape[0], "items": shape[1], "interactions": shape[2]},
           "replicas": KAFKA_REPLICAS}
    port = choose_free_port()
    conf = root / "oryx.conf"
    conf.write_text("\n".join(f"{k} = {json.dumps(v)}" for k, v in {
        "oryx.id": "smoke-kafka",
        "oryx.input-topic.broker": srv.uri, "oryx.update-topic.broker": srv.uri,
        "oryx.input-topic.message.partitions": KAFKA_PARTITIONS["input"],
        "oryx.update-topic.message.partitions": KAFKA_PARTITIONS["update"],
        "oryx.update-topic.message.max-size": max_message,
        "oryx.update-topic.artifact-transfer": True,
        "oryx.batch.storage.data-dir": str(root / "data"),
        "oryx.batch.storage.model-dir": str(root / "model"),
        "oryx.monitoring.quarantine.dir": str(root / "quarantine"),
        "oryx.monitoring.flight.dir": str(root / "flight"),
        "oryx.serving.api.port": port,
        "oryx.serving.api.processes": KAFKA_REPLICAS,
        "oryx.serving.min-model-load-fraction": 1.0,
        "oryx.speed.min-model-load-fraction": 1.0,
        "oryx.batch.streaming.generation-interval-sec": KAFKA_BATCH_INTERVAL_S,
        "oryx.speed.streaming.generation-interval-sec": 1,
        "oryx.als.hyperparams.features": TRAIN_HP["features"],
        "oryx.als.hyperparams.iterations": TRAIN_HP["iterations"],
        "oryx.als.hyperparams.lambda": TRAIN_HP["lam"],
        "oryx.als.hyperparams.alpha": TRAIN_HP["alpha"],
        "oryx.als.compute-dtype": "bfloat16",
        "oryx.compute.platform": "auto" if cuda else "cpu",
    }.items()) + "\n")
    flags = ["--app", "als", "--conf", str(conf)]
    broker = get_broker(srv.uri)
    try:
        # 1. the topics, and the effective config naming them
        run("setup", "setup", *flags)
        check(broker.num_partitions("OryxInput") == KAFKA_PARTITIONS["input"]
              and broker.num_partitions("OryxUpdate") == KAFKA_PARTITIONS["update"],
              "setup made other partitions")
        lines, _ = run("config", "config", *flags)
        lines = lines.splitlines()
        for w in ("input", "update"):
            check(f"oryx.{w}-topic.broker={srv.uri}" in lines,
                  f"cli config does not name the {w} topic's kafka:// URI")

        # 2. phase 6's events through `cli input`
        users, items, values = synthesize_interactions(*shape, seed=TRAIN_HP["seed"])
        ts0 = int(time.time() * 1000)
        events = event_lines(np, users, items, values, ts0 - 86_400_000)
        _, wall = run("input", "input", *flags, stdin="\n".join(events) + "\n")
        said = (logs / "input.log").read_text().split()
        produce_s = float(said[said.index("in") + 1])
        check(sum(broker.end_offsets("OryxInput")) == shape[2], "input short")
        out["input"] = {"events": shape[2], "produce_s": produce_s,
                        "events_per_s": shape[2] / produce_s, "wall_s": wall}

        # 3. one generation of `cli batch`, its group reset to the earliest
        # offset first (the operator's reset of a new group), so it reads
        # the events written before it started
        broker.commit_offsets("OryxGroup-smoke-kafka-batch", "OryxInput",
                              {p: 0 for p in range(KAFKA_PARTITIONS["input"])})
        start("tail", "tail", *flags, stdout=open(logs / "tail.out", "w"))
        t0 = time.monotonic()
        start("batch", "batch", *flags)
        upd = TopicLog(broker, "OryxUpdate")
        t_ref = n_rows = None
        while time.monotonic() - t0 < 600:
            alive("the generation ran")
            upd.pull()
            keys = upd.keys()
            if t_ref is None and "MODEL-REF" in keys:
                t_ref = time.monotonic() - t0
                # the generation's factor rows follow its MODEL-REF: one
                # per user and item of the artifact it names
                art = ModelArtifact.read(next(m for _, k, m in upd.rows
                                              if k == "MODEL-REF"))
                n_rows = (len(art.get_extension_list("XIDs"))
                          + len(art.get_extension_list("YIDs")))
            if t_ref is not None and keys.count("UP") >= n_rows:
                break
            time.sleep(0.1)
        t_all = time.monotonic() - t0
        check(keys.count("UP") >= n_rows, f"{keys.count('UP')} UP rows, not {n_rows}")
        check(stop("batch") == 0, "batch did not stop cleanly on SIGTERM")
        check(keys.count("MODEL-CHUNK") > 1 and keys.count("MODEL-REF") == 1,
              f"the generation was not chunked: {keys.count('MODEL-CHUNK')} chunks")
        gen_ts = int(Path(next(m for _, k, m in upd.rows if k == "MODEL-REF")).name)
        out["batch"] = {"start_to_model_ref_s": t_ref, "start_to_published_s": t_all,
                        "interval_s": KAFKA_BATCH_INTERVAL_S, "generation": gen_ts,
                        "chunks": keys.count("MODEL-CHUNK"), "up_rows": keys.count("UP")}

        # the published factors and known items, as the UP rows carry them
        x, y, known = {}, {}, {}
        for _, k, m in upd.rows:
            if k == "UP":
                row = json.loads(m)
                (x if row[0] == "X" else y)[row[1]] = row[2]
                if row[0] == "X":
                    known[row[1]] = set(row[3])
        yids = sorted(y)
        ymat = np.asarray([y[i] for i in yids], np.float64)
        col = {i: j for j, i in enumerate(yids)}
        probe = [str(u) for u in np.random.default_rng(SEED + 11).choice(
            sorted(x), burst, replace=False)]
        ref = {}
        for u in probe:
            s = ymat @ np.asarray(x[u], np.float64)
            for i in known[u]:
                s[col[i]] = -np.inf
            ref[u] = {yids[j] for j in np.argsort(-s, kind="stable")[:HOW_MANY]}
        paths = [f"/recommend/{u}?howMany={HOW_MANY}" for u in probe]

        # 4. serving replicas on the card, in each score mode
        out["serving"] = {}
        launches = {"topk_dot_partial": 0, "topk_merge": 0}
        by_type = {"float32": 0, "bfloat16": 0, "int8": 0}
        for mode in ("exact", "quantized"):
            before = compute_apps() if cuda else []
            t0 = time.monotonic()
            sup = start(f"serving-{mode}", "serving", *flags, "--set",
                        f"oryx.serving.api.score-mode={mode}")
            ready: dict = {}
            while len(ready) < KAFKA_REPLICAS and time.monotonic() - t0 < 300:
                alive(f"{mode} replicas started")
                name, status, _ = on_one_replica(port, "/ready")
                if status == 200 and name not in ready:
                    ready[name] = time.monotonic() - t0
                time.sleep(0.02)
            check(len(ready) == KAFKA_REPLICAS, f"{mode}: ready replicas {ready}")
            kids = [int(p) for p in subprocess.run(
                ["pgrep", "-P", str(sup.pid)], capture_output=True,
                text=True).stdout.split()]
            check(len(kids) == KAFKA_REPLICAS, f"{mode}: replica processes {kids}")
            line = {"ready_s": ready, "pids": kids}
            if cuda:
                # every replica holds its own CUDA context; nvidia-smi names
                # the processes by pid where it shares their pid namespace
                after = compute_apps()
                line["nvidia_smi_pids"] = after
                line["nvidia_smi_new_apps"] = len(after) - len(before)
                in_ns = all(str(k) in after for k in kids)
                check(in_ns or len(after) - len(before) >= KAFKA_REPLICAS,
                      f"{mode}: replicas {kids} not on the card: {before} -> {after}")
                line["pids_in_nvidia_smi"] = in_ns
            rows = http_burst(port, paths)
            check(all(r[1] == 200 for r in rows),
                  f"{mode}: non-200 in the burst: "
                  f"{sorted({r[1] for r in rows if r[1] != 200})}")
            lat = sorted((r[3] - r[2]) * 1e3 for r in rows)
            wall = max(r[3] for r in rows) - min(r[2] for r in rows)
            hits = sum(len(ref[probe[r[0]]] & set(r[4])) for r in rows)
            recall = hits / (HOW_MANY * len(rows))
            check(recall >= MIN_RECALL[mode], f"{mode} recall@10 {recall}")
            line.update({"requests": len(rows), "connections": CLIENT_PROCS * CLIENT_CONNS,
                         "qps": len(rows) / wall, "p50_ms": quantile(lat, 0.5),
                         "p99_ms": quantile(lat, 0.99), "recall_at_10": recall})
            out["serving"][mode] = line
            if mode == "exact":
                reps = replica_scrape(port, KAFKA_REPLICAS)
                line["launches_by_replica"] = {k: v["launches"] for k, v in reps.items()}
                for v in reps.values():
                    for k in launches:
                        launches[k] += v["launches"][k]
                    for k in by_type:
                        by_type[k] += v["by_type"][k]
                stop(f"serving-{mode}")
        port_url = f"http://127.0.0.1:{port}"

        # 5. the speed layer folds events, four of them in foreign batches
        t0 = time.monotonic()
        start("speed", "speed", *flags)

        folded_users: set = set()

        def folded(user: str) -> bool:
            for _, k, m in upd.pull():
                if k == "UP" and m.startswith('["X",'):
                    folded_users.add(json.loads(m)[1])
            return user in folded_users

        # a probe event a second until one is folded: the speed layer drops
        # events until its model has loaded
        for n in range(600):
            alive("the speed layer loaded its model")
            broker.send("OryxInput", None, f"u-probe-{n},i{int(items[0])},1,{ts0}")
            t = time.monotonic()
            while time.monotonic() - t < 1.0 and not folded(f"u-probe-{n}"):
                time.sleep(0.05)
            if folded(f"u-probe-{n}"):
                break
        check(folded(f"u-probe-{n}"), "the speed layer never folded a probe")
        speed = {"start_to_first_fold_s": time.monotonic() - t0, "probes": n + 1}
        rng = np.random.default_rng(SEED + 12)
        su, si = rng.choice(users, speed_events), rng.choice(items, speed_events)
        lines = event_lines(np, su, si, np.full(speed_events, 2.0), ts0)
        known_item = f"i{int(items[0])}"
        for j in range(SPEED_NEW):
            lines[j] = f"u-new-{j},{known_item},3,{ts0 + j}"
        codecs = {"gzip": (1, gzip.compress), "snappy": (2, snappy_literals),
                  "lz4": (3, compress.lz4f_compress), "zstd": (4, compress.zstd_compress)}
        ran = {}
        for name, (codec, fn) in codecs.items():
            try:
                ran[name] = foreign_batch(kafkawire, [f"u-codec-{name},{known_item},3,{ts0}"],
                                          codec, fn)
            except compress.CodecUnavailable:
                check(name in ("lz4", "zstd"), f"{name} must always run")
        t_write = time.monotonic()
        for batch in ran.values():
            srv.append_raw_batch("OryxInput", 0, batch)
        _, wall = run("speed-input", "input", *flags, stdin="\n".join(lines) + "\n")
        t_written = time.monotonic()
        served = {}
        for user in ["u-new-0"] + [f"u-codec-{c}" for c in ran]:
            seen: set = set()
            while len(seen) < KAFKA_REPLICAS and time.monotonic() - t_written < 120:
                alive(f"{user} was folded")
                name, status, _ = on_one_replica(
                    port, f"/recommend/{user}?howMany={HOW_MANY}")
                if status == 200:
                    seen.add(name)
                else:
                    time.sleep(0.005)
            check(len(seen) == KAFKA_REPLICAS, f"{user} served by {seen}")
            served[user] = time.monotonic() - t_written
        speed.update({"events": speed_events + len(ran), "input_wall_s": wall,
                      "write_to_served_s": time.monotonic() - t_write,
                      "written_to_served_s": served,
                      "codecs": {c: c in ran for c in codecs}})
        out["speed"] = speed

        # 6. tail, perf and flight against the running deployment
        time.sleep(KAFKA_TAIL_S)
        stop("tail", signal.SIGINT)
        tailed = [ln.split("\t", 2) for ln in
                  (logs / "tail.out").read_text().splitlines()]
        keys = [t[1] for t in tailed if t[0] == "OryxUpdate"]
        out["tail"] = {"update": {k: keys.count(k) for k in sorted(set(keys))},
                       "input": sum(t[0] == "OryxInput" for t in tailed)}
        check("MODEL-REF" in keys and keys.count("UP") >= n_rows
              and out["tail"]["input"] >= speed_events,
              f"cli tail printed {out['tail']}")
        report, _ = run("perf", "perf", *flags, "--url", port_url)
        check(report.startswith("latency budget") and "(no phase samples yet)"
              not in report.split("device idle gaps")[0],
              f"cli perf rendered no phases: {report[:400]}")
        out["perf_report_lines"] = len(report.splitlines())
        paths_file = root / "paths.txt"
        paths_file.write_text("\n".join(paths[:256]) + "\n")
        report, _ = run("loadtest", "loadtest", *flags, "--url", port_url,
                        "--paths", str(paths_file), "--duration", "2", "--workers", "16")
        out["loadtest"] = json.loads(report.strip().splitlines()[-1])
        check(out["loadtest"]["errors"] == 0, f"cli loadtest: {out['loadtest']}")
        reps = replica_scrape(port, KAFKA_REPLICAS)
        q = out["serving"]["quantized"]
        q["launches_by_replica"] = {k: v["launches"] for k, v in reps.items()}
        for v in reps.values():
            for k in launches:
                launches[k] += v["launches"][k]
            for k in by_type:
                by_type[k] += v["by_type"][k]
        flight, _ = run("flight", "flight", *flags, "--kind", "process-start",
                        "--kind", "generation")
        evs = [json.loads(ln) for ln in flight.splitlines()]
        starts = {e.get("replica"): e["pid"] for e in evs if e["kind"] == "process-start"}
        check(set(q["pids"]) <= set(starts.values()),
              f"the flight ring lacks the replicas' starts: {starts}")
        gens = {e.get("generation") for e in evs if e["kind"] == "generation"}
        check(gen_ts in gens, f"the flight ring lacks generation {gen_ts}: {gens}")
        out["flight"] = {"events": len(evs), "replicas": sorted(k for k in starts if k)}
        stop("serving-quantized")
        stop("speed")
        # 6b. the fleet: `cli fleet` over card replicas at 500k x 50, its
        # model on a kafka:// topic of this broker
        import torch

        fleet = fleet_leg(torch, np, root, srv, broker, start, stop, alive,
                          device=device, shape=fleet_shape, burst=burst)
        emit(fleet)
        out["fleet"] = {k: fleet[k] for k in ("seconds", "launches",
                                               "partial_launches_by_type",
                                               "sharded_merges")}
        for k in launches:
            launches[k] += fleet["launches"][k]
        for k in by_type:
            by_type[k] += fleet["partial_launches_by_type"][k]
        out["launches"], out["partial_launches_by_type"] = launches, by_type
        if cuda:
            check(all(v > 0 for v in launches.values()) and by_type["bfloat16"] > 0
                  and by_type["int8"] > 0, f"the replicas launched {launches} {by_type}")

        # 7. the example app on the same broker, in-process
        t0 = time.monotonic()
        overlay = dict(app_overlay("example"))
        overlay.update({
            "oryx.id": "smoke-wordcount",
            "oryx.input-topic.broker": srv.uri, "oryx.update-topic.broker": srv.uri,
            "oryx.input-topic.message.topic": "WordInput",
            "oryx.update-topic.message.topic": "WordUpdate",
            "oryx.batch.storage.data-dir": str(root / "wc-data"),
            "oryx.batch.storage.model-dir": str(root / "wc-model"),
            "oryx.monitoring.flight.dir": str(root / "flight"),
            "oryx.serving.api.port": 0,
        })
        wcfg = load_config(overlay=overlay)
        for t in ("WordInput", "WordUpdate"):
            topics.maybe_create(srv.uri, t, 2 if t == "WordInput" else 1)
        rng = np.random.default_rng(SEED + 13)
        vocab = [f"w{j}" for j in range(2000)]
        words = [" ".join(rng.choice(vocab, int(rng.integers(1, 8))))
                 for _ in range(wordcount_lines)]
        batch = BatchLayer(wcfg)
        batch.ensure_streams()
        broker.send_batch("WordInput", [(None, ln) for ln in words])
        check(batch.run_generation() == wordcount_lines, "wordcount read short")
        batch.close()
        serving = ServingLayer(wcfg, model_manager=ExampleServingModelManager(wcfg))
        serving.start()
        try:
            wait_ready(serving.port, t0)
            status, body = http_get(serving.port, "/distinct")
            want = plain_wordcount(words)
            check(status == 200 and json.loads(body) == want,
                  "/distinct differs from the plain count")
            w0 = max(want, key=want.get)
            check(json.loads(http_get(serving.port, f"/distinct/{w0}")[1]) == want[w0],
                  f"/distinct/{w0}")
        finally:
            serving.close()
        out["example"] = {"lines": wordcount_lines, "words": len(want),
                          "seconds": time.monotonic() - t0}

        # 8. `cli import-pmml` of a k-means model, served on the card
        t0 = time.monotonic()
        k, dims = centers
        c = np.random.default_rng(SEED + 14).normal(0, 3, (k, dims)).astype(np.float32)
        art = ModelArtifact("kmeans", extensions={"k": str(k)}, tensors={"centers": c})
        art.content["counts"] = [int(v) for v in range(1, k + 1)]
        pmml = root / "kmeans.pmml"
        pmml.write_text(art.to_pmml_xml())
        kflags = ["--conf", str(conf), "--set", "oryx.input-topic.message.topic=KMeansInput",
                  "--set", "oryx.update-topic.message.topic=KMeansUpdate"]
        run("setup-kmeans", "setup", *kflags)
        run("import-pmml", "import-pmml", *kflags, "--pmml", str(pmml))
        [(_, key, _m)] = broker.read("KMeansUpdate", 0, 0, 10)
        overlay = dict(app_overlay("kmeans"))
        overlay.update({
            "oryx.id": "smoke-pmml",
            "oryx.input-topic.broker": srv.uri, "oryx.update-topic.broker": srv.uri,
            "oryx.input-topic.message.topic": "KMeansInput",
            "oryx.update-topic.message.topic": "KMeansUpdate",
            "oryx.batch.storage.model-dir": str(root / "model"),
            "oryx.monitoring.flight.dir": str(root / "flight"),
            "oryx.serving.api.port": 0,
            "oryx.input-schema.num-features": dims,
            "oryx.input-schema.numeric-features": [str(j) for j in range(dims)],
        })
        kcfg = load_config(overlay=overlay)
        manager = KMeansServingModelManager(kcfg, **({} if cuda else {"device": "cpu"}))
        check(manager.device.type == device, f"k-means serving on {manager.device}")
        serving = ServingLayer(kcfg, model_manager=manager)
        serving.start()
        try:
            wait_ready(serving.port, t0)
            rng = np.random.default_rng(SEED + 15)
            sent = csv_lines(np, c[rng.integers(0, k, assign_requests)]
                             + rng.normal(0, 1.0, (assign_requests, dims)), "%.5f")
            ids = []
            for datum in sent:
                status, body = http_get(serving.port, f"/assign/{datum}")
                check(status == 200, f"/assign answered {status}")
                ids.append(int(json.loads(body)))
            d2, ids_ref, scale = f64_assign(np, parsed(np, sent), c)
            ties = near_ties(np, d2, ids_ref, np.asarray(ids), scale)
        finally:
            serving.close()
        out["pmml"] = {"centers": list(centers), "published_as": key,
                       "assign_requests": assign_requests, "near_tie_points": ties,
                       "device": str(manager.device), "seconds": time.monotonic() - t0}

        # 9. the pod (phase 11) over the same events, on topics of its own
        pod = pod_leg(np, root, srv, broker, conf, events, start, stop, alive,
                      procs, device=device, requests=min(POD_REQUESTS, burst))
        emit(pod)
        out["pod"] = {k: pod[k] for k in ("seconds", "launches",
                                           "partial_launches_by_type")}
        for k in launches:
            launches[k] += pod["launches"][k]
        for k in by_type:
            by_type[k] += pod["partial_launches_by_type"][k]

        out["crc32c_tier"] = {"crc32c_ext": "google_crc32c", "crc32c_native": "native",
                              "_crc32c_py": "python"}[kafkawire._crc32c_impl.__name__]
        # the file log resolves its tier once a process: the same for the
        # file:// buses of phases 6-9
        out["native_appender_in_file_buses"] = filelog._maybe_native() is not None
    except BaseException:
        for name in list(procs):
            print(f"--- {name} log tail ---\n"
                  + (logs / f"{name}.log").read_text()[-3000:], file=sys.stderr)
        raise
    finally:
        for name in list(procs):
            stop(name, signal.SIGKILL if name == "tail" else signal.SIGTERM)
        broker.close()
        srv.close()
    return out


# ---------------------------------------------------------------------------
# phase 7: k-means (the batch build at the bench's shape, then the app)
# ---------------------------------------------------------------------------

KMEANS_SHAPE = {"n_points": 5_000_000, "dims": 20, "k": 100, "iterations": 10}
KMEANS_REPLACES = "oryx_tpu/ops/kmeans.py:61"  # lloyd_jit: torch ops, no Pallas kernel
SSE_RATIO_MAX, SILHOUETTE_MIN = 1.05, 0.5  # tests/test_quality_gate.py:84-86
LLOYD_CHECK_POINTS = 200_000
LLOYD_RTOL = 1e-4  # of the largest center entry, against float64
NEAR_TIE_D2 = 1e-5  # of |x|^2 + max |c|^2: the f32 expansion's roundoff
KMEANS_APP_POINTS = 200_000
APP_REQUESTS = 256
APP_SPEED_EVENTS = 1_000


MESH_LEG = (2, 1)  # the (data, model) mesh of phases 7 and 8's mesh legs, on the card
# k-means on the mesh against one device from the same init: the sums run
# in another order (LLOYD_RTOL's scale: of the largest center entry)
KMEANS_MESH_RTOL = 1e-4


def kmeans_mesh_leg(torch, np, points, shape, device="cuda") -> dict:
    """train_kmeans on a MESH_LEG mesh of the card against one device, the
    same points and the same generator seed: centers within
    KMEANS_MESH_RTOL of the largest center entry, the SSE ratio beside it."""
    from oryx_tpu_torch.ops.kmeans import sum_squared_error, train_kmeans
    from oryx_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(*MESH_LEG), [device] * (MESH_LEG[0] * MESH_LEG[1]))
    kw = dict(k=shape["k"], iterations=shape["iterations"])
    runs = {}
    for name, extra in (("single", {"device": device}), ("mesh", {"mesh": mesh})):
        gen = torch.Generator(device=device).manual_seed(SEED + 41)
        t0 = time.perf_counter()
        runs[name] = train_kmeans(points, generator=gen, **kw, **extra)
        runs[name + "_s"] = time.perf_counter() - t0
    one, on_mesh = runs["single"], runs["mesh"]
    scale = float(np.abs(one.centers).max())
    diff = float(np.abs(on_mesh.centers - one.centers).max())
    sse_one = sum_squared_error(points, one.centers, device=device)
    sse_mesh = sum_squared_error(points, on_mesh.centers, device=device)
    check(diff <= KMEANS_MESH_RTOL * scale,
          f"mesh k-means centers {diff} off single-device (scale {scale})")
    return {"mesh": list(MESH_LEG), "single_s": runs["single_s"],
            "mesh_s": runs["mesh_s"], "max_center_diff": diff,
            "center_scale": scale, "rtol": KMEANS_MESH_RTOL,
            "counts_equal": bool((on_mesh.counts == one.counts).all()),
            "sse_ratio_mesh_to_single": sse_mesh / sse_one}


def rdf_mesh_leg(torch, np, data, y, shape, device="cuda") -> dict:
    """grow_forest with the tree axis over a MESH_LEG mesh of the card
    against one device, from the same test seed: the same forest, array
    for array."""
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.ops.rdf import grow_forest
    from oryx_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(*MESH_LEG), [device] * (MESH_LEG[0] * MESH_LEG[1]))
    kw = dict(num_trees=shape["num_trees"], max_depth=shape["max_depth"],
              impurity="entropy", n_classes=7, feature_subset=14)
    out = {"mesh": list(MESH_LEG)}
    forests = {}
    for name, extra in (("single", {"device": device}), ("mesh", {"mesh": mesh})):
        RandomManager.use_test_seed(SEED + 42)
        t0 = time.perf_counter()
        forests[name] = grow_forest(data, y, **kw, **extra)
        out[name + "_s"] = time.perf_counter() - t0
    a, b = forests["single"], forests["mesh"]
    same = {f: bool(np.array_equal(getattr(a, f), getattr(b, f)))
            for f in ("feature", "split_left", "class_counts",
                      "feature_importances")}
    out["identical"] = same
    check(all(same.values()), f"mesh forest differs from single-device: {same}")
    return out


def build_profile(torch, fn) -> dict:
    """One run of fn traced by torch.profiler (host ops and the card):
    the card's busy share of the traced wall time, kernel launches, and
    the card's time by the aten op that launched it (self device time)."""
    from torch.autograd import DeviceType

    acts = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    device_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    ops = sorted((ev for ev in events if ev.device_type == DeviceType.CPU
                  and ev.self_device_time_total > 0),
                 key=lambda ev: -ev.self_device_time_total)
    return {
        "traced_wall_s": wall_s, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall_s * 1e3),
        "kernel_launches": sum(ev.count for ev in kernels),
        "by_op": {ev.key: {"device_ms": ev.self_device_time_total / 1e3,
                           "calls": ev.count} for ev in ops[:12]},
    }


def app_config(root: Path, app: str, extra: dict):
    """A file:// bus under root with the app's classes (apps/spi.py)."""
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import topic_admin
    from oryx_tpu_torch.common.config import load_config

    bus = f"file://{root / 'bus'}"
    overlay = dict(app_overlay(app))
    overlay.update({
        "oryx.id": f"smoke-{app}",
        "oryx.input-topic.broker": bus, "oryx.update-topic.broker": bus,
        "oryx.batch.storage.data-dir": f"file://{root / 'data'}",
        "oryx.batch.storage.model-dir": f"file://{root / 'model'}",
        "oryx.monitoring.quarantine.dir": f"file://{root / 'quarantine'}",
        "oryx.monitoring.flight.dir": f"file://{root / 'flight'}",
        "oryx.serving.api.port": 0,
        "oryx.speed.streaming.generation-interval-sec": 3600,
        "oryx.batch.streaming.generation-interval-sec": 3600,
    })
    overlay.update(extra)
    cfg = load_config(overlay=overlay)
    for w in ("input", "update"):
        topic_admin.maybe_create(bus, cfg.get_string(f"oryx.{w}-topic.message.topic"))
    return cfg, bus


def wait_ready(port: int, t0: float, limit_s: float = 300) -> float:
    status = None
    while time.monotonic() - t0 < limit_s:
        status, _ = http_get(port, "/ready")
        if status == 200:
            return time.monotonic() - t0
        time.sleep(0.05)
    raise AssertionError(f"/ready answered {status}")


def csv_lines(np, rows, fmt: str) -> list:
    import io

    buf = io.StringIO()
    np.savetxt(buf, rows, fmt=fmt, delimiter=",")
    return buf.getvalue().splitlines()


def parsed(np, lines: list):
    """The f32 rows a server parses from CSV lines."""
    return np.asarray([[float(v) for v in ln.split(",")] for ln in lines], np.float32)


def f64_assign(np, x, c):
    """float64 squared distances, nearest center, and the expansion's scale
    per point (|x|^2 + max |c|^2)."""
    x, c = x.astype(np.float64), c.astype(np.float64)
    d2 = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None, :]
    return d2, d2.argmin(1), (x * x).sum(1) + (c * c).sum(1).max()


def near_ties(np, d2, ids_ref, ids_got, scale) -> int:
    """Count of points assigned otherwise than float64; each must be a near
    tie (its two distances within NEAR_TIE_D2 of the scale)."""
    rows = np.nonzero(ids_ref != ids_got)[0]
    gap = d2[rows, ids_got[rows]] - d2[rows, ids_ref[rows]]
    check(bool((gap <= NEAR_TIE_D2 * scale[rows]).all()),
          f"{len(rows)} points assigned otherwise than float64, not near ties")
    return len(rows)


def lloyd_check(torch, np, points_d, centers) -> dict:
    """One Lloyd iteration on the device from ``centers`` over a slice of
    the points, against the same iteration in float64 numpy (a point whose
    two nearest centers tie within NEAR_TIE_D2 goes where the device put
    it)."""
    from oryx_tpu_torch.ops.kmeans import assign_clusters, lloyd

    sl = points_d[:LLOYD_CHECK_POINTS]
    ones = torch.ones(len(sl), dtype=torch.float32, device=sl.device)
    got, counts = lloyd(sl, ones, centers, iterations=1)
    got, counts = got.cpu().numpy(), counts.cpu().numpy()
    ids_dev = assign_clusters(sl, centers)[0].cpu().numpy()
    x = sl.cpu().numpy().astype(np.float64)
    d2, ids_ref, scale = f64_assign(np, x, centers)
    flips = near_ties(np, d2, ids_ref, ids_dev, scale)
    ids = np.where(ids_ref != ids_dev, ids_dev, ids_ref)
    k = len(centers)
    sums = np.zeros((k, x.shape[1]))
    np.add.at(sums, ids, x)
    n = np.bincount(ids, minlength=k).astype(np.float64)
    ref = np.where(n[:, None] > 0, sums / np.maximum(n, 1)[:, None], centers)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(err <= LLOYD_RTOL, f"one Lloyd iteration {err} from float64")
    check(bool((counts == n).all()), "Lloyd counts differ from float64")
    return {"points": len(sl), "max_rel_err": err, "near_tie_points": flips}


def kmeans_phase(torch, np, root: Path, device="cuda", shape=KMEANS_SHAPE,
                 app_points=KMEANS_APP_POINTS, requests=APP_REQUESTS,
                 speed_events=APP_SPEED_EVENTS) -> dict:
    """Phase 7: build_and_evaluate_kmeans at the bench's shape on the card,
    one traced build, one Lloyd iteration against float64; then the kmeans
    app on a file:// bus: a generation, /assign over HTTP, speed UPs."""
    from oryx_tpu_torch.apps.kmeans.batch import KMeansUpdate
    from oryx_tpu_torch.apps.kmeans.serving import KMeansServingModelManager
    from oryx_tpu_torch.apps.kmeans.speed import KMeansSpeedModelManager
    from oryx_tpu_torch.bus import TopicProducer, get_broker
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.layers import BatchLayer, SpeedLayer
    from oryx_tpu_torch.ml.quality import build_and_evaluate_kmeans
    from oryx_tpu_torch.ops.kmeans import online_update, train_kmeans
    from oryx_tpu_torch.serving.server import ServingLayer

    cuda = device == "cuda"
    out = {"phase": "kmeans", "shape": shape, "replaces": KMEANS_REPLACES}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = build_and_evaluate_kmeans(**shape, device=device)
    out.update({"build_s": rep.build_s, **rep.timings,
                "sse_ratio": rep.sse_ratio, "silhouette": rep.silhouette,
                "wall_s": time.perf_counter() - t0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None})
    check(rep.sse_ratio <= SSE_RATIO_MAX, f"k-means SSE ratio {rep.sse_ratio}")
    check(rep.silhouette >= SILHOUETTE_MIN, f"k-means silhouette {rep.silhouette}")
    out["lloyd_vs_float64"] = lloyd_check(torch, np, rep.points_device,
                                          rep.model.centers)
    points = rep.points_device.cpu().numpy()
    if cuda:
        out["profile"] = build_profile(torch, lambda: train_kmeans(
            points, k=shape["k"], iterations=shape["iterations"], device=device))
    del rep
    out["mesh"] = kmeans_mesh_leg(torch, np, points, shape, device=device)

    dims = shape["dims"]
    cfg, bus = app_config(root, "kmeans", {
        "oryx.input-schema.num-features": dims,
        "oryx.input-schema.numeric-features": [str(j) for j in range(dims)],
        "oryx.kmeans.hyperparams.k": shape["k"],
        "oryx.kmeans.iterations": shape["iterations"],
    })
    cpu = {"device": "cpu"} if not cuda else None
    inputs = TopicProducer(get_broker(bus), cfg.get_string("oryx.input-topic.message.topic"))
    layers = []
    app = {"points": app_points}
    try:
        batch = BatchLayer(cfg, update=KMeansUpdate(cfg, **cpu) if cpu else None)
        layers.append(batch)
        batch.ensure_streams()
        lines = csv_lines(np, points[:app_points], "%.5f")
        inputs.send_batch((None, line) for line in lines)
        ts = int(time.time() * 1000)
        t = time.perf_counter()
        check(batch.run_generation(ts) == app_points, "generation read short")
        app["generation_s"] = time.perf_counter() - t
        t_pub = time.monotonic()
        batch.close()
        emit({"phase": "seq-generation", **app})
        art = ModelArtifact.read(root / "model" / str(ts))
        centers = np.asarray(art.tensors["centers"], np.float32)
        check(centers.shape == (shape["k"], dims), f"published {centers.shape}")

        serving = ServingLayer(cfg, model_manager=KMeansServingModelManager(
            cfg, **cpu) if cpu else None)
        layers.append(serving)
        serving.start()
        port = serving.port
        app["publish_to_ready_s"] = wait_ready(port, t_pub)

        # /assign against the float64 nearest center of the published model
        rng = np.random.default_rng(SEED + 7)
        sent = csv_lines(np, points[rng.choice(app_points, requests, replace=False)]
                         + rng.normal(0, 0.5, (requests, dims)), "%.5f")
        probe = parsed(np, sent)  # the values as the server holds them
        ids, lat = [], []
        for datum in sent:
            t = time.perf_counter()
            status, body = http_get(port, f"/assign/{datum}")
            lat.append((time.perf_counter() - t) * 1e3)
            check(status == 200, f"/assign answered {status}")
            ids.append(int(json.loads(body)))
        d2, ids_ref, scale = f64_assign(np, probe, centers)
        lat.sort()
        app["assign"] = {"requests": requests, "p50_ms": quantile(lat, 0.5),
                         "p99_ms": quantile(lat, 0.99),
                         "near_tie_points": near_ties(np, d2, ids_ref,
                                                      np.asarray(ids), scale)}

        # speed: events around one center, its UP applied by serving
        speed = SpeedLayer(cfg, manager=KMeansSpeedModelManager(
            cfg, **cpu) if cpu else None)
        layers.append(speed)
        speed.start()
        t = time.monotonic()
        while speed.manager._model is None and time.monotonic() - t < 120:
            time.sleep(0.05)
        check(speed.manager._model is not None, "speed model never loaded")
        target = int(np.argmax(np.asarray(art.content["counts"])))
        count0 = int(art.content["counts"][target])
        sent = csv_lines(np, centers[target] + rng.normal(0.5, 0.05, (speed_events, dims)),
                         "%.5f")
        ev = parsed(np, sent)
        t_write = time.monotonic()
        inputs.send_batch((None, line) for line in sent)
        n = speed.run_batch()
        check(n == speed_events, f"speed read {n} events")
        evd2, evids, _ = f64_assign(np, ev, centers)
        check(bool((evids == target).all()), "speed events left the target cluster")
        want, total = online_update(centers[target].astype(np.float64), count0,
                                    ev.mean(axis=0), speed_events)
        moved = None
        while time.monotonic() - t_write < 60:
            model = serving.model_manager.get_model()
            if int(model.counts[target]) == total:
                moved = model.centers[target].copy()
                break
            time.sleep(0.01)
        app["event_to_moved_s"] = time.monotonic() - t_write
        check(moved is not None, "serving never applied the speed UP")
        shift = float(np.abs(moved - centers[target]).max())
        err = float(np.abs(moved - want).max())
        check(shift > 0.05 and err <= 1e-5, f"center moved {shift}, {err} from expected")
        datum = csv_lines(np, want[None].astype(np.float32), "%.5f")[0]
        status, body = http_get(port, "/distanceToNearest/" + datum)
        check(status == 200, f"/distanceToNearest answered {status}")
        # the served distance is the f32 expansion |x|^2 - 2 x.c + |c|^2
        # (ops/kmeans.py, as in the JAX package), good to NEAR_TIE_D2 of
        # its scale: the moved center must lie within that, the old one
        # outside it
        point = parsed(np, [datum]).astype(np.float64)
        now = centers.astype(np.float64)
        now[target] = moved
        _, _, scale = f64_assign(np, point, now)
        bound = NEAR_TIE_D2 * float(scale[0])
        old_d2 = float(((point[0] - centers[target]) ** 2).sum())
        served = float(json.loads(body))
        check(old_d2 > bound and served ** 2 <= bound,
              f"/distanceToNearest does not see the moved center: {served} "
              f"(roundoff bound {bound ** 0.5}, old center at {old_d2 ** 0.5})")
        app["speed"] = {"events": speed_events, "center_shift": shift,
                        "max_err_vs_online_update": err,
                        "distance_to_nearest": served,
                        "distance_bound": bound ** 0.5,
                        "old_center_distance": old_d2 ** 0.5}
    finally:
        for layer in layers:
            layer.close()
    out["app"] = app
    return out


# ---------------------------------------------------------------------------
# phase 8: RDF (the batch build at UCI-covertype shape, then the app)
# ---------------------------------------------------------------------------

RDF_SHAPE = {"num_trees": 10, "max_depth": 10}  # 581,012 x 54, 7 classes
RDF_REPLACES = "oryx_tpu/ops/rdf.py:208"  # _grow_one_tree: torch ops, no Pallas kernel
RDF_ACC_FLOOR = 0.88  # tests/test_quality_gate.py:78
RDF_APP_EXAMPLES = 100_000


def rdf_phase(torch, np, root: Path, device="cuda", shape=RDF_SHAPE,
              n_examples=None, app_examples=RDF_APP_EXAMPLES,
              requests=APP_REQUESTS, speed_events=APP_SPEED_EVENTS) -> dict:
    """Phase 8: build_and_evaluate_rdf at UCI-covertype shape on the card,
    one traced growth, route_binned_device against route_binned; then the
    rdf app on a file:// bus: a generation, /predict and
    /classificationDistribution over HTTP, speed UPs into the leaf
    counts."""
    from oryx_tpu_torch.apps.rdf.batch import RDFUpdate
    from oryx_tpu_torch.apps.rdf.common import artifact_to_model
    from oryx_tpu_torch.apps.rdf.serving import RDFServingModelManager
    from oryx_tpu_torch.apps.rdf.speed import RDFSpeedModelManager
    from oryx_tpu_torch.apps.schema import InputSchema
    from oryx_tpu_torch.bus import TopicProducer, get_broker
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.layers import BatchLayer, SpeedLayer
    from oryx_tpu_torch.ml.quality import build_and_evaluate_rdf
    from oryx_tpu_torch.ops.rdf import (
        class_probs_from_leaves, grow_forest, route_binned, route_binned_device)
    from oryx_tpu_torch.serving.server import ServingLayer

    cuda = device == "cuda"
    kw = {} if n_examples is None else {"n_examples": n_examples}
    out = {"phase": "rdf", "shape": {**shape, "examples": n_examples or 581_012,
                                     "features": 54, "classes": 7, "bins": 32,
                                     "feature_subset": 14},
           "replaces": RDF_REPLACES}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = build_and_evaluate_rdf(**shape, **kw, device=device)
    out.update({"build_s": rep.build_s, **rep.timings, "accuracy": rep.accuracy,
                "accuracy_ceiling": rep.accuracy_ceiling,
                "wall_s": time.perf_counter() - t0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None})
    check(rep.accuracy >= RDF_ACC_FLOOR, f"RDF accuracy {rep.accuracy}")
    f = rep.forest
    t = time.perf_counter()
    leaves = route_binned_device(
        torch.from_numpy(f.feature).to(device), torch.from_numpy(f.split_left).to(device),
        torch.from_numpy(rep.test_binned).to(device), f.max_depth).cpu().numpy()
    out["route_device_s"] = time.perf_counter() - t
    t = time.perf_counter()
    host = route_binned(f.feature, f.split_left, rep.test_binned, f.max_depth)
    out["route_host_s"] = time.perf_counter() - t
    check(np.array_equal(leaves, host), "route_binned_device != route_binned")
    out["route_rows"] = len(rep.test_binned)
    if cuda:
        out["profile"] = build_profile(torch, lambda: grow_forest(
            rep.data, rep.y_train, num_trees=shape["num_trees"],
            max_depth=shape["max_depth"], impurity="entropy", n_classes=7,
            feature_subset=14, device=device))
    out["mesh"] = rdf_mesh_leg(torch, np, rep.data, rep.y_train, shape,
                               device=device)

    # the app: covertype-width lines (54 numeric features and the class)
    rng = np.random.default_rng(SEED + 8)
    x = rng.standard_normal((app_examples, 54)).astype(np.float32)
    y = ((x[:, 0] > 0) * 4 + (x[:, 7] > 0.5) * 2 + (x[:, 21] > -0.5)
         + (x[:, 40] > 0.3)) % 7
    y = np.where(rng.random(app_examples) < 0.1, rng.integers(0, 7, app_examples), y)
    names = [f"f{j}" for j in range(54)]
    cfg, bus = app_config(root, "rdf", {
        "oryx.input-schema.feature-names": names + ["cover"],
        "oryx.input-schema.numeric-features": names,
        "oryx.input-schema.target-feature": "cover",
        "oryx.rdf.num-trees": shape["num_trees"],
        "oryx.rdf.hyperparams.max-depth": shape["max_depth"],
        "oryx.rdf.hyperparams.max-split-candidates": 32,
        "oryx.rdf.hyperparams.impurity": "entropy",
        "oryx.rdf.hyperparams.feature-subset": 14,
    })
    cpu = {"device": "cpu"} if not cuda else None
    inputs = TopicProducer(get_broker(bus), cfg.get_string("oryx.input-topic.message.topic"))
    lines = [f"{row},c{int(label)}" for row, label in
             zip(csv_lines(np, x, "%.4f"), y)]
    layers = []
    app = {"examples": app_examples}
    try:
        batch = BatchLayer(cfg, update=RDFUpdate(cfg, **cpu) if cpu else None)
        layers.append(batch)
        batch.ensure_streams()
        inputs.send_batch((None, line) for line in lines)
        ts = int(time.time() * 1000)
        t = time.perf_counter()
        check(batch.run_generation(ts) == app_examples, "generation read short")
        app["generation_s"] = time.perf_counter() - t
        t_pub = time.monotonic()
        batch.close()
        emit({"phase": "seq-generation", **app})
        art = ModelArtifact.read(root / "model" / str(ts))
        ref = artifact_to_model(art, InputSchema(cfg), device="cpu")

        serving = ServingLayer(cfg, model_manager=RDFServingModelManager(
            cfg, **cpu) if cpu else None)
        layers.append(serving)
        serving.start()
        port = serving.port
        app["publish_to_ready_s"] = wait_ready(port, t_pub)

        # /predict and /classificationDistribution against the host path
        probe = [ln.rsplit(",", 1)[0] + "," for ln in
                 (lines[j] for j in rng.choice(app_examples, requests, replace=False))]
        pred_lat, dist_lat, worst = [], [], 0.0
        for datum in probe:
            binned = ref.datum_to_binned(datum)
            want = class_probs_from_leaves(ref.forest, route_binned(
                ref.forest.feature, ref.forest.split_left, binned,
                ref.forest.max_depth))[0]
            t = time.perf_counter()
            status, body = http_get(port, f"/predict/{datum}")
            pred_lat.append((time.perf_counter() - t) * 1e3)
            check(status == 200, f"/predict answered {status}")
            check(json.loads(body) == ref.encodings.decode(
                ref.schema.target_index, int(np.argmax(want))), "/predict differs")
            t = time.perf_counter()
            status, body = http_get(port, f"/classificationDistribution/{datum}")
            dist_lat.append((time.perf_counter() - t) * 1e3)
            check(status == 200, f"/classificationDistribution answered {status}")
            got = dict(json.loads(body))
            for code, p in enumerate(want):
                worst = max(worst, abs(got[ref.encodings.decode(
                    ref.schema.target_index, code)] - p))
        check(worst <= 1e-6, f"/classificationDistribution {worst} from the host")
        pred_lat.sort()
        dist_lat.sort()
        app["predict"] = {"requests": requests, "p50_ms": quantile(pred_lat, 0.5),
                          "p99_ms": quantile(pred_lat, 0.99)}
        app["distribution"] = {"requests": requests,
                               "p50_ms": quantile(dist_lat, 0.5),
                               "p99_ms": quantile(dist_lat, 0.99),
                               "max_abs_err": worst}

        # speed: labeled events folded into the served leaf counts
        speed = SpeedLayer(cfg, manager=RDFSpeedModelManager(cfg, **cpu) if cpu else None)
        layers.append(speed)
        speed.start()
        t = time.monotonic()
        while speed.manager.model is None and time.monotonic() - t < 120:
            time.sleep(0.05)
        check(speed.manager.model is not None, "speed model never loaded")
        before = float(serving.model_manager.get_model().rdf.forest.class_counts.sum())
        ups = []
        real = speed.manager.build_updates

        def build_updates(records):
            built = real(records)
            ups.extend(built)
            return built
        speed.manager.build_updates = build_updates
        t_write = time.monotonic()
        inputs.send_batch((None, lines[j]) for j in range(speed_events))
        check(speed.run_batch() == speed_events, "speed read short")
        added = sum(sum(json.loads(m)[2].values()) for _, m in ups)
        check(added == shape["num_trees"] * speed_events,
              f"speed UPs carry {added} counts")
        applied = None
        while time.monotonic() - t_write < 60:
            now = float(serving.model_manager.get_model().rdf.forest.class_counts.sum())
            if now == before + added:
                applied = now
                break
            time.sleep(0.01)
        app["event_to_applied_s"] = time.monotonic() - t_write
        check(applied is not None, "serving never applied the speed UPs")
        app["speed"] = {"events": speed_events, "up_rows": len(ups),
                        "counts_added": added}
    finally:
        for layer in layers:
            layer.close()
    out["app"] = app
    return out


# ---------------------------------------------------------------------------
# phase 9: seq (the GRU trainer's quality gate and bench shape, then the app)
# ---------------------------------------------------------------------------

SEQ_HIT_RATE_FLOOR = 0.65  # tests/test_quality_gate.py:164, at the harness defaults
SEQ_BENCH_SHAPE = {"n_items": 20_000, "n_sessions": 20_000, "session_len": 10,
                   "epochs": 10}  # bench.py's accelerator shape
SEQ_BENCH_FLOOR = 0.5  # not calibrated at this shape; chance is 0.0005
SEQ_REPLACES = "oryx_tpu/ops/seq.py:105"  # _adagrad_step: torch ops, no Pallas kernel
SEQ_CPU_EXAMPLES = 16_384  # the card-against-CPU training check's slice
SEQ_TRAIN_ATOL = 1e-3  # E and GRU weights, card against CPU, after 2 epochs
# the app leg: bench.py's ingest shape (sessions x events over items) with
# its sessions cut from 40,000 to 20,000 (240,000 events; the 480,000 took
# 48.0 s of generation on an NVIDIA H100 80GB HBM3 at 700.00 W) and
# oryx.seq.hyperparams.epochs cut from 30 to 5, to fit the time limit
SEQ_APP = {"n_items": 50_000, "n_sessions": 20_000, "session_len": 12, "epochs": 5}
SEQ_VALUE_ATOL = 1e-4  # served scores against float64
SEQ_BF16_REL = 2.0 ** -7  # the bf16 scan's rounding: 2^-9 per operand, two
# operands, two scores compared
SEQ_BURST = 1024  # cut from 2,048 (38.3 s against 16.2 s) to fit phases 5c and 11


def gru64(np, params: dict, vecs, mask):
    """The GRU of ops/seq.py in float64 numpy: (z, r, n) gates, the bias on
    the x side, masked steps carry h."""
    wx, wh, b = (np.asarray(params[k], np.float64) for k in ("Wx", "Wh", "b"))
    d = wh.shape[0]
    h = np.zeros((vecs.shape[0], d))
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    for t in range(vecs.shape[1]):
        gx = vecs[:, t] @ wx + b
        gh = h @ wh
        z = sig(gx[:, :d] + gh[:, :d])
        r = sig(gx[:, d:2 * d] + gh[:, d:2 * d])
        n = np.tanh(gx[:, 2 * d:] + r * gh[:, 2 * d:])
        h = np.where(mask[:, t, None] > 0, (1.0 - z) * n + z * h, h)
    return h


def seq_next_check(np, e, params, row_of, contexts, served, how_many, window) -> dict:
    """Hold served /recommend-next pages against a float64 GRU + ranking of
    the whole catalog of the published weights. Exact mode selects its
    candidates in a bf16 scan and re-ranks them in f32, so a served item
    may differ from the float64 ranking's only where the two items' scores
    lie within the scan's rounding (SEQ_BF16_REL of sum |h_i e_i|, both
    operands rounded); recall@10 holds the exact mode's floor; every
    served value is within SEQ_VALUE_ATOL of its float64 score."""
    e64 = np.asarray(e, np.float64)
    d = e64.shape[1]
    vecs = np.zeros((len(contexts), window, d))
    mask = np.zeros((len(contexts), window))
    for j, ctx in enumerate(contexts):
        rows = [row_of[i] for i in ctx[-window:]]
        vecs[j, window - len(rows):] = e64[rows]
        mask[j, window - len(rows):] = 1.0
    h = gru64(np, params, vecs, mask)
    val_err, flips, hits, worst = 0.0, 0, 0, 0.0
    for j, (ctx, pairs) in enumerate(zip(contexts, served)):
        s = e64 @ h[j]
        s[[row_of[i] for i in ctx]] = -np.inf  # the session's own items
        ref = np.argsort(-s, kind="stable")[:how_many]
        check(len(pairs) == how_many, f"/recommend-next served {len(pairs)}")
        got_rows = [row_of[ident] for ident, _v in pairs]
        hits += len(set(got_rows) & set(ref.tolist()))
        for slot, ((ident, value), row) in enumerate(zip(pairs, got_rows)):
            val_err = max(val_err, abs(value - s[row]))
            if row != ref[slot]:
                flips += 1
                scale = max(np.abs(e64[r] * h[j]).sum() for r in (row, ref[slot]))
                worst = max(worst, abs(s[row] - s[ref[slot]]) / scale)
                check(abs(s[row] - s[ref[slot]]) <= SEQ_BF16_REL * scale,
                      f"/recommend-next slot {slot}: {ident} scores {s[row]}, "
                      f"float64 ranks row {ref[slot]} at {s[ref[slot]]}")
    recall = hits / (how_many * len(served))
    check(val_err <= SEQ_VALUE_ATOL, f"served scores {val_err} from float64")
    check(recall >= MIN_RECALL["exact"], f"/recommend-next recall@10 {recall}")
    return {"requests": len(served), "recall_at_10": recall,
            "max_abs_err_vs_f64": val_err, "slots_off_f64_order": flips,
            "worst_gap_over_sum_abs": worst}


def seq_lines(sessions, t0_ms: int) -> list:
    """bench.py's session event lines: user, session, item, ts."""
    return [f"u{j % 997},s{j},i{it},{t0_ms + j * 100 + t}"
            for j, s in enumerate(sessions) for t, it in enumerate(s)]


def seq_phase(torch, np, T, root: Path, device="cuda", gate=None,
              bench=SEQ_BENCH_SHAPE, app_shape=SEQ_APP, requests=APP_REQUESTS,
              burst_requests=SEQ_BURST, speed_events=APP_SPEED_EVENTS,
              cpu_examples=SEQ_CPU_EXAMPLES) -> dict:
    """Phase 9: build_and_evaluate_seq at its defaults (the calibrated gate)
    and at the bench's shape on the card, one traced epoch, the card's
    train_gru against the CPU's from one warm start; then the seq app on a
    file:// bus: a generation, /recommend-next over HTTP against float64, a
    burst, speed UPs with a never-seen item."""
    from oryx_tpu_torch.apps.seq.batch import SeqUpdate
    from oryx_tpu_torch.apps.seq.common import windowed_examples
    from oryx_tpu_torch.apps.seq.serving import SeqServingModelManager
    from oryx_tpu_torch.apps.seq.speed import SeqSpeedModelManager
    from oryx_tpu_torch.apps.updates import parse_update_message
    from oryx_tpu_torch.bus import TopicProducer, get_broker
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.layers import BatchLayer, SpeedLayer
    from oryx_tpu_torch.ml.quality import build_and_evaluate_seq, synthesize_sessions
    from oryx_tpu_torch.ops.seq import train_gru
    from oryx_tpu_torch.serving.server import ServingLayer

    cuda = device == "cuda"
    out = {"phase": "seq", "replaces": SEQ_REPLACES, "dim": 32, "window": 8}

    # a. the calibrated gate at the harness's defaults
    rep = build_and_evaluate_seq(device=device, **(gate or {}))
    out["gate"] = {"hit_rate": rep.hit_rate, "floor": SEQ_HIT_RATE_FLOOR,
                   "chance": rep.chance, "build_s": rep.build_s,
                   "examples": rep.examples, "epochs": rep.epochs_run,
                   "items": rep.n_items, "sessions": rep.n_sessions}
    check(rep.hit_rate >= SEQ_HIT_RATE_FLOOR, f"seq gate hit-rate {rep.hit_rate}")

    # b. the bench's shape, one traced epoch, the card against the CPU
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rep = build_and_evaluate_seq(device=device, **bench)
    out["bench"] = {**bench, "hit_rate": rep.hit_rate, "chance": rep.chance,
                    "floor": SEQ_BENCH_FLOOR, "build_s": rep.build_s,
                    "window_s": rep.window_s, "examples": rep.examples,
                    "steps": bench["epochs"] * -(-rep.examples // 1024),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    check(rep.hit_rate > SEQ_BENCH_FLOOR, f"seq bench hit-rate {rep.hit_rate}")
    model = rep.model
    sessions = synthesize_sessions(bench["n_items"], bench["n_sessions"],
                                   bench["session_len"])
    item_to_row = {str(i): i for i in range(bench["n_items"])}
    ctx, mask, tgt = windowed_examples(
        {f"s{j}": [str(i) for i in s] for j, s in enumerate(sessions)},
        item_to_row, 8)
    kw = dict(n_items=bench["n_items"], dim=32, item_ids=model.item_ids,
              resume_e=model.e, resume_params=model.params)
    if cuda:
        out["bench"]["profile"] = build_profile(torch, lambda: train_gru(
            ctx, mask, tgt, epochs=1, device=device,
            seed_key=torch.Generator().manual_seed(SEED), **kw))
    got = {}
    t = time.perf_counter()
    for dev in ({device, "cpu"}):
        got[dev], _ = train_gru(
            ctx[:cpu_examples], mask[:cpu_examples], tgt[:cpu_examples],
            epochs=2, device=dev, seed_key=torch.Generator().manual_seed(SEED), **kw)
    err = max([float(np.abs(got[device].e - got["cpu"].e).max())]
              + [float(np.abs(got[device].params[k] - got["cpu"].params[k]).max())
                 for k in model.params])
    moved = float(np.abs(got["cpu"].e - model.e).max())
    out["bench"]["card_vs_cpu"] = {"examples": min(cpu_examples, len(tgt)),
                                   "seconds": time.perf_counter() - t,
                                   "epochs": 2, "max_abs_err": err,
                                   "atol": SEQ_TRAIN_ATOL, "max_moved": moved}
    check(err <= SEQ_TRAIN_ATOL and moved > SEQ_TRAIN_ATOL,
          f"train_gru on the card {err} from the CPU's (weights moved {moved})")
    del rep, model, got, ctx, mask, tgt, sessions
    if cuda:
        torch.cuda.empty_cache()
    emit({"phase": "seq-builds", "gate": out["gate"], "bench": out["bench"]})

    # c. the app on a file:// bus
    cfg, bus = app_config(root, "seq", {
        "oryx.seq.hyperparams.dim": 32, "oryx.seq.window": 8,
        "oryx.seq.hyperparams.epochs": app_shape["epochs"],
        # /ready only once every published row is in the view: the answers
        # are held against the whole published catalog
        "oryx.serving.min-model-load-fraction": 1.0,
    })
    cpu = {"device": "cpu"} if not cuda else None
    inputs = TopicProducer(get_broker(bus), cfg.get_string("oryx.input-topic.message.topic"))
    update_topic = cfg.get_string("oryx.update-topic.message.topic")
    layers = []
    app = {**app_shape}
    try:
        batch = BatchLayer(cfg, update=SeqUpdate(cfg, **cpu) if cpu else None)
        layers.append(batch)
        batch.ensure_streams()
        sessions = synthesize_sessions(app_shape["n_items"], app_shape["n_sessions"],
                                       app_shape["session_len"], seed=5)
        ts = int(time.time() * 1000)
        t = time.perf_counter()
        lines = seq_lines(sessions, ts - 86_400_000)
        inputs.send_batch((None, line) for line in lines)
        app["events"] = len(lines)
        app["write_s"] = time.perf_counter() - t
        t = time.perf_counter()
        check(batch.run_generation(ts) == len(lines), "generation read short")
        app["generation_s"] = time.perf_counter() - t
        t_pub = time.monotonic()
        batch.close()
        emit({"phase": "seq-generation", **app})
        art = ModelArtifact.read(root / "model" / str(ts))
        e = np.asarray(art.tensors["E"], np.float32)
        params = {k: np.asarray(art.tensors[k]) for k in ("Wx", "Wh", "b")}
        ids = art.get_extension_list("ItemIDs")
        row_of = {i: r for r, i in enumerate(ids)}
        check(e.shape == (len(ids), 32), f"published E {e.shape}")

        serving = ServingLayer(cfg, model_manager=SeqServingModelManager(
            cfg, **cpu) if cpu else None)
        layers.append(serving)
        serving.start()
        port = serving.port
        app["publish_to_ready_s"] = wait_ready(port, t_pub)
        served_model = serving.model_manager.get_model()
        if cuda:
            check(served_model._device_view[0].device.type == "cuda",
                  "the seq view is not on the card")

        # /recommend-next against float64, then a burst over HTTP
        rng = np.random.default_rng(SEED + 9)
        contexts = []
        for j in rng.permutation(len(sessions)):
            known = list(dict.fromkeys(
                f"i{it}" for it in sessions[j] if f"i{it}" in row_of))
            if known:
                contexts.append(known[:int(rng.integers(1, min(8, len(known)) + 1))])
            if len(contexts) == requests + burst_requests:
                break
        T.reset_launches()  # the app leg's serving window opens
        served, lat = [], []
        for c in contexts[:requests]:
            t = time.perf_counter()
            status, body = http_get(port, "/recommend-next/" + "/".join(c)
                                    + f"?howMany={HOW_MANY}")
            lat.append((time.perf_counter() - t) * 1e3)
            check(status == 200, f"/recommend-next answered {status}")
            served.append(json.loads(body))
        lat.sort()
        app["recommend_next"] = {
            **seq_next_check(np, e, params, row_of, contexts[:requests], served,
                             HOW_MANY, 8),
            "p50_ms": quantile(lat, 0.5), "p99_ms": quantile(lat, 0.99)}
        paths = ["/recommend-next/" + "/".join(c) + f"?howMany={HOW_MANY}"
                 for c in contexts[requests:]]
        rows = http_burst(port, paths)
        check(all(r[1] == 200 for r in rows), "a non-200 answer in the seq burst")
        check(all(len(r[4]) == HOW_MANY for r in rows), "a short seq answer")
        wall = max(r[3] for r in rows) - min(r[2] for r in rows)
        lat = sorted((r[3] - r[2]) * 1e3 for r in rows)
        app["burst"] = {"requests": len(rows), "wall_s": wall, "qps": len(rows) / wall,
                        "p50_ms": quantile(lat, 0.5), "p99_ms": quantile(lat, 0.99)}
        if cuda:
            torch.cuda.synchronize()
        out["launches"] = dict(T.LAUNCHES)  # ... and closes
        out["partial_launches_by_type"] = dict(T.PARTIAL_LAUNCHES_BY_TYPE)
        if cuda:
            check(all(v > 0 for v in out["launches"].values())
                  and out["partial_launches_by_type"]["bfloat16"] > 0,
                  f"the seq app launched {out['launches']}")
        # the GRU encode alone, per request, on the serving model's device
        enc = []
        for c in contexts[:requests]:
            t = time.perf_counter()
            served_model.encode(c)
            enc.append((time.perf_counter() - t) * 1e3)
        enc.sort()
        app["encode_ms"] = {"p50": quantile(enc, 0.5), "p99": quantile(enc, 0.99),
                            "mean": sum(enc) / len(enc)}

        # speed: 1,000 events, one of them a never-seen item, folded on the
        # card; serving applies every UP row and recommends the new item
        speed = SpeedLayer(cfg, manager=SeqSpeedModelManager(
            cfg, **cpu) if cpu else None)
        layers.append(speed)
        speed.start()
        t = time.monotonic()
        while time.monotonic() - t < 120:
            st = speed.manager.state
            if st is not None and st.fraction_loaded() >= 0.8:
                break
            time.sleep(0.05)
        check(speed.manager.state is not None, "seq speed model never loaded")
        broker = get_broker(bus)
        up_mark = broker.end_offsets(update_topic)[0]
        # sessions of 5 random catalog items, then one session [c, new]:
        # c is in no other event of the window, so the fold leaves its row
        # as it was, and /recommend-next/c encodes the very context whose
        # hidden state the new item's row was folded from
        t_ev = ts + 1000
        rand = [ids[int(j)] for j in rng.integers(0, len(ids), speed_events - 2)]
        c = next(i for i in (ids[int(j)] for j in rng.permutation(len(ids)))
                 if i not in set(rand))
        ev = [f"u{j // 5 % 97},sp{j // 5},{item},{t_ev + 10 * j}"
              for j, item in enumerate(rand)]
        ev += [f"unew,snew,{c},{t_ev + 10 * len(rand)}",
               f"unew,snew,i-new-seq,{t_ev + 10 * len(rand) + 1}"]
        t_write = time.monotonic()
        inputs.send_batch((None, line) for line in ev)
        n = speed.run_batch()
        check(n == len(ev) == speed_events, f"speed read {n} of {len(ev)} events")
        ups = [parse_update_message(msg) for _off, key, msg in
               broker.read(update_topic, 0, up_mark, 10 * speed_events)
               if key == "UP"]
        check(ups and any(u[1] == "i-new-seq" for u in ups),
              f"the speed fold published {len(ups)} UP rows, none for the new item")
        applied = None
        while time.monotonic() - t_write < 60:
            st = serving.model_manager.get_model().state
            got, have = st.items.get_many([u[1] for u in ups])
            if have.all() and all(np.allclose(got[j], u[2], atol=1e-6, rtol=0)
                                  for j, u in enumerate(ups)):
                applied = time.monotonic()
                break
            time.sleep(0.01)
        check(applied is not None, "serving never applied the seq speed UPs")
        app["event_to_applied_s"] = applied - t_write
        # the page for [c] against float64 over the rows serving now holds
        # (the published ones and the fold's), the new item among them
        status, body = http_get(port, f"/recommend-next/{c}?howMany={HOW_MANY}")
        check(status == 200, f"/recommend-next answered {status}")
        page = json.loads(body)
        mat, snap_ids, _v = st.items.snapshot()
        snap_row = {i: r for r, i in enumerate(snap_ids)}
        after = seq_next_check(np, mat, params, snap_row, [[c]], [page], HOW_MANY, 8)
        got = [p[0] for p in page]
        check("i-new-seq" in got, f"the new item is not recommended: {got}")
        app["speed"] = {"events": n, "up_rows": len(ups), "context": c,
                        "new_item_rank": got.index("i-new-seq") + 1,
                        "page_vs_f64": after}
    finally:
        for layer in layers:
            layer.close()
    out["app"] = app
    return out


# ---------------------------------------------------------------------------
# A/B of the http phase: python3 chip_smoke.py --ab-parent DIR [--ab-order ..]
# ---------------------------------------------------------------------------

# run kinds, one letter each in --ab-order: (checkout, what differs)
AB_VARIANTS = {
    "c": ("change", None),
    "p": ("parent", None),
    # the batcher's per-dispatch accounting: peak lookup, idle-gap
    # classification and records, dispatch records, the timeline
    "a": ("change", "accounting"),
    # the wedge watchdog's thread and the per-request device-span work
    "w": ("change", "watchdog"),
    # the burn-triggered profile capture (oryx.monitoring.perfattr.
    # burn-capture.enabled = false)
    "b": ("change", "burn-capture"),
    # the interpreter's thread switch interval cut from 5 ms to 0.5 ms
    # (sys.setswitchinterval): how long a thread that released the GIL
    # waits to take it back from the server's busy threads
    "s": ("change", "switch-interval"),
}


def ab_switch_off(what: str) -> None:
    """Stub one part of this checkout's serving telemetry, in this process
    only, before the shared batcher is built (a bisect run)."""
    from oryx_tpu_torch.serving import batcher as B

    def noop(*_a, **_k):
        return None

    if what == "accounting":
        B._PERF = SimpleNamespace(set_peak=noop, record_dispatch=noop)
        B._PA = SimpleNamespace(record_idle_gap=noop)
        B.classify_idle_gap = lambda *_a, **_k: {}
        B.TopKBatcher._peak_for_matrix = noop
        init = B.TopKBatcher.__init__

        def init_without_timeline(self, *a, **k):
            init(self, *a, **k)
            self.timeline = SimpleNamespace(append=noop)

        B.TopKBatcher.__init__ = init_without_timeline
    elif what == "watchdog":
        B.TopKBatcher._ensure_watchdog = noop
        B._Pending.finish_dev_span = noop


def ab_run(root: Path, label: str, variant: str) -> None:
    """One A/B run in this process, on the package of the checkout at
    root: per score mode (exact, then quantized) a ServingLayer at the
    smoke's full width and one timed burst of 2,048 GET /recommend from
    the load generators. One JSON line per mode."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import oryx_tpu_torch

    check(Path(oryx_tpu_torch.__file__).resolve().parents[1] == root,
          f"imported {oryx_tpu_torch.__file__}, not the package under {root}")
    from oryx_tpu_torch.ops import _build
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    _build.build_all()
    what = AB_VARIANTS[variant][1]
    if what in ("accounting", "watchdog"):
        ab_switch_off(what)
    elif what == "switch-interval":
        sys.setswitchinterval(0.0005)
    extra = ({"oryx.monitoring.perfattr.burn-capture.enabled": False}
             if what == "burn-capture" else {})
    users = np.random.default_rng(SEED + 2).choice(
        N_USERS, size=N_REQUESTS, replace=False)
    paths = [f"/recommend/u{int(u)}?howMany={HOW_MANY}" for u in users]
    with tempfile.TemporaryDirectory(prefix="oryx-ab-") as tmp:
        path, _data = write_model(np, Path(tmp))
        for mode in ("exact", "quantized"):
            layer, config, *_rest = start_http_layer(mode, path, extra)
            try:
                batcher = TopKBatcher.shared()
                d0, c0 = batcher.dispatches, batcher.coalesced
                t_m0, t_wall = time.monotonic(), time.time()
                rows = http_burst(layer.port, paths)
                t_m1 = time.monotonic()
                check(all(r[1] == 200 for r in rows), "non-200 in the burst")
                dispatches = batcher.dispatches - d0
                wall = max(r[3] for r in rows) - min(r[2] for r in rows)
                lat = sorted((r[3] - r[2]) * 1e3 for r in rows)
                out = {
                    "label": label, "variant": variant, "differs": what,
                    "mode": mode, "qps": len(rows) / wall,
                    "p50_ms": quantile(lat, 0.50),
                    "p99_ms": quantile(lat, 0.99), "dispatches": dispatches,
                    "mean_batch": (batcher.coalesced - c0) / dispatches,
                    "mean_cycle_ms": wall / dispatches * 1e3,
                }
                timeline = getattr(batcher, "timeline", None)
                if label == "change" and what != "accounting":
                    # the dispatcher's pieces from its first launch to its
                    # last results on the host, ms per dispatch
                    tl = [x for x in timeline if t_m0 <= x[1] and x[2] <= t_m1]
                    t_a = min(t0 for p, t0, _ in tl if p == "stage")
                    t_b = max(t1 for p, _, t1 in tl if p == "sync")
                    pieces = timeline_pieces(tl, t_a, t_b)
                    out["piece_ms"] = {k: v / dispatches * 1e3
                                       for k, v in pieces.items()}
                    out["accounted_share"] = sum(pieces.values()) / (t_b - t_a)
                    out["burn_captures"] = burn_captures(
                        config.get_string("oryx.monitoring.flight.dir"),
                        t_wall)
                emit(out)
            finally:
                layer.close()
        TopKBatcher.shared().close()


def ab(parent: Path, order: str) -> int:
    """Runs --ab-order's letters in sequence, each in a process of its own
    (AB_VARIANTS), then prints the median qps of each variant and mode.
    Each checkout builds its own kernels. Compare only within one call."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    print(nvidia_smi_line(), flush=True)
    runs: dict[str, list] = {}
    for letter in order:
        label, _what = AB_VARIANTS[letter]
        root = parent.resolve() if label == "parent" else here
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--ab-run",
             str(root), label, letter],
            capture_output=True, text=True, timeout=900)
        check(out.returncode == 0,
              f"run {letter} exited {out.returncode}:\n{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                runs.setdefault(f"{letter}/{row['mode']}", []).append(
                    row["qps"])
                print(line, flush=True)
    emit({"medians": {k: {"median_qps": statistics.median(v), "runs": v}
                      for k, v in runs.items()}})
    return 0


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
    lines, at_serving, at_single, at_seq = kernel_phase(torch, T)
    cross = cross_shard_case(torch, np, T)
    emit(cross)
    big_view = big_view_case(torch, T)
    emit(big_view)
    emit({"phase": "kernels-done", "checks": len(lines) + 3,
          "seconds": time.monotonic() - t0})

    # every artifact the relay assembles lands inside the checkout
    from oryx_tpu_torch.common.artifact import reset_artifact_relay

    shutil.rmtree(SMOKE_BUILD / "smoke-relay", ignore_errors=True)
    reset_artifact_relay(SMOKE_BUILD / "smoke-relay")

    serving = {}
    t0 = time.monotonic()
    gated = gate_phase(torch, np, T)
    gated["seconds"] = time.monotonic() - t0
    emit(gated)
    serving["gate"] = gated
    torch.cuda.empty_cache()

    t0 = time.monotonic()
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
        t1 = time.monotonic()
        sharded = shard_phase(torch, np, T, path, users, exact_rows)
        sharded["seconds"] = time.monotonic() - t1
        emit(sharded)
        serving["sharded"] = sharded
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
        sampled = lsh_phase(torch, np, T, path, model_data, users, exact_rows)
        sampled["seconds"] = time.monotonic() - t0
        emit(sampled)
        t0 = time.monotonic()
        wedged = wedge_phase(torch, np, path, users)
        wedged["seconds"] = time.monotonic() - t0
        emit(wedged)

    t0 = time.monotonic()
    trained = train_phase(torch)
    trained["seconds"] = time.monotonic() - t0
    emit(trained)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    meshed = mesh_train_phase(torch, np)
    meshed["seconds"] = time.monotonic() - t0
    emit(meshed)
    torch.cuda.empty_cache()
    emit(collectives_phase(torch))
    t0 = time.monotonic()
    attended = attention_phase(torch, np)
    attended["seconds"] = time.monotonic() - t0
    emit(attended)
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
    torch.cuda.empty_cache()

    # the deployment over kafka://: separate CLI processes, replicas of their
    # own on the card
    t0 = time.monotonic()
    root = Path(__file__).resolve().parent / "build" / "smoke-kafka"
    shutil.rmtree(root, ignore_errors=True)
    try:
        kafka = kafka_phase(np, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kafka["seconds"] = time.monotonic() - t0
    emit(kafka)
    serving["kafka"] = kafka
    torch.cuda.empty_cache()

    # the seq app serves through the same shared batcher, so it runs before
    # the batcher closes
    t0 = time.monotonic()
    root = Path(__file__).resolve().parent / "build" / "smoke-seq"
    shutil.rmtree(root, ignore_errors=True)
    try:
        seq = seq_phase(torch, np, T, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seq["seconds"] = time.monotonic() - t0
    emit(seq)
    serving["seq"] = seq
    TopKBatcher.shared().close()
    torch.cuda.empty_cache()
    shutil.rmtree(SMOKE_BUILD / "smoke-relay", ignore_errors=True)

    for name, phase in (("kmeans", kmeans_phase), ("rdf", rdf_phase)):
        t0 = time.monotonic()
        root = Path(__file__).resolve().parent / "build" / f"smoke-{name}"
        shutil.rmtree(root, ignore_errors=True)
        try:
            line = phase(torch, np, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        line["seconds"] = time.monotonic() - t0
        emit(line)
        torch.cuda.empty_cache()

    launches = {
        name: sum(run["launches"][name] for run in serving.values())
        for name in T.LAUNCHES
    }
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    bf, i8 = at_serving["bfloat16"], at_serving["int8"]
    bf1 = at_single["bfloat16"]
    sq = at_seq["bfloat16"]

    def seq_case(kernel: str) -> dict:
        """the F = 32 case's readings of one kernel, and its launches in
        the seq phase (bf16: the seq view's type)"""
        return {"B": sq["B"], "I": sq["I"], "F": sq["F"], "k": sq["k"],
                "ms": sq[f"{kernel}_ms"], "wall_ms": sq[f"{kernel}_wall_ms"],
                "plain_ms": sq[f"{kernel}_plain_ms"],
                "bound_ms": sq[f"{kernel}_bound_ms"],
                "bound_by": sq[f"{kernel}_bound_by"],
                "library_ms": sq["library_ms" if kernel == "partial"
                                 else "merge_library_ms"],
                "launches_in_seq_phase": seq["launches"][
                    "topk_dot_partial" if kernel == "partial" else "topk_merge"]}
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
            "seq": seq_case("partial"),
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
            "seq": seq_case("merge"),
            # the merge across a sharded view's shards (phase 2a's shape;
            # launches in phase 3b and in the sharded fleet's replicas)
            "cross_shard": {
                "S": cross["shards"], "B": cross["B"], "k": cross["k"],
                "lists": cross["bfloat16"]["lists"],
                "launches": (sharded["launches"]["topk_merge"]
                             + serving["kafka"]["fleet"]["sharded_merges"]),
                "launches_in_phase_3b": sharded["launches"]["topk_merge"],
                **{key: cross["bfloat16"][key] for key in (
                    "ms", "wall_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "int8_ms": cross["int8"]["ms"],
            },
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


def cli(argv: list[str]) -> int:
    """No arguments: the smoke. --ab-parent DIR: the http A/B against the
    checkout unpacked at DIR (for example ``git archive <commit> | tar -x
    -C build/ab_parent``), in --ab-order's sequence of AB_VARIANTS letters."""
    if not argv:
        return main()
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--ab-parent", type=Path)
    ap.add_argument("--ab-order", default="pcabwwbacp")
    ap.add_argument("--ab-run", nargs=3, metavar=("ROOT", "LABEL", "VARIANT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if set(args.ab_order) - set(AB_VARIANTS):
        ap.error(f"--ab-order takes the letters {''.join(AB_VARIANTS)}")
    if args.ab_run:
        root, label, variant = args.ab_run
        ab_run(Path(root).resolve(), label, variant)
        return 0
    if args.ab_parent is None:
        ap.error("--ab-parent DIR is required")
    return ab(args.ab_parent, args.ab_order)


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
