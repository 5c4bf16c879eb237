"""Compare two versions of the ALS trainer's sweeps on the card.

    python3 -m oryx_tpu_torch.ops.als_probe ab --parent OLD_als.py

``ab`` synthesizes one data set (ml/synth.py, seed 7; by default the
north-star shape, 162,000 users x 59,000 items x 25,000,000 interactions),
aggregates it, builds and uploads its bucketed lists once, and then runs
the sweeps of the parent module (an ops/als.py loaded from its path) and
of the checkout's in turns: parent, change, change, parent, each from the
same random Y, after one untimed sweep of each. One JSON line per run: the
sweeps' seconds to a synchronised end and the card's peak memory during
them; a repeated version's line says whether its factors and predictions
equal its first run's; the parent's lines give its factors' difference
from the change's (largest entry and Frobenius norm, each relative to the
change's) and that of the predictions x.y on the observed pairs (norm,
relative). The first line is the card's name and power limit.

    python3 -m oryx_tpu_torch.ops.als_probe seeds [--parent OLD_als.py]

``seeds`` holds out 2% of the same data as ml/quality.py's
``build_and_evaluate`` does and trains, for each compute type and each
seed of the random initial Y (``--seeds``, ``--dtypes``), the checkout's
sweeps and, with ``--parent``, the parent's, from the same Y. One JSON
line per build: its held-out AUC (the same users and negatives for every
build); summed over the sweeps, the rows whose f32 factorization failed
(the parent's jittered retries included) and, of those, the rows f64
could not factor either (jittered); the all-zero rows of the result;
both factor tables' Frobenius norms; and the sweeps' seconds.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

def _load(path: Path):
    spec = importlib.util.spec_from_file_location("als_parent", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    import torch

    from oryx_tpu_torch.ml.synth import synthesize_interactions
    from oryx_tpu_torch.ops import als as A

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ab = sub.add_parser("ab")
    ab.add_argument("--parent", required=True, type=Path)
    ab.add_argument("--shape", default="162000,59000,25000000")
    ab.add_argument("--dtype", default="bfloat16")
    ab.add_argument("--sweeps", type=int, default=10)
    sd = sub.add_parser("seeds")
    sd.add_argument("--parent", type=Path)
    sd.add_argument("--shape", default="162000,59000,25000000")
    sd.add_argument("--dtypes", default="bfloat16,float32")
    sd.add_argument("--seeds", default="0-11")
    sd.add_argument("--sweeps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("als_probe needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    if args.cmd == "seeds":
        return _seeds(args)

    n_u, n_i, nnz = (int(v) for v in args.shape.split(","))
    users, items, values = synthesize_interactions(n_u, n_i, nnz, seed=7)
    data = A.aggregate_interactions(users, items, values, implicit=True)
    lists = {}
    for tag, ent, oth, n in (("u", data.users, data.items, data.n_users),
                             ("i", data.items, data.users, data.n_items)):
        buckets, blocks = A.build_bucketed_lists(
            ent, oth, data.values, n, 1024, block=1024, unit=1024)
        lists[tag] = (A._upload_buckets(buckets, n, "cuda"), blocks)
    gen = torch.Generator(device="cuda").manual_seed(7)
    y0 = torch.randn((data.n_items, 50), generator=gen, device="cuda") * 0.1 + 50 ** -0.5

    mods = {"parent": _load(args.parent.resolve()), "change": A}
    kw = dict(implicit=True, blocks_u=lists["u"][1], blocks_i=lists["i"][1],
              n_u=data.n_users, compute_dtype=args.dtype)
    for mod in mods.values():  # one untimed sweep each brings up the libraries
        mod._als_train_bucketed(lists["u"][0], lists["i"][0], y0.clone(), 0.01,
                                1.0, iterations=1, **kw)
    pairs = (torch.from_numpy(data.users).cuda().long(),
             torch.from_numpy(data.items).cuda().long())
    first = {}
    for label in ("parent", "change", "change", "parent"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x, y = mods[label]._als_train_bucketed(
            lists["u"][0], lists["i"][0], y0.clone(), 0.01, 1.0,
            iterations=args.sweeps, **kw)
        torch.cuda.synchronize()
        line = {"version": label, "dtype": args.dtype, "shape": args.shape,
                "sweeps": args.sweeps, "train_s": time.perf_counter() - t0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        # the factors, and the predictions x.y on the observed pairs
        out = (torch.cat([x, y]), (x[pairs[0]] * y[pairs[1]]).sum(dim=1))
        if label in first:
            line["same_as_its_first_run"] = all(
                torch.equal(a, b) for a, b in zip(out, first[label]))
        else:
            first[label] = out
        if label == "parent" and "change" in first:
            (xy, pred), (xy_c, pred_c) = out, first["change"]
            line["factors_max_rel_diff_vs_change"] = (
                (xy - xy_c).abs().max() / xy_c.abs().max()).item()
            line["factors_fro_rel_diff_vs_change"] = (
                (xy - xy_c).norm() / xy_c.norm()).item()
            line["predictions_rel_diff_vs_change"] = (
                (pred - pred_c).norm() / pred_c.norm()).item()
        print(json.dumps(line), flush=True)
    return 0


def _seeds(args) -> int:
    import copy

    import numpy as np
    import torch

    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.ml.quality import holdout_auc
    from oryx_tpu_torch.ml.synth import synthesize_interactions
    from oryx_tpu_torch.ops import als as A

    n_u, n_i, nnz = (int(v) for v in args.shape.split(","))
    lo, _, hi = args.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    # build_and_evaluate's data, split and evaluation stream (seed 7)
    users, items, values = synthesize_interactions(n_u, n_i, nnz, seed=7)
    rng = np.random.default_rng(7 + 1_000_003)
    test_mask = rng.random(nnz) < 0.02
    tr = ~test_mask
    data = A.aggregate_interactions(users[tr], items[tr], values[tr], implicit=True)
    lists = {}
    for tag, ent, oth, n in (("u", data.users, data.items, data.n_users),
                             ("i", data.items, data.users, data.n_items)):
        buckets, blocks = A.build_bucketed_lists(
            ent, oth, data.values, n, 1024, block=1024, unit=1024)
        lists[tag] = (A._upload_buckets(buckets, n, "cuda"), blocks)
    mods = {"change": A}
    if args.parent is not None:
        mods["parent"] = _load(args.parent.resolve())
    counts = {"f32": [], "f64": []}

    def spy(real):
        def solve(a, b):
            x, ok = real(a, b)
            counts["f64" if a.dtype == torch.float64 else "f32"].append((~ok).sum())
            return x, ok
        return solve

    for mod in mods.values():
        mod.batched_spd_solve_ex = spy(mod.batched_spd_solve_ex)
    for dtype in args.dtypes.split(","):
        for seed in seeds:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            y0 = torch.randn((data.n_items, 50), generator=gen, device="cuda") * 0.1 + 50 ** -0.5
            for label, mod in mods.items():
                for c in counts.values():
                    c.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, y = mod._als_train_bucketed(
                    lists["u"][0], lists["i"][0], y0.clone(), 0.01, 1.0,
                    implicit=True, iterations=args.sweeps, blocks_u=lists["u"][1],
                    blocks_i=lists["i"][1], n_u=data.n_users, compute_dtype=dtype)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                model = A._finish_model(x.cpu().numpy(), y.cpu().numpy(),
                                        data.n_users, data.n_items, data)
                RandomManager.use_test_seed(123)  # the same negatives each build
                try:
                    auc = holdout_auc(model, users, items, test_mask, copy.deepcopy(rng))
                finally:
                    RandomManager.clear_test_seed()
                f64 = [int(c) for c in counts["f64"]]
                print(json.dumps({
                    "version": label, "dtype": dtype, "init_seed": seed, "auc": auc,
                    "failed_f32_rows": sum(int(c) for c in counts["f32"]),
                    "failed_f64_rows": sum(f64[0::2]),
                    "zero_rows": int((~model.x.any(axis=1)).sum()
                                     + (~model.y.any(axis=1)).sum()),
                    "x_norm": float(np.linalg.norm(model.x)),
                    "y_norm": float(np.linalg.norm(model.y)),
                    "train_s": train_s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
