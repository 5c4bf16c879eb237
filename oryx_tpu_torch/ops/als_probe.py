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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("als_probe needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)

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


if __name__ == "__main__":
    raise SystemExit(main())
