"""The control of a cell's check, at the cell's own size: the plain
reference put in the program's place, one precision down, judged by the
same numbers the check compares.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3

- serving: the bfloat16 ranking of ``check_requests`` users drawn from
  the seed, against the float64 one;
- training: the reference's sweeps in float32 with TF32 products from
  the cell's interactions and starting factors, against float64.

One JSON line a seed. The benchmark's own runs never run this: it is how
the limits in the configuration files were set (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serving_control(cell, seed: int, device) -> dict:
    import numpy as np

    from portbench import gen
    from portbench.reference import topn

    cfg, traffic = cell.config, cell.traffic
    how_many = int(traffic["how_many"])
    rng = np.random.default_rng(gen.subseed(seed, "check"))
    users = np.sort(rng.choice(cfg["users"], size=int(traffic["check_requests"]), replace=False))
    none = np.full((len(users), how_many), -1, dtype=np.int64)
    ref, _, ctl = topn.reference_scores(seed, cfg, users, none, how_many, device, control=True)
    known = gen.known_items(seed, cfg["users"], cfg["items"], cfg["known_items_per_user"],
                            device)[users]
    return topn.judge(ref, ctl.ids, ctl.scores, ctl.true, known, how_many)


def training_control(cell, seed: int, device) -> dict:
    from portbench import gen
    from portbench.reference import als

    cfg = cell.config
    users, items, values = gen.interactions(seed, cfg["users"], cfg["items"],
                                            cfg["interactions"], cfg["generator"], device)
    y0 = gen.initial_y(seed, cfg["items"], cfg["features"], device)
    kw = dict(lam=cfg["lambda"], alpha=cfg["alpha"], sweeps=int(cell.traffic["sweeps_per_build"]),
              cap=cfg["cap"], device=device)
    x_ref, y_ref = als.train(users, items, values, cfg["users"], cfg["items"], y0, **kw)
    x_c, y_c = als.train(users, items, values, cfg["users"], cfg["items"], y0, tf32=True, **kw)
    return als.judge(x_c, y_c, x_ref, y_ref)


CONTROLS = {"als_serving": serving_control, "als_training": training_control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.resolve(harness.load_manifest(ROOT), args.workload, ROOT)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    control = CONTROLS[cell.config["system"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        try:
            numbers = control(cell, seed, device)
        except RuntimeError as e:  # a control that crashes has failed
            numbers = {"error": str(e)}
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers,
                          "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
