"""Tiny cells for the CPU tests: the real manifest's cells, and the
parked training cell, with their configurations cut to a few thousand
rows, run through the systems on the CPU."""

from __future__ import annotations

import copy
import json
import time

import torch

from portbench import harness
from portbench.systems import RunSpec, Setup

SIZES = {
    "als_serving": {"items": 3000, "users": 400, "features": 16},
    "als_training": {"users": 300, "items": 200, "interactions": 2000, "features": 8,
                     "cap": 64, "block": 64},
}
TRAFFIC = {"http_closed_loop": {"clients": 4, "warmup_s": 0.3, "check_requests": 64}}


# The training cell, 10-sweep builds, is out of BENCHMARK.json while the
# program's 10-sweep build at 250 features blows up (PERF.md, Open
# questions). Its driver, reference, counts and readers stay and are
# tested here, so that it returns by a traffic file and manifest entries.
PARKED_TRAINING = {"name": "als-ml25m-250f.sweeps", "config": "als-ml25m-250f",
                   "traffic": {"kind": "als_builds", "sweeps_per_build": 10}}


def parked_training_cell() -> harness.Cell:
    p = PARKED_TRAINING
    conf = json.loads((harness.BENCH_DIR / "configs" / f"{p['config']}.json").read_text())
    return harness.Cell(name=p["name"], config_name=p["config"], traffic_name="sweeps",
                        chips=1, config=conf, traffic=dict(p["traffic"]),
                        end_to_end=[], per_layer=[])


def tiny_cell(workload: str) -> harness.Cell:
    """The cell ``workload`` of the manifest, or the parked training cell,
    at a tiny size."""
    if workload == PARKED_TRAINING["name"]:
        cell = parked_training_cell()
    else:
        cell = copy.deepcopy(harness.resolve(harness.load_manifest(), workload))
    cell.config.update(SIZES[cell.config["system"]])
    if "generator" in cell.config:  # a small catalog saturates sooner
        cell.config["generator"]["oversample"] = 4.0
    cell.traffic.update(TRAFFIC.get(cell.traffic["kind"], {}))
    return cell


def run_cell(cell: harness.Cell, seed: int = 12345, seconds: float = 1.0):
    system = harness.system_module(cell.config["system"])
    setup = Setup(time.monotonic())
    return system.run(RunSpec(cell, seed, seconds, False, torch.device("cpu"), setup)), setup
