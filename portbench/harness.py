"""The harness's data: the manifest (``BENCHMARK.json``), the cell a run
names, and the pieces found by name under ``portbench/``:

- a configuration: the file its manifest entry names (``configs/``);
  its ``system`` key names the module of ``systems/`` that drives it;
- a traffic mix: ``traffic/<traffic>.json``, read by that system;
- a per-layer metric: ``metrics/<name>.py`` with ``read(ctx)``, which
  returns the value or None where it finds nothing to read;
- a count of operations and bytes: ``counts/<kernel>.py``.

Nothing here knows a cell, a configuration or a metric by name, so a
later one is added by files and a manifest entry alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "oryx_tpu")  # top-level module names


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its configuration, traffic mix and the
    metrics it reports: the end-to-end metrics that list it or list no
    cells, and the per-layer metrics that list it (each lists its cells).
    Raises KeyError for a name the manifest lacks."""
    w = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    layer = [m for m in manifest["per_layer"] if workload in m["workloads"]]
    return Cell(
        name=workload, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=e2e, per_layer=layer,
    )


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_module(name: str, root: Path = ROOT):
    return load_file_module(root / "portbench" / "systems" / f"{name}.py",
                            f"portbench_system_{name}")


def metric_reader(name: str, root: Path = ROOT):
    return load_file_module(root / "portbench" / "metrics" / f"{name}.py",
                            f"portbench_metric_{name}")


def counts(name: str, root: Path = ROOT):
    return load_file_module(root / "portbench" / "counts" / f"{name}.py",
                            f"portbench_counts_{name}")


@dataclass
class Context:
    """What a per-layer reader sees: the cell, the system's readings of
    the window (``counters``), its end-to-end values, the device trace and
    the table of peaks."""

    cell: Cell
    counters: dict
    end_to_end: dict
    trace: object = None
    peaks: dict = field(default_factory=dict)
    root: Path = ROOT

    def counts(self, name: str):
        return counts(name, self.root)


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})
