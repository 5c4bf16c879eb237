"""The harness is driven by data: the manifest's cells resolve to files
found by name, a new cell needs only new files and entries, and the
manifest keeps to the benchmark's format."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    cell = harness.resolve(MANIFEST, workload)
    assert (ROOT / "portbench" / "systems" / f"{cell.config['system']}.py").is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(harness.metric_reader(m["name"]).read)


def test_manifest_keeps_to_the_format():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert m["paths"] == ["portbench"]
    assert "jax" not in " ".join(m["command"])
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25 and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
    for p in m["per_layer"]:
        assert set(p) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["workloads"] and set(p["workloads"]) <= set(CELLS)
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(p["unit"]) and p["better"] in ("lower", "higher")
    assert len(json.dumps(m)) < 64 * 1024


def test_a_cell_added_by_new_files_alone_resolves(tmp_path):
    """A throwaway configuration, traffic mix, per-layer metric and count,
    added as new files and manifest entries in a copy: the harness finds
    each by name, and no file that was there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"system": "als_serving", "items": 10, "users": 2, "features": 4,
         "known_items_per_user": 1, "limits": {"bad_answers": 0}}))
    (pb / "traffic" / "toy-mix.json").write_text(json.dumps({"kind": "http_closed_loop",
                                                             "clients": 1}))
    (pb / "counts" / "toy_kernel.py").write_text(
        "def work(n):\n    return 2.0 * n, 4.0 * n\n")
    (pb / "metrics" / "toy.rows.py").write_text(
        "def read(ctx):\n    ops, _ = ctx.counts('toy_kernel').work(ctx.counters['rows'])\n"
        "    return ops\n")
    manifest["configs"].append({"name": "toy", "source": "https://example.org/toy",
                                "file": "portbench/configs/toy.json", "reduced": [],
                                "why": "a throwaway"})
    manifest["workloads"].append({"name": "toy.toy-mix", "config": "toy",
                                  "traffic": "toy-mix", "chips": 1, "why": "a throwaway"})
    manifest["per_layer"].append({"name": "toy.rows", "unit": "ops", "better": "higher",
                                  "source": "program_counter", "layer": "Toy",
                                  "moves": "setup_s", "workloads": ["toy.toy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.resolve(harness.load_manifest(tmp_path), "toy.toy-mix", tmp_path)
    assert cell.config["items"] == 10 and cell.traffic["clients"] == 1
    assert [m["name"] for m in cell.per_layer] == ["toy.rows"]
    ctx = harness.Context(cell, {"rows": 3}, {}, root=tmp_path)
    assert harness.metric_reader("toy.rows", tmp_path).read(ctx) == 6.0
    assert harness.system_module(cell.config["system"], tmp_path).run
    for p, data in before.items():
        assert p.read_bytes() == data
    # the real cells still resolve alongside it, to the same metrics
    for w in CELLS:
        assert ([m["name"] for m in harness.resolve(manifest, w, tmp_path).per_layer]
                == [m["name"] for m in harness.resolve(MANIFEST, w).per_layer])


@pytest.mark.parametrize("modules,found", [
    (["oryx_tpu_torch", "oryx_tpu_torch.ops.als", "portbench.run"], []),
    (["jaxtyping", "oryx_tpu_tools", "flaxen"], []),
    (["oryx_tpu.ops"], ["oryx_tpu.ops"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax.linen", "jax", "jaxlib.xla_client"]),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_run_refuses_without_the_program_or_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    exits non-zero and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    cmd = [sys.executable if c == "python3" else c for c in cmd]
    proc = subprocess.run(cmd + ["--workload", CELLS[0], "--seed", str(2 ** 31 + 7),
                                 "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")


def test_tiny_cells_load_nothing_forbidden():
    """Every cell and the parked training cell, run on the CPU at tiny
    sizes in a fresh process, load no module of JAX or of the JAX
    package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.tiny import PARKED_TRAINING, tiny_cell, run_cell\n"
        "from portbench.harness import forbidden_modules\n"
        "for w in %r + [PARKED_TRAINING['name']]:\n"
        "    run_cell(tiny_cell(w), seconds=0.5)\n"
        "print('FOUND', forbidden_modules(sys.modules))\n" % (str(ROOT), CELLS))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout


def test_a_per_layer_metric_must_list_its_cells():
    """Each per-layer metric names the cells that report it; one without
    the list is refused, not guessed from what it moves."""
    manifest = json.loads(json.dumps(MANIFEST))
    del manifest["per_layer"][0]["workloads"]
    with pytest.raises(KeyError):
        harness.resolve(manifest, CELLS[0])
