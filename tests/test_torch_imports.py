"""The PyTorch port imports neither jax nor any module of the JAX package,
and its entry points default to the CUDA card instead of moving to the CPU
on their own."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_every_port_module_imports_with_jax_blocked():
    code = textwrap.dedent(
        """
        import importlib, json, pkgutil, sys
        sys.modules["jax"] = None
        import oryx_tpu_torch
        names = ["oryx_tpu_torch"] + [
            m.name for m in pkgutil.walk_packages(
                oryx_tpu_torch.__path__, "oryx_tpu_torch."
            )
        ]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(
            k for k in sys.modules
            if k == "oryx_tpu" or k.startswith("oryx_tpu.")
        )
        assert not leaked, leaked
        assert sys.modules["jax"] is None
        print(json.dumps(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout))
    # the slices' modules: device, config, artifact, state, batcher, the
    # bus, the HTTP frontends and routes, the CLI, the trainer and the
    # batch and speed layers, ...
    assert len(names) >= 60
    assert {
        "oryx_tpu_torch.common.rng", "oryx_tpu_torch.ops.vector",
        "oryx_tpu_torch.ops.solver", "oryx_tpu_torch.ops.flops",
        "oryx_tpu_torch.ops.als_probe",
        "oryx_tpu_torch.ml.synth", "oryx_tpu_torch.ml.evaluate",
        "oryx_tpu_torch.ml.quality", "oryx_tpu_torch.ml.hyperparams",
        "oryx_tpu_torch.ml.update", "oryx_tpu_torch.common.executil",
        "oryx_tpu_torch.common.quarantine", "oryx_tpu_torch.bus.native",
        "oryx_tpu_torch.apps.als.batch", "oryx_tpu_torch.apps.als.speed",
        "oryx_tpu_torch.layers.datastore", "oryx_tpu_torch.layers.watchdog",
        "oryx_tpu_torch.layers.batch", "oryx_tpu_torch.layers.speed",
        "oryx_tpu_torch.common.flightrec", "oryx_tpu_torch.common.slo",
        "oryx_tpu_torch.common.perfstats", "oryx_tpu_torch.serving.viewsync",
    } <= names
    assert set(KMEANS_RDF_MODULES) <= names
    assert set(SEQ_MODULES) <= names
    assert set(BUS_CLI_MODULES) <= names
    assert set(FLEET_MODULES) <= names


# the k-means and RDF apps' modules and what they share
KMEANS_RDF_MODULES = (
    "oryx_tpu_torch.ops.kmeans", "oryx_tpu_torch.ops.rdf",
    "oryx_tpu_torch.apps.schema", "oryx_tpu_torch.common.pmml",
    "oryx_tpu_torch.apps.kmeans.common", "oryx_tpu_torch.apps.kmeans.batch",
    "oryx_tpu_torch.apps.kmeans.speed", "oryx_tpu_torch.apps.kmeans.serving",
    "oryx_tpu_torch.apps.rdf.common", "oryx_tpu_torch.apps.rdf.batch",
    "oryx_tpu_torch.apps.rdf.speed", "oryx_tpu_torch.apps.rdf.serving",
    "oryx_tpu_torch.serving.resources.clustering",
    "oryx_tpu_torch.serving.resources.classreg",
)


def test_kmeans_rdf_modules_import_with_jax_blocked():
    """Each module of the k-means and RDF apps, imported alone in a fresh
    process with jax blocked, loads no module of the JAX package; the
    quality harnesses and to_pmml_xml are there."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None
        for name in {KMEANS_RDF_MODULES!r}:
            importlib.import_module(name)
        from oryx_tpu_torch.common.artifact import ModelArtifact
        from oryx_tpu_torch.ml.quality import (
            build_and_evaluate_kmeans, build_and_evaluate_rdf)
        assert callable(ModelArtifact.to_pmml_xml)
        leaked = sorted(
            k for k in sys.modules
            if k == "oryx_tpu" or k.startswith("oryx_tpu.")
        )
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


# the seq app's modules
SEQ_MODULES = (
    "oryx_tpu_torch.ops.seq", "oryx_tpu_torch.apps.seq",
    "oryx_tpu_torch.apps.seq.common", "oryx_tpu_torch.apps.seq.state",
    "oryx_tpu_torch.apps.seq.batch", "oryx_tpu_torch.apps.seq.speed",
    "oryx_tpu_torch.apps.seq.serving", "oryx_tpu_torch.serving.resources.seq",
    "oryx_tpu_torch.ml.quality",
)


def test_seq_modules_import_with_jax_blocked():
    """Each module of the seq app, imported alone in a fresh process with
    jax blocked, loads no module of the JAX package; the trainer, the
    weight carry-over and the quality harness are there."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None
        for name in {SEQ_MODULES!r}:
            importlib.import_module(name)
        from oryx_tpu_torch.ops.seq import gru_from_numpy, train_gru
        from oryx_tpu_torch.ml.quality import build_and_evaluate_seq
        leaked = sorted(
            k for k in sys.modules
            if k == "oryx_tpu" or k.startswith("oryx_tpu.")
        )
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_jax_package_import():
    for path in (ROOT / "oryx_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s, (path, line)
                assert not s.startswith(("import oryx_tpu.", "from oryx_tpu.",
                                         "from oryx_tpu import")), (path, line)


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from oryx_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_do_not_move_to_cpu_on_their_own(monkeypatch):
    from oryx_tpu_torch.apps.als.serving import (
        ALSServingModel,
        ALSServingModelManager,
    )
    from oryx_tpu_torch.apps.als.state import ALSState
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.ops.transfer import staged_device_put
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ALSServingModelManager(load_config())
    with pytest.raises(RuntimeError):
        ALSServingModel(ALSState(4, True))
    with pytest.raises(RuntimeError):
        staged_device_put(np.zeros((2, 2), dtype=np.float32))
    assert ALSServingModel(ALSState(4, True), device="cpu").device.type == "cpu"


# a dotted name in the JAX package (oryx_tpu.x, not oryx_tpu_torch.x); a
# path such as /tmp/oryx_tpu/data is not a module
_JAX_DOTTED = re.compile(r"(?<![\w/.])oryx_tpu\.[A-Za-z_]")


@pytest.mark.parametrize("rel", ["oryx_tpu_torch/common/reference.conf",
                                 "oryx_tpu_torch/apps/spi.py"])
def test_config_defaults_and_spi_name_only_port_modules(rel):
    """Class and module names in the port's config defaults and app
    registry are loaded with importlib, which the import scan above cannot
    see: none may name the JAX package."""
    text = (ROOT / rel).read_text()
    hits = [line for line in text.splitlines() if _JAX_DOTTED.search(line)]
    assert not hits, hits
    # the scan does see a JAX name when there is one
    assert _JAX_DOTTED.search('x = ["oryx_tpu.serving.resources.common"]')
    assert not _JAX_DOTTED.search('dir = "file:/tmp/oryx_tpu/flight"')


def test_spi_overlay_loads_port_classes_only():
    from oryx_tpu_torch.api import (
        BatchLayerUpdate,
        ServingModelManager,
        SpeedModelManager,
    )
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.common.classutil import load_class
    from oryx_tpu_torch.common.config import load_config

    overlay = app_overlay("als")
    classes = {
        "oryx.batch.update-class": BatchLayerUpdate,
        "oryx.speed.model-manager-class": SpeedModelManager,
        "oryx.serving.model-manager-class": ServingModelManager,
    }
    names = [*(overlay[key] for key in classes),
             *overlay["oryx.serving.application-resources"]]
    for name in names:
        assert name is not None and name.startswith("oryx_tpu_torch."), name
    config = load_config(overlay=overlay)
    for key, base in classes.items():
        assert issubclass(load_class(config.get_string(key)), base), key
    for name in load_config().get_list("oryx.serving.application-resources"):
        assert name.startswith("oryx_tpu_torch."), name


def test_serving_layer_and_cli_raise_without_cuda(monkeypatch):
    """Built from config, the serving layer loads the ALS manager by name,
    which resolves the card and raises without one, before any socket or
    thread is opened; so does the CLI, and so does each serving replica
    (``oryx.serving.api.processes = 2``): every replica opens the card
    itself, none falls back to the CPU."""
    from oryx_tpu_torch import cli
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.serving.server import ServingLayer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingLayer(load_config(overlay=app_overlay("als")))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serving", "--app", "als"])
    replicas = dict(app_overlay("als"), **{"oryx.serving.api.processes": 2})
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingLayer(load_config(overlay=replicas))
    monkeypatch.setenv("ORYX_SERVING_REPLICA", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serving", "--app", "als", "--set",
                  "oryx.serving.api.processes=2"])


def test_cli_fleet_replicas_raise_without_cuda(tmp_path):
    """``cli fleet`` with no ``oryx.compute.platform`` starts replicas that
    each resolve the card, raise the CUDA RuntimeError and exit, instead
    of serving on the CPU; the fleet then fails before its front starts."""
    import os

    from oryx_tpu_torch.common.executil import free_port_run

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "fleet", "--app", "als",
         "--replicas", "2",
         "--set", f"oryx.fleet.base-port={free_port_run(2)}",
         "--set", f"oryx.fleet.data-dir={tmp_path / 'fleet'}",
         "--set", f"oryx.monitoring.flight.dir={tmp_path / 'flight'}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA" in out.stderr, out.stderr[-2000:]
    assert "before listening" in out.stderr, out.stderr[-2000:]
    assert "fleet:" not in out.stdout  # the front never started


def test_batch_and_speed_layers_and_cli_raise_without_cuda(monkeypatch):
    """Built from config alone, the batch and speed layers load the ALS
    update and speed manager by name, which resolve the card and raise
    without one; so do ``cli batch`` and ``cli speed``."""
    from oryx_tpu_torch import cli
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.layers import BatchLayer, SpeedLayer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = load_config(overlay=app_overlay("als"))
    for layer in (BatchLayer, SpeedLayer):
        with pytest.raises(RuntimeError, match="CUDA"):
            layer(config)
    for command in ("batch", "speed"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([command, "--app", "als"])
    with pytest.raises(ValueError, match="item 11"):
        cli.main(["batch", "--app", "als", "--set",
                  "oryx.compute.distributed.num-processes=2"])


# the Kafka bus, the native tier, the CLI and the example app
BUS_CLI_MODULES = (
    "oryx_tpu_torch.bus.kafkawire", "oryx_tpu_torch.bus.compress",
    "oryx_tpu_torch.bus.kafka", "oryx_tpu_torch.bus.broker",
    "oryx_tpu_torch.bus.native", "oryx_tpu_torch.bus.filelog",
    "oryx_tpu_torch.layers.datastore", "oryx_tpu_torch.common.executil",
    "oryx_tpu_torch.serving.server", "oryx_tpu_torch.serving.aserver",
    "oryx_tpu_torch.cli", "oryx_tpu_torch.apps.example",
    "oryx_tpu_torch.apps.example.batch", "oryx_tpu_torch.apps.example.speed",
    "oryx_tpu_torch.apps.example.serving",
    "oryx_tpu_torch.serving.resources.example", "oryx_tpu_torch.apps.spi",
)


def test_bus_and_cli_modules_import_with_jax_blocked():
    """Each module of the Kafka bus, the native tier, the CLI and the
    example app, imported alone in a fresh process with jax blocked, loads
    no module of the JAX package; kafka:// resolves to the port's client,
    the native appender and the example app are there, and the CLI refuses
    only pod."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None
        for name in {BUS_CLI_MODULES!r}:
            importlib.import_module(name)
        from oryx_tpu_torch.bus.broker import get_broker
        from oryx_tpu_torch.bus.kafka import KafkaBroker
        from oryx_tpu_torch.bus.native import NativeAppender, NativeParser
        from oryx_tpu_torch.apps.spi import app_overlay
        from oryx_tpu_torch import cli
        assert isinstance(get_broker("kafka://127.0.0.1:9"), KafkaBroker)
        assert issubclass(NativeAppender, NativeParser)
        assert app_overlay("example")["oryx.batch.update-class"].startswith(
            "oryx_tpu_torch.apps.example.")
        assert set(cli._NOT_PORTED) == {{"pod"}}
        leaked = sorted(
            k for k in sys.modules
            if k == "oryx_tpu" or k.startswith("oryx_tpu.")
        )
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


# the serving fleet: ring, federation, supervisor, front, controller
FLEET_MODULES = (
    "oryx_tpu_torch.fleet", "oryx_tpu_torch.fleet.ring",
    "oryx_tpu_torch.fleet.observe", "oryx_tpu_torch.fleet.supervisor",
    "oryx_tpu_torch.fleet.front", "oryx_tpu_torch.fleet.control",
)


def test_fleet_modules_import_with_jax_blocked():
    """Each module of the fleet, imported alone in a fresh process with jax
    blocked, loads no module of the JAX package; the package exports the
    JAX package's names, and its replicas are the port's ``cli serving``."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None
        for name in {FLEET_MODULES!r}:
            importlib.import_module(name)
        import oryx_tpu_torch.fleet as fleet
        assert set(fleet.__all__) == {{
            "FleetController", "FleetFront", "FleetSupervisor", "HashRing",
            "ReplicaInfo", "replica_overlays",
        }}
        import inspect
        from oryx_tpu_torch.fleet.supervisor import FleetSupervisor
        assert '"oryx_tpu_torch.cli"' in inspect.getsource(FleetSupervisor._spawn)
        leaked = sorted(
            k for k in sys.modules
            if k == "oryx_tpu" or k.startswith("oryx_tpu.")
        )
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


# the serving planes' modules: the artifact relay, LSH, the rescorer SPI,
# the live quality plane, the model gate and the recall gate's harness
SERVING_PLANES_MODULES = (
    "oryx_tpu_torch.common.artifact", "oryx_tpu_torch.common.modelgate",
    "oryx_tpu_torch.common.qualitystats", "oryx_tpu_torch.apps.als.lsh",
    "oryx_tpu_torch.apps.als.rescorer", "oryx_tpu_torch.ml.quality",
    "oryx_tpu_torch.common.freshness", "oryx_tpu_torch.api",
)


def test_serving_planes_modules_import_with_jax_blocked():
    """Each module of the serving planes, imported alone in a fresh process
    with jax blocked, loads no module of the JAX package; the recall
    gate, the relay and the gate's entry points are there."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None
        for name in {SERVING_PLANES_MODULES!r}:
            importlib.import_module(name)
        from oryx_tpu_torch.ml.quality import (
            MIN_SCORE_MODE_RECALL, RecallReport, evaluate_score_mode_recall,
            mean_recall_at_k)
        from oryx_tpu_torch.common.artifact import (
            ArtifactRelay, configure_artifact_relay, reset_artifact_relay)
        from oryx_tpu_torch.common.modelgate import configure_model_gate
        from oryx_tpu_torch.common.qualitystats import configure_qualitystats
        from oryx_tpu_torch.apps.als.rescorer import (
            MultiRescorer, Rescorer, RescorerProvider)
        assert MIN_SCORE_MODE_RECALL == 0.95
        leaked = sorted(
            k for k in sys.modules
            if k == "oryx_tpu" or k.startswith("oryx_tpu.")
        )
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_serving_never_reaches_the_samplers_host_scorer():
    """The quality sampler's exact host scorer is a reference measurement
    off the hot path: it is private to common/qualitystats.py, and no
    module under serving/ names it (or the sampler's scoring entry)."""
    from oryx_tpu_torch.common import qualitystats

    assert not hasattr(qualitystats, "host_topk")
    assert callable(qualitystats._exact_topk)
    for path in (ROOT / "oryx_tpu_torch" / "serving").rglob("*.py"):
        text = path.read_text()
        for name in ("_exact_topk", "score_sample", "host_topk"):
            assert name not in text, (path, name)
    for path in (ROOT / "oryx_tpu_torch").rglob("*.py"):
        if path.name != "qualitystats.py":
            assert "_exact_topk" not in path.read_text(), path


def test_recall_gate_needs_the_card_unless_told(monkeypatch):
    """The recall gate measures on the card by default and does not move
    to the CPU on its own."""
    from oryx_tpu_torch.ml.quality import evaluate_score_mode_recall

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_score_mode_recall(n_items=100, n_queries=4)
