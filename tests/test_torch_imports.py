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
    thread is opened; so does the CLI."""
    from oryx_tpu_torch import cli
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.serving.server import ServingLayer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingLayer(load_config(overlay=app_overlay("als")))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serving", "--app", "als"])
    with pytest.raises(ValueError, match="not ported"):
        cli.main(["serving", "--app", "als", "--set",
                  "oryx.serving.api.processes=2"])


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
