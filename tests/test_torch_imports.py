"""The PyTorch port imports neither jax nor any module of the JAX package,
and its entry points default to the CUDA card instead of moving to the CPU
on their own."""

from __future__ import annotations

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
        import importlib, pkgutil, sys
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
        print(len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # the slice's modules: device, config, artifact, state, batcher, ...
    assert int(out.stdout.strip()) >= 20


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
