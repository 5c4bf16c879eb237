"""Device resolution for the port's entry points.

The default is the CUDA card. Without one, resolution raises: no code path
moves to the CPU on its own. The CPU is used only when the caller names it
(``device="cpu"``), which is how the tests run the plain versions of the
kernels, or when the operator does: the CLI applies
``oryx.compute.platform`` (``set_platform``) as the process's default.

The port runs in one process on one card: a config that asks for a
multi-process pod raises (``reject_pod_config``).
"""

from __future__ import annotations

import torch


_platform: torch.device | None = None  # set_platform's choice; None = the card


def set_platform(name: str | None) -> None:
    """Make ``name`` (``oryx.compute.platform``) the device that
    ``resolve_device()`` returns when the caller names none: "auto" (or
    None) is the CUDA card, any other value a torch device ("cpu",
    "cuda:1"). Raises ValueError on a name torch does not know."""
    global _platform
    if name in (None, "", "auto"):
        _platform = None
        return
    try:
        _platform = torch.device(name)
    except RuntimeError as e:
        raise ValueError(
            f"oryx.compute.platform = {name!r} names no torch device "
            "(auto, cpu or cuda[:N])"
        ) from e


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device("cuda")`` by default (or the operator's
    ``set_platform`` choice), else the device the caller named. Raises
    RuntimeError when CUDA is asked for (or implied) and no card is
    present."""
    if device is None:
        device = _platform
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {d} requested but CUDA is not available")
    return d


def reject_pod_config(config) -> None:
    """Raise ValueError when the config enables a multi-process pod
    (``oryx.compute.distributed.*``): multi-device training is ROADMAP
    queue 1 item 11 and not ported yet."""
    g = lambda k, d: config.get(f"oryx.compute.distributed.{k}", d)  # noqa: E731
    if int(g("num-processes", 1) or 1) > 1 or g("coordinator-address", None):
        raise ValueError(
            "oryx.compute.distributed: multi-process pods are not ported to "
            "the PyTorch port yet (ROADMAP queue 1 item 11)"
        )
