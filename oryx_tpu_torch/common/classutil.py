"""Reflective plugin loading: every user hook in the framework is a
config-key-valued dotted class/function path, loaded here (the port's copy
of oryx_tpu/common/classutil.py).

Mirrors the reference's ClassUtils.loadClass/loadInstanceOf
(framework/oryx-common .../lang/ClassUtils.java), which backs
oryx.batch.update-class / oryx.speed.model-manager-class /
oryx.serving.model-manager-class (BatchLayer.java:172-204).
"""

from __future__ import annotations

import importlib
from typing import Any


def load_class(dotted: str) -> type:
    mod_name, _, cls_name = dotted.rpartition(".")
    if not mod_name:
        raise ImportError(f"not a dotted class path: {dotted!r}")
    mod = importlib.import_module(mod_name)
    try:
        obj = getattr(mod, cls_name)
    except AttributeError as e:
        raise ImportError(f"{cls_name} not found in {mod_name}") from e
    return obj


def load_instance_of(dotted: str, expected: type | None = None, *args: Any, **kwargs: Any) -> Any:
    cls = load_class(dotted)
    inst = cls(*args, **kwargs)
    if expected is not None and not isinstance(inst, expected):
        raise TypeError(f"{dotted} is not a {expected.__name__}")
    return inst


def class_exists(dotted: str) -> bool:
    try:
        load_class(dotted)
        return True
    except Exception:
        return False
