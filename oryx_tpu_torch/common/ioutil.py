"""Filesystem helpers (the part of oryx_tpu/common/ioutil.py the serving
slice needs)."""

from __future__ import annotations

import shutil
from pathlib import Path


def delete_recursively(path: str | Path) -> None:
    p = Path(path)
    if p.is_dir():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists():
        p.unlink(missing_ok=True)


def mkdirs(path: str | Path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def strip_scheme(uri: str) -> str:
    """file:/x, file:///x → /x ; other schemes unchanged-but-stripped."""
    if uri.startswith("file://"):
        return uri[len("file://") :] or "/"
    if uri.startswith("file:"):
        return uri[len("file:") :]
    return uri
