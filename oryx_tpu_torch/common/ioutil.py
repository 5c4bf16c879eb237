"""Filesystem helpers (the part of oryx_tpu/common/ioutil.py the serving
slice needs)."""

from __future__ import annotations

from pathlib import Path


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
