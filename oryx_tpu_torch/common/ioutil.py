"""Filesystem + network helpers (the port's copy of
oryx_tpu/common/ioutil.py).

Mirrors the reference's IOUtils (framework/oryx-common .../io/IOUtils.java):
free-port selection for test servers, recursive delete, atomic renames, and
directory listing ordered by the generation-timestamp naming convention.
"""

from __future__ import annotations

import os
import re
import shutil
import socket
import time
from pathlib import Path


def choose_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def atomic_rename(src: str | Path, dst: str | Path) -> None:
    """Atomic move used to publish the winning model candidate
    (reference MLUpdate.java:199-205 fs.rename)."""
    os.replace(str(src), str(dst))


_TS_DIR_RE = re.compile(r"^oryx-(\d+)$|^(\d{10,})$")


def timestamp_from_dirname(name: str) -> int | None:
    """Extract the epoch-millis timestamp from a generation dir name
    (oryx-<ts> data dirs, bare <ts> model dirs), the convention of
    SaveToHDFSFunction/DeleteOldDataFn."""
    m = _TS_DIR_RE.match(name)
    if not m:
        return None
    return int(m.group(1) or m.group(2))


def list_generation_dirs(root: str | Path) -> list[Path]:
    r = Path(strip_scheme(str(root)))
    if not r.is_dir():
        return []
    out = [p for p in r.iterdir() if p.is_dir() and timestamp_from_dirname(p.name) is not None]
    return sorted(out, key=lambda p: timestamp_from_dirname(p.name) or 0)


def delete_older_than(root: str | Path, max_age_hours: int, now_ms: int | None = None) -> int:
    """TTL enforcement over timestamped dirs (reference DeleteOldDataFn.java)."""
    if max_age_hours < 0:
        return 0
    now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
    cutoff = now_ms - max_age_hours * 3600 * 1000
    n = 0
    for p in list_generation_dirs(root):
        ts = timestamp_from_dirname(p.name)
        if ts is not None and ts < cutoff:
            delete_recursively(p)
            n += 1
    return n


def strip_scheme(uri: str) -> str:
    """file:/x, file:///x → /x ; other schemes unchanged-but-stripped."""
    if uri.startswith("file://"):
        return uri[len("file://") :] or "/"
    if uri.startswith("file:"):
        return uri[len("file:") :]
    return uri
