"""ctypes bindings for the native oryxbus library (liboryxbus.so; the
port's copy of oryx_tpu/bus/native.py).

Built from native/oryxbus/oryxbus.cpp (`make` there), at first use when a
toolchain exists. ``NativeParser`` is the CSV data loader
(``parse_interactions``, through apps/als/common.py); ``NativeAppender``
adds the file log's appender and record scanner (bus/filelog.py,
layers/datastore.py), and bus/kafkawire.py takes its hardware CRC-32C.
Without the library the pure-Python paths run; they write and read the
same bytes.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB_NAMES = ("liboryxbus.so",)


_build_attempted = False


def _find_lib() -> str | None:
    env = os.environ.get("ORYXBUS_LIB")
    if env and Path(env).exists():
        return env
    here = Path(__file__).resolve()
    candidates = [
        here.parent,
        here.parent.parent.parent / "native" / "oryxbus",
    ]
    for d in candidates:
        for n in _LIB_NAMES:
            p = d / n
            if p.exists():
                return str(p)
    return _maybe_build()


def _maybe_build() -> str | None:
    """Compile the library in place on first use when a toolchain exists —
    a fresh checkout should get the native fast paths without a manual
    build step. One attempt per process; failure leaves the Python
    fallbacks in charge."""
    global _build_attempted
    if _build_attempted:
        return None
    _build_attempted = True
    src_dir = Path(__file__).resolve().parent.parent.parent / "native" / "oryxbus"
    src = src_dir / "oryxbus.cpp"
    if not src.exists():
        return None
    import shutil
    import subprocess
    import tempfile

    out = src_dir / "liboryxbus.so"
    # build to a temp name then atomic-rename: concurrent processes (the
    # multi-process e2e spawns several at once) must never dlopen a
    # half-written .so. The Makefile stays the single source of truth for
    # flags; `SO=` points its output at the temp name.
    tmp = None
    try:
        make = shutil.which("make")
        gxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
        if make is None and gxx is None:
            return None
        with tempfile.NamedTemporaryFile(
            dir=src_dir, suffix=".so.tmp", delete=False
        ) as tf:
            tmp = tf.name
        # the reservation file must not exist when make runs — an empty
        # up-to-date target would make it a no-op; the unique NAME is the
        # concurrency guard, not the inode
        os.unlink(tmp)
        # WARNFLAGS without -Werror: this OPPORTUNISTIC import-time build
        # runs on arbitrary operator toolchains, where a future compiler's
        # new -Wall diagnostic must degrade to the Python fallback loudly
        # below — not silently lose the native bus. The Makefile's default
        # keeps -Werror for explicit/CI/sanitize builds, where a human
        # sees the failure.
        if make is not None and (src_dir / "Makefile").exists():
            cmd = [make, "-C", str(src_dir), f"SO={os.path.basename(tmp)}",
                   "WARNFLAGS=-Wall -Wextra"]
        else:
            cmd = [gxx, "-O2", "-Wall", "-Wextra", "-fPIC",
                   "-std=c++17", "-shared", "-o", tmp, str(src)]
        # never inherit the sanitizer switch here: an ASan-instrumented
        # auto-build cannot dlopen into this (uninstrumented) process —
        # the sanitized library is built explicitly by the slow test /
        # `make sanitize` under its own name and LD_PRELOAD
        env = {k: v for k, v in os.environ.items() if k != "ORYX_NATIVE_SANITIZE"}
        proc = subprocess.run(cmd, capture_output=True, timeout=120, env=env)
        if (
            proc.returncode != 0
            or not os.path.exists(tmp)
            or not os.path.getsize(tmp)
        ):
            import logging

            logging.getLogger(__name__).warning(
                "native oryxbus auto-build failed (rc=%s); using the "
                "pure-Python bus paths. stderr tail: %s",
                proc.returncode,
                proc.stderr.decode("utf-8", "replace")[-500:],
            )
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
        os.replace(tmp, out)
        return str(out)
    except Exception:  # noqa: BLE001 - any build problem means "no native"
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None


class NativeParser:
    _instance: "NativeParser | None" = None

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.oryxbus_parse_interactions.restype = ctypes.c_int64
        lib.oryxbus_parse_interactions.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]

    @classmethod
    def load(cls) -> "NativeParser":
        if cls._instance is None:
            path = _find_lib()
            if path is None:
                raise FileNotFoundError("liboryxbus.so not built")
            cls._instance = cls(ctypes.CDLL(path))
        return cls._instance

    def parse_interactions(
        self, buf: bytes
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Native CSV data loader: newline-separated "user,item[,value[,ts]]"
        bytes -> (users i64, items i64, values f64, timestamps i64, ok u8)
        with no Python object per record. ok=0 rows need the Python parser
        (JSON-array lines, quoted CSV, non-canonical integer ids)."""
        cap = buf.count(b"\n") + 1
        users = np.empty(cap, dtype=np.int64)
        items = np.empty(cap, dtype=np.int64)
        vals = np.empty(cap, dtype=np.float64)
        tss = np.empty(cap, dtype=np.int64)
        ok = np.empty(cap, dtype=np.uint8)
        n = self._lib.oryxbus_parse_interactions(
            buf,
            len(buf),
            users.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            items.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap,
        )
        if n < 0:
            raise OSError(-n, "oryxbus_parse_interactions failed")
        return users[:n], items[:n], vals[:n], tss[:n], ok[:n]


class NativeAppender(NativeParser):
    """The file log's native appender and record scanner, over the same
    library as the parser (the JAX package's NativeAppender)."""

    _instance: "NativeAppender | None" = None

    def __init__(self, lib: ctypes.CDLL):
        super().__init__(lib)
        lib.oryxbus_append.restype = ctypes.c_int
        lib.oryxbus_append.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.oryxbus_append_batch.restype = ctypes.c_int
        lib.oryxbus_append_batch.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.oryxbus_scan.restype = ctypes.c_int64
        lib.oryxbus_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]

    def append(self, path: str, key: str | None, message: str) -> None:
        kb = key.encode("utf-8") if key is not None else None
        mb = message.encode("utf-8")
        rc = self._lib.oryxbus_append(
            path.encode(), kb, len(kb) if kb else 0, mb, len(mb)
        )
        if rc != 0:
            raise OSError(-rc, f"oryxbus_append failed for {path}")

    def append_batch(self, path: str, encoded: bytes) -> None:
        rc = self._lib.oryxbus_append_batch(path.encode(), encoded, len(encoded))
        if rc != 0:
            raise OSError(-rc, f"oryxbus_append_batch failed for {path}")

    def scan(self, path: str, start_pos: int, max_records: int | None = None) -> tuple[np.ndarray, int]:
        """Record byte positions from start_pos + final scanned-to position.
        The buffer is sized from the unscanned byte span (a record is >= 8
        bytes) so tail-polling a busy log doesn't allocate megabytes per
        refresh; loops if the file grew beyond the estimate mid-scan."""
        positions: list[int] = []
        pos = start_pos
        while True:
            if max_records is None:
                try:
                    span = max(0, os.stat(path).st_size - pos)
                except OSError:
                    span = 0
                cap = max(16, span // 8 + 1)
            else:
                cap = max_records
            buf = (ctypes.c_int64 * cap)()
            scanned = ctypes.c_int64(pos)
            n = self._lib.oryxbus_scan(path.encode(), pos, buf, cap, ctypes.byref(scanned))
            if n < 0:
                raise OSError(-n, f"oryxbus_scan failed for {path}")
            positions.extend(buf[:n])
            pos = scanned.value
            if max_records is not None or n < cap:
                break
        return np.asarray(positions, dtype=np.int64), pos
