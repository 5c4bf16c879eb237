"""Build the port's CUDA kernels at first use.

Every source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
wrappers load with ``ctypes``. Libraries land in ``build/torch_kernels/`` at
the root of the checkout (listed in ``.gitignore``), named by a digest of
their source and flags, so an edited source rebuilds and an unchanged one
loads straight away. ``build_all`` starts one ``nvcc`` per source, all at
once. The ptxas report (registers, shared memory, spills) of each build is
kept beside its library as ``<name>.log``.

Nothing here runs at import time: the CPU tests import this module and
never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# one library per source file
SOURCES = {"topk_dot": "topk_dot.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH. Raises RuntimeError when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
        "is installed"
    )


def _source(name: str, source: Path | None) -> Path:
    return CSRC_DIR / SOURCES[name] if source is None else Path(source)


def _flags(macros) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{m}" for m in macros)]


def library_path(name: str, macros=(), source: Path | None = None) -> Path:
    """Where the library for source ``name`` lives, keyed by a digest of
    the source text and the compiler flags. ``macros`` (``NAME=VALUE``
    strings) and ``source`` (another file standing in for the checkout's)
    build a variant of it, as the kernel probe does."""
    h = hashlib.sha256(_source(name, source).read_bytes())
    h.update(" ".join(_flags(macros)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None, variants=None) -> dict[str, float]:
    """Compile every named source (default: all) that has no library yet,
    one nvcc process per source, started together. ``variants`` instead
    maps labels to ``(name, macros, source)`` as ``library_path`` takes
    them. Returns the seconds each build took (0.0 for a library already
    built). Raises RuntimeError with the compiler's output when a build
    fails."""
    if variants is None:
        names = list(SOURCES) if names is None else list(names)
        variants = {name: (name, (), None) for name in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, float] = {}
    for label, (name, macros, source) in variants.items():
        target = library_path(name, macros, source)
        if target.exists():
            out[label] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_flags(macros), "-o", str(tmp),
               str(_source(name, source))]
        procs[label] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, target, time.monotonic(),
        )
    failures = []
    for label, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        out[label] = time.monotonic() - t0
        (BUILD_DIR / f"{label}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{label}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str, macros=(), source: Path | None = None) -> ctypes.CDLL:
    """The loaded library for source ``name`` (or a variant of it, as
    ``library_path`` names them), building it first if needed."""
    path = library_path(name, macros, source)
    with _LOCK:
        lib = _LIBS.get(str(path))
        if lib is None:
            if not path.exists():
                build_all(variants={path.stem: (name, macros, source)})
            lib = ctypes.CDLL(str(path))
            _LIBS[str(path)] = lib
        return lib
