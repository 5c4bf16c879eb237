"""The native oryxbus tier in the port (bus/native.py NativeAppender, the
file log and the batch datastore through it), held to tests/test_bus.py's
native cases and to the pure-Python tier: the two tiers write the same
bytes, and each package's FileLogBroker and datastore read the other's
logs whichever tier wrote them. Also the port's copy of executil's
--set coercion and fan-out against the JAX package's. Exact throughout.
"""

from __future__ import annotations

import importlib
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("oryx_tpu", "oryx_tpu_torch")
RECORDS = [("MODEL-REF", "/models/0001"), ("UP", '["Y", "i1", [0.5]]'),
           (None, "ü, utf-8 & a null key"), ("k", ""), ("u7", "u7,i3,1,1000")]


def _native_or_skip(root: str):
    try:
        return importlib.import_module(f"{root}.bus.native").NativeAppender.load()
    except (FileNotFoundError, OSError):
        pytest.skip("native oryxbus not built")


@pytest.fixture(params=["native", "python"])
def tier(request, monkeypatch):
    """Both packages' file logs and datastores on one tier."""
    for root in PKGS:
        filelog = importlib.import_module(f"{root}.bus.filelog")
        datastore = importlib.import_module(f"{root}.layers.datastore")
        native = _native_or_skip(root) if request.param == "native" else None
        monkeypatch.setattr(filelog, "_NATIVE_TRIED", True)
        monkeypatch.setattr(filelog, "_NATIVE_CACHE", native)
        monkeypatch.setattr(datastore, "_maybe_native", lambda n=native: n)
    return request.param


def test_native_appender_if_built(tmp_path):
    from oryx_tpu_torch.bus.filelog import FileLogBroker

    nat = _native_or_skip("oryx_tpu_torch")
    log = tmp_path / "n.log"
    nat.append(str(log), "key1", "native message")
    nat.append(str(log), None, "second")
    positions, scanned = nat.scan(str(log), 0)
    assert len(positions) == 2 and scanned == log.stat().st_size
    br = FileLogBroker(str(tmp_path / "busdir"))
    assert br._native is nat  # the broker routes through it
    br.create_topic("T", partitions=1)
    br.send("T", "nk", "via broker")
    assert [(k, m) for _, k, m in br.read("T", 0, 0, 10)] == [("nk", "via broker")]


def test_native_autobuild(tmp_path):
    """A fresh checkout (no .so) compiles the library on first load when a
    toolchain is there: run in a copy of the port and the library's
    sources, in a fresh process, so the repo's own build is untouched."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    shutil.copytree(ROOT / "oryx_tpu_torch", tmp_path / "oryx_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    src = tmp_path / "native" / "oryxbus"
    src.mkdir(parents=True)
    for name in ("oryxbus.cpp", "Makefile"):
        shutil.copy(ROOT / "native" / "oryxbus" / name, src / name)
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); "
        "from oryx_tpu_torch.bus.native import NativeAppender; "
        "n = NativeAppender.load(); "
        "u, i, v, t, ok = n.parse_interactions(b'3,4,1.5,99'); "
        "assert list(u) == [3] and list(i) == [4] and ok.all(); "
        "n.append(sys.argv[1] + '/x.log', 'k', 'm'); "
        "print('AUTOBUILD_OK', n.scan(sys.argv[1] + '/x.log', 0)[1])"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          capture_output=True, text=True, timeout=180,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-800:]
    assert proc.stdout.split() == ["AUTOBUILD_OK", str(4 + 1 + 4 + 1)]
    assert (src / "liboryxbus.so").exists()


def _write(root: str, uri: str, records) -> None:
    broker = importlib.import_module(f"{root}.bus.broker").get_broker(uri)
    broker.create_topic("T", 2)
    for k, m in records[:2]:
        broker.send("T", k, m)
    broker.send_batch("T", records[2:])


def test_file_log_bytes_are_the_same_on_both_tiers_and_packages(tmp_path, monkeypatch):
    """The same sends through the native and the pure-Python appender, in
    either package, give the same partition logs byte for byte."""
    logs = {}
    for t in ("native", "python"):
        for root in PKGS:
            filelog = importlib.import_module(f"{root}.bus.filelog")
            native = _native_or_skip(root) if t == "native" else None
            monkeypatch.setattr(filelog, "_NATIVE_TRIED", True)
            monkeypatch.setattr(filelog, "_NATIVE_CACHE", native)
            d = tmp_path / f"{t}-{root}"
            _write(root, f"file://{d}", RECORDS)
            logs[(t, root)] = [(d / "T" / f"p{p}.log").read_bytes() for p in range(2)]
    first = logs[("python", "oryx_tpu")]
    assert any(first) and all(v == first for v in logs.values())


@pytest.mark.parametrize("writer,reader", [
    ("oryx_tpu", "oryx_tpu_torch"), ("oryx_tpu_torch", "oryx_tpu")])
def test_each_package_reads_the_others_file_log(tier, writer, reader, tmp_path):
    uri = f"file://{tmp_path / 'bus'}"
    _write(writer, uri, RECORDS)
    rb = importlib.import_module(f"{reader}.bus.broker").get_broker(uri)
    assert (rb._native is None) == (tier == "python")
    got = [(k, m) for p in range(2) for _, k, m in rb.read("T", p, 0, 100)]
    assert sorted(got, key=repr) == sorted(RECORDS, key=repr)


@pytest.mark.parametrize("writer,reader", [
    ("oryx_tpu", "oryx_tpu_torch"), ("oryx_tpu_torch", "oryx_tpu")])
def test_each_package_reads_the_others_datastore(tier, writer, reader, tmp_path):
    """A generation window's data.log: the same bytes from both packages
    on this tier, read back by the other package."""
    w = importlib.import_module(f"{writer}.layers.datastore")
    r = importlib.import_module(f"{reader}.layers.datastore")
    km = importlib.import_module(f"{writer}.bus.api").KeyMessage
    for root in PKGS:
        ds = importlib.import_module(f"{root}.layers.datastore")
        ds.save_generation(str(tmp_path / root), 7, [
            importlib.import_module(f"{root}.bus.api").KeyMessage(*x) for x in RECORDS])
    fa, fb = ((tmp_path / root / "oryx-7" / "data.log").read_bytes() for root in PKGS)
    assert fa == fb
    w.save_generation(str(tmp_path / "w"), 1000, [km(*x) for x in RECORDS])
    w.save_generation(str(tmp_path / "w"), 2000, [km("late", "m")])
    got = [tuple(x) for x in r.load_all_data(str(tmp_path / "w"))]
    assert got == RECORDS + [("late", "m")]
    assert r.latest_generation_ts(str(tmp_path / "w")) == 2000


def test_datastore_bytes_are_the_same_on_both_tiers(tmp_path, monkeypatch):
    from oryx_tpu_torch.bus.api import KeyMessage
    from oryx_tpu_torch.layers import datastore

    native = _native_or_skip("oryx_tpu_torch")
    blobs = []
    for n in (native, None):
        monkeypatch.setattr(datastore, "_maybe_native", lambda n=n: n)
        d = tmp_path / ("native" if n else "python")
        datastore.save_generation(str(d), 9, [KeyMessage(*x) for x in RECORDS])
        blobs.append((d / "oryx-9" / "data.log").read_bytes())
    assert blobs[0] == blobs[1] and blobs[0]


def test_executil_helpers_match_the_jax_package():
    """The CLI's --set coercion and the harness's fan-out: the same
    results in both packages."""
    results = {}
    for root in PKGS:
        ex = importlib.import_module(f"{root}.common.executil")
        results[root] = (
            ex.collect_in_parallel(4, lambda i: -i),
            ex.collect_in_parallel(5, lambda i: i * i, parallelism=3),
            ex.config_overlay_from_sets(["a.b=1", "c=[1,2]", "d=text", "e=true",
                                         "f=x=y"]),
        )
    assert results["oryx_tpu"] == results["oryx_tpu_torch"]
    assert results["oryx_tpu_torch"][2] == {"a.b": 1, "c": [1, 2], "d": "text",
                                            "e": True, "f": "x=y"}
