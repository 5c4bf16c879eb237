"""Datastore crash-recovery: a kill between staged write and rename (for
both the generation window log and the aggregate snapshot) must never let
a reload observe a half-written file.

The write paths are torn deliberately at every stage boundary a real
crash can hit — mid-append for the window log (simulated with a
truncation and, separately, a hard os._exit in a child process via the
fault harness's crash kind), tmp-written-but-not-renamed and
staged-but-not-finalized for snapshots — and the reload contract is
asserted after each: only complete records, only finalized snapshots.

Port twin of tests/test_datastore_crash.py, on port objects.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.faults import InjectedFault, get_injector
from oryx_tpu_torch.common.retry import RetryPolicy
from oryx_tpu_torch.layers.datastore import (
    finalize_aggregate_snapshot,
    iter_all_data,
    load_aggregate_snapshot,
    load_all_data,
    save_aggregate_snapshot,
    save_generation,
)

FAST = RetryPolicy(attempts=1, base_s=0.001, max_s=0.001, deadline_s=1.0)


@pytest.fixture(autouse=True)
def _disarm():
    get_injector().disarm()
    yield
    get_injector().disarm()


# ---- window persist -------------------------------------------------------

def test_torn_window_append_reloads_complete_prefix_only(tmp_path):
    """Crash mid-append: the tail record is torn; the reload must see
    every complete record and NOTHING of the torn one."""
    d = str(tmp_path / "data")
    save_generation(d, 1000, [KeyMessage("a", "m1"), KeyMessage("b", "m2")])
    gen = Path(d) / "oryx-1000" / "data.log"
    whole = gen.read_bytes()
    # append a third record, then cut it mid-payload (what a crash
    # between write() and completion leaves on disk)
    save_generation(d, 1000, [KeyMessage("c", "m3-longer-payload")])
    torn = gen.read_bytes()
    gen.write_bytes(torn[: len(whole) + (len(torn) - len(whole)) // 2])
    got = load_all_data(d)
    assert [km.message for km in got] == ["m1", "m2"]
    # the log heals: appending after the torn tail is rolled back by a
    # fresh save still yields a consistent stream
    save_generation(d, 2000, [KeyMessage("d", "m4")])
    assert [km.message for km in iter_all_data(d)] == ["m1", "m2", "m4"]


def test_window_save_retries_transient_failure(tmp_path):
    d = str(tmp_path / "data")
    get_injector().arm("datastore.save_window", kind="error", count=1)
    save_generation(d, 1000, [KeyMessage(None, "m1")])  # retry absorbs it
    assert [km.message for km in load_all_data(d)] == ["m1"]


def test_window_save_exhaustion_leaves_no_partial_generation(tmp_path):
    d = str(tmp_path / "data")
    get_injector().arm("datastore.save_window", kind="error", count=-1)
    with pytest.raises(InjectedFault):
        import oryx_tpu_torch.common.retry as retry_mod

        old = retry_mod._default_policy
        retry_mod._default_policy = FAST
        try:
            save_generation(d, 1000, [KeyMessage(None, "m1")])
        finally:
            retry_mod._default_policy = old
    assert load_all_data(d) == []  # offsets stay uncommitted; re-delivered


def test_crash_kill_during_window_persist_subprocess(tmp_path):
    """The real thing: a child process is KILLED (os._exit via the crash
    fault) between persisting the window and committing offsets; the
    reload in THIS process must see either nothing or complete records —
    never a half-written file."""
    d = str(tmp_path / "data")
    code = f"""
import sys; sys.path.insert(0, {str(Path(__file__).resolve().parent.parent)!r})
from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.faults import get_injector
from oryx_tpu_torch.layers.datastore import save_generation
save_generation({d!r}, 1000, [KeyMessage("a", "before-crash")])
get_injector().arm("datastore.save_window", kind="crash", count=1, after=0)
save_generation({d!r}, 2000, [KeyMessage("b", "dies-mid-write")])
print("UNREACHABLE")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=60,
    )
    assert proc.returncode == 137  # the injected hard kill
    assert "UNREACHABLE" not in proc.stdout
    got = load_all_data(d)
    assert [km.message for km in got] == ["before-crash"]


# ---- aggregate snapshots --------------------------------------------------

def _arrays():
    return {"v": np.arange(4, dtype=np.int64)}


def test_crash_before_tmp_rename_leaves_no_snapshot(tmp_path, monkeypatch):
    d = str(tmp_path / "data")
    get_injector().arm("datastore.snapshot_write", kind="error", count=1)
    with pytest.raises(InjectedFault):
        save_aggregate_snapshot(d, 1000, "fp", _arrays())
    assert load_aggregate_snapshot(d, "fp") is None
    # no tmp litter either
    snap_dir = Path(d) / ".agg-snapshot"
    assert not any(snap_dir.glob("*.tmp.npz")) if snap_dir.exists() else True


def test_staged_snapshot_invisible_until_finalized(tmp_path):
    """Kill between the staged write and the finalize rename: the staged
    file exists but load ignores it — the next generation sees
    stale-or-missing state and takes the from-scratch fallback that
    re-anchors it."""
    d = str(tmp_path / "data")
    save_aggregate_snapshot(d, 1000, "fp", _arrays(), staged=True)
    assert load_aggregate_snapshot(d, "fp") is None  # crash here = safe
    assert finalize_aggregate_snapshot(d, 1000) is True
    ts, arrays = load_aggregate_snapshot(d, "fp")
    assert ts == 1000 and list(arrays["v"]) == [0, 1, 2, 3]


def test_finalize_rename_fault_retries_then_promotes(tmp_path):
    d = str(tmp_path / "data")
    save_aggregate_snapshot(d, 1000, "fp", _arrays(), staged=True)
    get_injector().arm("datastore.snapshot_rename", kind="error", count=1)
    assert finalize_aggregate_snapshot(d, 1000) is True  # retry absorbs
    assert load_aggregate_snapshot(d, "fp") is not None


def test_finalize_rename_exhaustion_keeps_staged_state(tmp_path):
    """Rename failing past the retry budget: the error propagates (the
    batch layer logs a failed generation) but the staged file SURVIVES,
    so no state is lost — and the snapshot is still not loadable, so the
    next generation correctly falls back instead of trusting a
    half-promoted aggregate."""
    import oryx_tpu_torch.common.retry as retry_mod

    d = str(tmp_path / "data")
    save_aggregate_snapshot(d, 1000, "fp", _arrays(), staged=True)
    get_injector().arm("datastore.snapshot_rename", kind="error", count=-1)
    old = retry_mod._default_policy
    retry_mod._default_policy = FAST
    try:
        with pytest.raises(InjectedFault):
            finalize_aggregate_snapshot(d, 1000)
    finally:
        retry_mod._default_policy = old
    assert load_aggregate_snapshot(d, "fp") is None
    staged = Path(d) / ".agg-snapshot" / "agg-1000.npz.staged"
    assert staged.exists()
    # once the filesystem heals, finalize completes idempotently
    get_injector().disarm()
    assert finalize_aggregate_snapshot(d, 1000) is True
    assert load_aggregate_snapshot(d, "fp") is not None


def test_torn_snapshot_file_ignored_with_fallback(tmp_path):
    """A snapshot whose bytes were cut mid-write (pre-rename crash made
    visible by a buggy filesystem) must read as 'no snapshot', not crash
    the generation."""
    d = str(tmp_path / "data")
    path = save_aggregate_snapshot(d, 1000, "fp", _arrays())
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    assert load_aggregate_snapshot(d, "fp") is None
