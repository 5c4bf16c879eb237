"""Fleet-scale chaos against the port (tests/test_fleet_chaos.py's three
scenarios, from tests/torch_fleet_chaos.py): two real serving replica
processes of oryx_tpu_torch on the CPU behind the fleet front.

- ``fleet-kill``: SIGKILL one replica mid update-storm; the front keeps
  answering (zero non-shed 5xx, zero client-level errors), ejects the
  corpse, and the survivor's model staleness stays under its bound.
- ``flight-on-kill``: the supervisor harvests the corpse's flight ring
  (its generation adoptions), and the front's ejection event names the
  same replica id.
- ``fleet-canary``: a corrupted generation adopts on the canary only, the
  quality gate refuses it, the rollback is a pointer swap (zero new
  distribution bytes), no client sees a non-shed 5xx, and the flight
  rings read canary-start -> quality-alarm -> canary-rollback.
- ``canary-restart``: the same rollout, then the rolled-back canary is
  SIGKILLed; its restart replays the update topic and serves the promoted
  generation, never the vetoed one.

Each scenario runs under a time limit of its own: a scenario that has not
returned by then fails the test instead of holding the run, and its
replica processes and front are stopped first, so none outlives the test.
"""

from __future__ import annotations

import threading

import pytest

from torch_fleet_chaos import SCENARIOS


def _run_within(limit_s: float, name: str, tmp: str) -> list[str]:
    """Run one scenario on a thread and fail if it outlives ``limit_s``,
    after stopping every supervisor and front it started."""
    _, fn = SCENARIOS[name]
    out: dict = {}
    live: list = []

    def body():
        try:
            out["problems"] = fn(tmp, live)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            out["error"] = e

    t = threading.Thread(target=body, name=f"chaos-{name}", daemon=True)
    t.start()
    t.join(limit_s)
    if t.is_alive():
        for stop in reversed(live):
            try:
                stop()
            except Exception:  # noqa: BLE001 - the test fails below anyway
                pass
        t.join(30)  # its own cleanup, now that its processes are gone
        pytest.fail(f"scenario {name} ran past its {limit_s:.0f} s limit")
    if "error" in out:
        raise out["error"]
    return out["problems"]


def test_fleet_kill_zero_non_shed_5xx_and_bounded_staleness(tmp_path):
    assert _run_within(120, "fleet-kill", str(tmp_path)) == []


def test_flight_on_kill_harvests_corpse_last_words(tmp_path):
    assert _run_within(120, "flight-on-kill", str(tmp_path)) == []


def test_fleet_canary_gates_bad_generation_and_rolls_back_pointer(tmp_path):
    assert _run_within(240, "fleet-canary", str(tmp_path)) == []


def test_canary_restart_after_rollback_never_serves_vetoed(tmp_path):
    assert _run_within(300, "canary-restart", str(tmp_path)) == []
