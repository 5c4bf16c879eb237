"""The port's twin of ``__graft_entry__.dryrun_multichip``
(oryx_tpu_torch/dryrun.py) on four CPU cells: every leg runs and holds
its own check (attention within 2e-5 of the exact version, the sharded
views bit-identical, the partitioned search's winner exact)."""

from __future__ import annotations

from oryx_tpu_torch.dryrun import ATTENTION_TOL, dryrun_multichip


def test_dryrun_multichip_four_cpu_cells():
    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == [2, 2] and out["device"] == "cpu"
    assert out["sharded_serving"] == {"shards": [1, 2], "bit_identical": True}
    assert max(out["attention"].values()) <= ATTENTION_TOL
    assert out["candidate_search"]["winner_lambda"] == "0.01"
    assert out["relay"]["chunks"] > 1
    assert out["als"]["tp_max_err"] < 1e-3
    assert "row_sharded_train" in out


def test_dryrun_multichip_odd_cell_count():
    """Three cells: a (3, 1) mesh with no model axis; the search's two
    sub-meshes are rows [0, 1] and [2]."""
    out = dryrun_multichip(3, device="cpu")
    assert out["mesh"] == [3, 1]
    assert out["candidate_search"]["winner_lambda"] == "0.01"
    assert max(out["attention"].values()) <= ATTENTION_TOL
