"""Sub-mesh parallel hyperparameter candidates of the PyTorch port
(oryx_tpu_torch/parallel/submesh.py, ml/update.py): the contracts of
tests/test_ml_submesh.py on port meshes over the CPU, then both packages'
partitioned searches on the same data.

A port mesh's entries may repeat; these tests name the eight CPU cells
``cpu:0`` .. ``cpu:7`` (distinct torch devices that all place tensors on
the CPU) where the JAX tests compare device ids, the analogue of the
conftest's eight virtual CPU devices. Winners are exact (a lambda string).
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import oryx_tpu_torch.parallel.submesh as sm
from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer
from oryx_tpu_torch.bus.broker import get_broker
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.parallel import distributed
from oryx_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh
from oryx_tpu_torch.parallel.submesh import (
    candidate_mesh,
    current_candidate_mesh,
    partition_mesh,
    process_groups,
)

CELLS = [f"cpu:{i}" for i in range(8)]


def _ids(mesh):
    return {str(d) for d in mesh.devices.ravel()}


def test_partition_mesh_shapes():
    mesh = make_mesh(MeshSpec(data=8, model=1), CELLS)
    two = partition_mesh(mesh, 2)
    assert [m.devices.shape for m in two] == [(4, 1), (4, 1)]
    # disjoint device groups
    assert _ids(two[0]).isdisjoint(_ids(two[1]))
    three = partition_mesh(mesh, 3)
    assert [m.devices.shape[0] for m in three] == [3, 3, 2]
    assert partition_mesh(mesh, 1) == [mesh]
    # more groups than data rows: clamps to the row count
    tiny = make_mesh(MeshSpec(data=2, model=2), CELLS[:4])
    assert len(partition_mesh(tiny, 8)) == 2
    # model axis is never split
    assert all(m.devices.shape[1] == 2 for m in partition_mesh(tiny, 2))


def test_process_groups_contiguous_and_balanced():
    assert process_groups([0, 1, 2, 3], 2) == [[0, 1], [2, 3]]
    assert process_groups([0, 1, 2, 3, 4], 2) == [[0, 1, 2], [3, 4]]
    assert process_groups([0, 1], 8) == [[0], [1]]
    assert process_groups([3, 7], 2) == [[3], [7]]
    assert process_groups([0, 1, 2], 1) == [[0, 1, 2]]


def test_pod_group_submesh_single_process_falls_back():
    # one process cannot form process groups: callers get None and run
    # the serial search (the thread/sub-mesh path covers this case)
    mesh = make_mesh(MeshSpec(data=4, model=2), CELLS)
    assert sm.pod_group_submesh(mesh, 2) is None


def _owned_mesh(owners):
    """A (len(owners), 1) mesh whose data row r is held by process
    owners[r]."""
    grid = np.array([["cpu"] for _ in owners], dtype=object)
    return Mesh(grid, row_process=owners)


def _fake_pod(monkeypatch, count, me):
    monkeypatch.setattr(distributed, "process_count", lambda: count)
    monkeypatch.setattr(distributed, "process_index", lambda: me)
    made = []
    monkeypatch.setattr(sm, "process_group",
                        lambda ranks: made.append(list(ranks)) or tuple(ranks))
    return made


def test_pod_group_submesh_partial_process_set_falls_back(monkeypatch):
    """A training mesh whose rows cover only a SUBSET of the pod's
    processes sends EVERY member down the serial fallback: partitioning
    while the member left out returns None would diverge control flow
    across the pod and wedge its collectives."""
    _fake_pod(monkeypatch, 3, 1)
    assert sm.pod_group_submesh(_owned_mesh([0, 0, 1, 1]), 2) is None

    made = _fake_pod(monkeypatch, 2, 1)
    res = sm.pod_group_submesh(_owned_mesh([0, 0, 1, 1]), 2)
    assert res is not None
    my_group, groups, sub = res
    assert my_group == 1 and groups == [[0], [1]]
    assert sub.devices.shape == (2, 1) and sub.row_process == (1, 1)
    # every member makes every group's process group, in group order
    assert made == [[0], [1]] and sub.group == (1,)


def test_pod_group_and_partition_mesh_share_one_contract(monkeypatch):
    """pod_group_submesh and partition_mesh agree about ordering when k
    exceeds the unit count: min(k, n) contiguous groups in input order,
    larger groups first, the effective parallelism read from the RESULT —
    and every member computes the IDENTICAL groups list and makes the
    same process groups in the same order."""
    owners = [0, 0, 1, 1, 2, 2]  # host-major, 3 processes x 2 rows
    for k in (2, 3, 5, 8):
        seen_groups, seen_made = [], []
        for me in range(3):
            made = _fake_pod(monkeypatch, 3, me)
            my_group, groups, _ = sm.pod_group_submesh(_owned_mesh(owners), k)
            seen_groups.append(groups)
            seen_made.append(made)
            assert len(groups) == min(k, 3)
            assert me in groups[my_group]
        assert all(g == seen_groups[0] for g in seen_groups)
        assert all(m == seen_groups[0] for m in seen_made)
        assert seen_groups[0] == process_groups([0, 1, 2], k)
        # one leader per group: their sub-mesh rows concatenate to the
        # mesh's rows exactly once, in mesh order (contiguous runs)
        per_group = []
        for procs in seen_groups[0]:
            _fake_pod(monkeypatch, 3, procs[0])
            _, _, sub = sm.pod_group_submesh(_owned_mesh(owners), k)
            per_group.extend(sub.row_process)
        assert per_group == owners
        # partition_mesh obeys the same contract over ROWS (of a mesh in
        # one process)
        subs = partition_mesh(make_mesh(MeshSpec(6, 1), CELLS[:6]), k)
        assert [s.devices.shape[0] for s in subs] == [
            len(g) for g in process_groups(list(range(6)), k)
        ]
    # NON-host-major rows break the contiguous-groups contract: every
    # member falls back together (None), deterministically
    for me in range(2):
        _fake_pod(monkeypatch, 2, me)
        assert sm.pod_group_submesh(_owned_mesh([0, 1, 0, 1]), 2) is None


def test_partition_mesh_refuses_a_mesh_across_processes():
    with pytest.raises(ValueError, match="pod_group_submesh"):
        partition_mesh(_owned_mesh([0, 1]), 2)


def test_candidate_mesh_is_thread_local():
    mesh = make_mesh(MeshSpec(data=2, model=1), CELLS[:2])
    seen = {}

    def worker():
        seen["other"] = current_candidate_mesh()

    with candidate_mesh(mesh):
        assert current_candidate_mesh() is mesh
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["other"] is None
    assert current_candidate_mesh() is None


def _overlay(tmp_path, parallelism: int) -> dict:
    return {
        "oryx.id": f"submesh{parallelism}",
        "oryx.batch.storage.model-dir": str(tmp_path / f"m{parallelism}"),
        "oryx.ml.eval.candidates": 2,
        "oryx.ml.eval.parallelism": parallelism,
        "oryx.ml.eval.hyperparam-search": "grid",
        "oryx.ml.eval.test-fraction": 0.2,
        "oryx.als.hyperparams.features": 8,
        "oryx.als.hyperparams.iterations": 4,
        "oryx.als.hyperparams.alpha": 10.0,
        # one sane lambda, one absurd one: the winner is unambiguous
        "oryx.als.hyperparams.lambda": [0.01, 500.0],
        "oryx.als.no-known-items": True,
    }


def _interactions(n=1500, users=40, items=30) -> list[tuple]:
    rng = np.random.default_rng(17)
    # planted block structure so AUC clearly separates the two lambdas
    out = []
    for j in range(n):
        u = int(rng.integers(0, users))
        i = (u % 3) * (items // 3) + int(rng.integers(0, items // 3))
        out.append((None, f"u{u},i{i},1,{j}"))
    return out


def _winner(broker) -> str:
    recs = broker.read("U", 0, 0, 5)
    model_msgs = [m for _, k, m in recs if k == "MODEL"]
    assert model_msgs, recs
    return json.loads(model_msgs[0])["extensions"]["lambda"]


@pytest.mark.parametrize("topology", ["data8", "tp2"])
def test_parallel_submesh_candidates_match_serial_winner(tmp_path, topology):
    from oryx_tpu_torch.apps.als.batch import ALSUpdate

    if topology == "data8":
        mesh = make_mesh(MeshSpec(data=8, model=1), CELLS)
    else:  # tensor-parallel candidates stay tensor-parallel in sub-meshes
        mesh = make_mesh(MeshSpec(data=4, model=2), CELLS)
    data = [KeyMessage(*km) for km in _interactions()]
    observed: list[tuple] = []

    class Spy(ALSUpdate):
        def build_model(self, train, hyperparams):
            observed.append((hyperparams["lambda"], current_candidate_mesh()))
            return super().build_model(train, hyperparams)

    def run(parallelism: int) -> str:
        broker = get_broker(f"mem://submesh-{topology}-{parallelism}")
        broker.create_topic("U", partitions=1)
        cfg = load_config(overlay=_overlay(tmp_path / topology, parallelism))
        RandomManager.use_test_seed(77)
        upd = Spy(cfg, device="cpu", mesh=mesh)
        upd.run_update(
            1000, data, [], str(tmp_path / topology / f"model-p{parallelism}"),
            TopicProducer(broker, "U"),
        )
        return _winner(broker)

    serial_winner = run(1)
    # serial mode: no sub-mesh assigned, full mesh used
    assert all(m is None for _, m in observed)
    observed.clear()

    parallel_winner = run(2)
    # both candidates built on DISJOINT sub-meshes of the right shape
    metas = [m for _, m in observed]
    assert None not in metas and len({id(m) for m in metas}) == 2
    a, b = metas
    assert a.size == b.size == mesh.size // 2
    if topology == "tp2":
        assert a.devices.shape[1] == 2  # model axis intact
    assert _ids(a).isdisjoint(_ids(b))

    assert parallel_winner == serial_winner == "0.01"


def test_both_packages_pick_the_same_winner(tmp_path):
    """The JAX package's partitioned search on its eight virtual CPU
    devices and the port's on eight CPU cells, same data and config: the
    same winning lambda (the factor inits are each package's own
    streams)."""
    import jax

    from oryx_tpu.apps.als.batch import ALSUpdate as JaxALSUpdate
    from oryx_tpu.bus.api import KeyMessage as JaxKeyMessage
    from oryx_tpu.bus.api import TopicProducer as JaxTopicProducer
    from oryx_tpu.bus.broker import get_broker as jax_get_broker
    from oryx_tpu.common.config import load_config as jax_load_config
    from oryx_tpu.common.rng import RandomManager as JaxRandom
    from oryx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from oryx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from oryx_tpu_torch.apps.als.batch import ALSUpdate

    rows = _interactions()
    jb = jax_get_broker("mem://submesh-both-jax")
    jb.create_topic("U", partitions=1)
    JaxRandom.use_test_seed(77)
    JaxALSUpdate(jax_load_config(overlay=_overlay(tmp_path / "j", 2)),
                 mesh=jax_make_mesh(JaxMeshSpec(8, 1), jax.devices("cpu"))
                 ).run_update(1000, [JaxKeyMessage(*r) for r in rows], [],
                              str(tmp_path / "j" / "model"), JaxTopicProducer(jb, "U"))
    pb = get_broker("mem://submesh-both-port")
    pb.create_topic("U", partitions=1)
    RandomManager.use_test_seed(77)
    ALSUpdate(load_config(overlay=_overlay(tmp_path / "p", 2)), device="cpu",
              mesh=make_mesh(MeshSpec(8, 1), CELLS)
              ).run_update(1000, [KeyMessage(*r) for r in rows], [],
                           str(tmp_path / "p" / "model"), TopicProducer(pb, "U"))
    assert _winner(pb) == _winner(jb) == "0.01"


def test_cells_of_indexed_cpu_devices_hold_cpu_tensors():
    """The test meshes' ``cpu:i`` cells are distinct devices whose tensors
    live on the CPU."""
    mesh = make_mesh(MeshSpec(2, 1), CELLS[:2])
    out = mesh.psum({c: torch.ones(2) for c in mesh.cells()}, "data")
    assert all(t.device.type == "cpu" and float(t[0]) == 2.0 for t in out.values())
