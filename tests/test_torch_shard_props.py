"""Edge-shape properties of the port's sharding plumbing
(tests/test_shard_props.py's contracts on port objects): row counts not
divisible by the shard count, one-cell meshes and empty deltas keep the
row set exactly, and the row plans equal the JAX package's."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from oryx_tpu.parallel.shardspec import RowShards as JaxRowShards
from oryx_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, MeshSpec, host_mesh, make_mesh, model_mesh,
    pad_to_multiple, shard_array,
)
from oryx_tpu_torch.parallel.shardspec import RowShards, process_groups, shard_devices

CPU = "cpu"


def test_pad_to_multiple_props():
    for n in (0, 1, 2, 3, 5, 7, 8, 63, 64, 65, 1000):
        for m in (1, 2, 3, 4, 7, 8, 64):
            p = pad_to_multiple(n, m)
            assert p % m == 0 and p >= n and p - n < m


@pytest.mark.parametrize("mesh_n", [1, 2, 3, 4, 8])
def test_shard_array_uneven_rows_keep_every_row(mesh_n):
    mesh = host_mesh(mesh_n, CPU)
    for n_rows in (1, 2, 3, 5, 7, 9, 17):
        a = np.arange(n_rows * 3, dtype=np.float32).reshape(n_rows, 3)
        out = shard_array(a, mesh)
        assert out.shape[0] == pad_to_multiple(n_rows, mesh_n)
        host = np.asarray(out)
        np.testing.assert_array_equal(host[:n_rows], a)
        assert not host[n_rows:].any()
        blocks = [out.block(d, 0) for d in range(mesh_n)]
        assert len({b.shape for b in blocks}) == 1


def test_shard_array_one_device_mesh_is_identity_shape():
    mesh = host_mesh(1, CPU)
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    out = shard_array(a, mesh)
    assert out.shape == a.shape
    np.testing.assert_array_equal(np.asarray(out), a)
    s = shard_array(np.float32(3.0), mesh)
    assert np.asarray(s) == np.float32(3.0)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 200), s=st.integers(1, 12))
def test_rowshards_plan_matches_process_groups_contract(n, s):
    plan = RowShards.plan(n, s)
    assert plan.bounds == JaxRowShards.plan(n, s).bounds
    sizes = [plan.size(j) for j in range(plan.n_shards)]
    assert sum(sizes) == n
    if n == 0:
        assert plan.n_shards == s
        return
    assert sizes == [len(g) for g in process_groups(list(range(n)), s)]
    assert plan.n_shards == min(s, n)
    assert sizes == sorted(sizes, reverse=True)
    assert max(sizes) - min(sizes) <= 1


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 70), s=st.integers(1, 8), grow=st.integers(0, 9))
def test_rowshards_slices_partition_exactly(n, s, grow):
    plan = RowShards.plan(n, s).grown(n + grow)
    a = np.arange((n + grow) * 2).reshape(n + grow, 2)
    np.testing.assert_array_equal(np.concatenate(plan.slices(a)), a)
    for row in range(n + grow):
        j = plan.owner(row)
        assert plan.bounds[j] <= row < plan.bounds[j + 1]
    # growth joins the last shard: no row of the old plan moves
    old = RowShards.plan(n, s)
    assert plan.bounds[:-1] == old.bounds[:-1]


def test_rowshards_split_edge_deltas():
    plan = RowShards.plan(10, 4)  # sizes [3, 3, 2, 2]
    assert plan.split(np.array([], dtype=np.int64)) == []
    rows = np.arange(20, dtype=np.float32).reshape(10, 2)
    out = plan.split(np.array([3, 4]), rows[[3, 4]])
    assert len(out) == 1
    s, local, payload = out[0]
    assert s == 1
    np.testing.assert_array_equal(local, [0, 1])
    np.testing.assert_array_equal(payload, rows[[3, 4]])
    out = plan.split(np.array([9, 0, 6]), rows[[9, 0, 6]])
    got = {s: (local.tolist(), payload.tolist()) for s, local, payload in out}
    assert set(got) == {0, 2, 3}
    assert got[0] == ([0], [rows[0].tolist()])
    assert got[2] == ([0], [rows[6].tolist()])
    assert got[3] == ([1], [rows[9].tolist()])
    with pytest.raises(IndexError):
        plan.split(np.array([10]), rows[:1])
    with pytest.raises(ValueError):
        RowShards.plan(5, 0)
    with pytest.raises(ValueError):
        plan.grown(9)


def test_shard_devices_distinct_when_available():
    devs = [torch.device(CPU), torch.device("meta")]
    got = shard_devices(4, devs)
    assert got == [devs[0], devs[1], devs[0], devs[1]]
    assert shard_devices(1, devs) == [devs[0]]
    with pytest.raises(ValueError):
        shard_devices(2, [])
    # the CPU's own devices: one, shared by every shard
    assert set(shard_devices(3, [CPU])) == {torch.device(CPU)}


def test_make_mesh_model_axis():
    m = model_mesh(2, CPU)
    assert m.shape[MODEL_AXIS] == 2 and m.shape[DATA_AXIS] == 1
    one = make_mesh(MeshSpec(data=1, model=1), [CPU])
    assert one.size == 1
    with pytest.raises(ValueError):
        make_mesh(MeshSpec(data=2, model=2), [CPU] * 3)
    grid = make_mesh(MeshSpec(data=2, model=2), [CPU] * 4)
    assert grid.cells() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    parts = {c: torch.tensor([float(10 * c[0] + c[1])]) for c in grid.cells()}
    over_model = grid.psum(parts, MODEL_AXIS)
    over_data = grid.psum(parts, DATA_AXIS)
    assert over_model[(1, 0)].item() == 21.0 and over_data[(0, 1)].item() == 12.0
    gathered = grid.all_gather(parts, DATA_AXIS)
    assert gathered[(0, 1)].tolist() == [1.0, 11.0]
