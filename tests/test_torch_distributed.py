"""The port's process group and global mesh (tests/test_distributed.py's
single-process contracts on port objects), and a two-process gloo twin of
tests/test_multihost.py's collectives step: a Gram sum across the process
boundary, barrier, host all-gather and broadcast, and the whole
tensor-parallel trainer with its data axis across both processes, against
the same trainer in one process, and ring and Ulysses attention with the
sequence across both processes."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.parallel.distributed import (
    DistributedConfig,
    barrier,
    global_mesh,
    host_allgather,
    host_broadcast_bytes,
    hybrid_shape,
    init_distributed,
    mesh_from_config,
)
from oryx_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, MeshSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def test_distributed_config_defaults_disabled():
    dc = DistributedConfig.from_config(load_config())
    assert dc.num_processes == 1 and dc.coordinator_address is None
    assert not dc.enabled


def test_distributed_config_enabled():
    dc = DistributedConfig.from_config(load_config(overlay={
        "oryx.compute.distributed.coordinator-address": "10.0.0.1:8476",
        "oryx.compute.distributed.num-processes": 4,
        "oryx.compute.distributed.process-id": 2,
    }))
    assert dc.enabled and dc.num_processes == 4 and dc.process_id == 2


def test_init_noop_single_process():
    assert init_distributed(load_config()) is False


def test_init_requires_coordinator():
    cfg = load_config(overlay={"oryx.compute.distributed.num-processes": 2})
    with pytest.raises(ValueError):
        init_distributed(cfg)


@pytest.mark.parametrize("args,want", [
    ((4, 8, MeshSpec(data=-1, model=4)), (2, 4, 4)),
    ((2, 8, MeshSpec()), (8, 1, 2)),
])
def test_hybrid_shape_model_within_host(args, want):
    from oryx_tpu.parallel.distributed import hybrid_shape as jax_hybrid_shape
    from oryx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec

    assert hybrid_shape(*args) == want
    spec = args[2]
    assert jax_hybrid_shape(args[0], args[1],
                            JaxMeshSpec(spec.data, spec.model)) == want


def test_hybrid_shape_rejects_cross_host_model_axis():
    with pytest.raises(ValueError):
        hybrid_shape(2, 4, MeshSpec(data=1, model=8))


def test_hybrid_shape_rejects_nondividing():
    with pytest.raises(ValueError):
        hybrid_shape(3, 8, MeshSpec(data=4, model=2))


def test_global_mesh_single_process_spans_devices():
    mesh = global_mesh(MeshSpec(data=4, model=2), [CPU] * 8)
    assert mesh.shape[DATA_AXIS] == 4 and mesh.shape[MODEL_AXIS] == 2
    assert not mesh.spans_processes and len(mesh.cells()) == 8


def test_mesh_from_config_uses_all_devices():
    # one device and no configured shape: nothing to shard over
    assert mesh_from_config(load_config(), device=CPU) is None
    mesh = mesh_from_config(load_config(overlay={
        "oryx.compute.mesh.data": 2, "oryx.compute.mesh.model": 2,
    }), device=CPU)
    assert mesh.shape[DATA_AXIS] * mesh.shape[MODEL_AXIS] == 4


def test_barrier_and_allgather_single_process():
    barrier("test")  # no-op, must not raise
    out = host_allgather(np.asarray([1, 2, 3]))
    assert out.shape == (1, 3)
    assert list(out[0]) == [1, 2, 3]


def test_trainer_picks_up_mesh_automatically(tmp_path):
    from oryx_tpu_torch.apps.als.batch import ALSUpdate

    cfg = load_config(overlay={
        "oryx.batch.storage.model-dir": str(tmp_path / "m"),
        "oryx.compute.mesh.data": 4, "oryx.compute.mesh.model": 2,
    })
    upd = ALSUpdate(cfg, device=CPU)
    assert upd.mesh is not None
    assert upd.mesh.shape[DATA_AXIS] * upd.mesh.shape[MODEL_AXIS] == 8
    assert upd.training_mesh() is upd.mesh
    assert ALSUpdate(load_config(), device=CPU).mesh is None


def test_host_broadcast_bytes_single_process():
    assert host_broadcast_bytes(b"abc", 0) == b"abc"
    assert host_broadcast_bytes(None, 0) == b""
    assert host_broadcast_bytes(b"", 0) == b""


_WORKER = r'''
import pickle
import sys

sys.path.insert(0, sys.argv[4])
import numpy as np
import torch

from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.ops.als import InteractionData, train_als_tp
from oryx_tpu_torch.ops.vector import gram
from oryx_tpu_torch.parallel.distributed import (
    barrier, global_mesh, host_allgather, host_broadcast_bytes,
    init_distributed, process_count, shutdown_distributed,
)
from oryx_tpu_torch.parallel.mesh import DATA_AXIS, MeshSpec, split_rows

pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = load_config(overlay={
    "oryx.compute.distributed.coordinator-address": f"127.0.0.1:{port}",
    "oryx.compute.distributed.num-processes": nprocs,
    "oryx.compute.distributed.process-id": pid,
})
assert init_distributed(cfg) is True
assert process_count() == nprocs

# the data axis spans the processes, the model axis stays in each
mesh = global_mesh(MeshSpec(data=2, model=2), ["cpu", "cpu"])
assert mesh.spans_processes and mesh.local_rows() == [pid]

# Gram psum across the process boundary
rows, feat = 16, 8
host = torch.arange(rows * feat, dtype=torch.float32).reshape(rows, feat) / 7.0
arr = split_rows(host, mesh, DATA_AXIS)
g = mesh.psum({c: gram(arr.block(*c)) for c in mesh.cells()}, DATA_AXIS)
expect = (host.T @ host).numpy()
for c in mesh.cells():
    np.testing.assert_allclose(g[c].numpy(), expect, rtol=1e-5)
np.testing.assert_array_equal(np.asarray(arr), host.numpy())

barrier("collectives")
got = host_allgather(np.asarray([pid, 10 + pid]))
assert got.tolist() == [[0, 10], [1, 11]], got
blob = host_broadcast_bytes(b"winner" if pid == 1 else None, 1)
assert blob == b"winner", blob

# the whole tensor-parallel trainer across both processes
with open(sys.argv[5], "rb") as f:
    want = pickle.load(f)
model = train_als_tp(
    InteractionData(*want["data"]), mesh, features=8, iterations=3,
    block=8, resume_y=want["y0"],
)
np.testing.assert_allclose(model.x, want["x"], rtol=1e-5, atol=1e-6)
np.testing.assert_allclose(model.y, want["y"], rtol=1e-5, atol=1e-6)

# ring and Ulysses attention, the sequence split across both processes:
# K/V blocks cross by batch_isend_irecv, the re-splits by all_to_all
from oryx_tpu_torch.ops.attention import attention, ring_attention, ulysses_attention

rng = np.random.default_rng(0)
q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 16, 8)).astype(np.float32))
           for _ in range(3))
for causal in (False, True):
    ref = attention(q, k, v, causal=causal).numpy()
    ring = ring_attention(q, k, v, mesh, causal=causal)
    assert set(ring.shards) == {(pid, 0), (pid, 1)}
    np.testing.assert_allclose(ring.full().numpy(), ref, rtol=2e-5, atol=2e-5)
    uly = ulysses_attention(q, k, v, mesh, causal=causal)
    np.testing.assert_allclose(uly.full().numpy(), ref, rtol=2e-5, atol=2e-5)
barrier("done")
shutdown_distributed()
print(f"MULTIPROCESS_OK {pid}", flush=True)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_collectives(tmp_path):
    """Two gloo processes: the Gram sum, barrier, all-gather and broadcast
    give the exact local results, the tensor-parallel trainer with its
    data axis across the processes matches the same (2, 2) trainer in one
    process (the sums cross processes in another order: rtol 1e-5), and
    ring and Ulysses attention across the processes match the exact
    attention within 2e-5."""
    from oryx_tpu_torch.ops.als import aggregate_interactions, train_als_tp
    from oryx_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(11)
    n = 400
    data = aggregate_interactions(
        rng.integers(0, 24, n).astype(str),
        rng.integers(0, 32, n).astype(str),
        rng.random(n).astype(np.float64) + 0.1,
        implicit=True,
    )
    y0 = (np.random.default_rng(7).standard_normal((data.n_items, 8)) * 0.1
          + 0.35).astype(np.float32)
    expect = train_als_tp(
        data, make_mesh(MeshSpec(data=2, model=2), [CPU] * 4), features=8,
        iterations=3, block=8, resume_y=y0,
    )
    blob = tmp_path / "expected.pkl"
    with open(blob, "wb") as f:
        pickle.dump({
            "data": (data.user_ids, data.item_ids, data.users, data.items,
                     data.values),
            "x": expect.x, "y": expect.y, "y0": y0,
        }, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), "2", str(port), ROOT,
             str(blob)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"MULTIPROCESS_OK {i}" in out, out[-3000:]
