"""Device mesh, row-shard planning and the process group (the port's
counterpart of oryx_tpu/parallel/).

A ``Mesh`` is a (data, model) grid of torch devices. Its entries may
repeat: a (2, 2) mesh over one card runs four cells on ``cuda:0``, and
``host_mesh(8)`` over the CPU stands in for the JAX package's eight virtual
CPU devices. The collectives that XLA inserts in the JAX package are
explicit here: ``Mesh.psum`` sums the cells' tensors along an axis, and
follows that with ``torch.distributed.all_reduce`` where the axis spans
processes (``parallel/distributed.py``), over the mesh's process group;
``ppermute`` and ``all_to_all`` carry sequence-parallel attention
(ops/attention.py). ``submesh.py`` partitions a mesh for the parallel
candidate search: by data rows in one process, by process group across a
pod.
"""

from oryx_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshArray,
    MeshSpec,
    host_mesh,
    make_mesh,
    model_mesh,
    pad_to_multiple,
    shard_array,
)
from oryx_tpu_torch.parallel.shardspec import RowShards, shard_devices
from oryx_tpu_torch.parallel.submesh import process_groups

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshArray",
    "MeshSpec",
    "RowShards",
    "host_mesh",
    "make_mesh",
    "model_mesh",
    "pad_to_multiple",
    "process_groups",
    "shard_array",
    "shard_devices",
]
