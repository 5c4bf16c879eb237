"""The multi-process runtime: process group and global mesh (the port's
counterpart of oryx_tpu/parallel/distributed.py).

One process per host (or per card) joins a process group
(``torch.distributed.init_process_group``). The global mesh keeps the
"model" axis inside each process, so its collectives never leave it, and
lays the "data" axis across processes: a Gram or partial-normal-equation
sum crosses processes once a half-step (``Mesh.psum``).

Backends: gloo on the CPU; NCCL on a host with a card per process, one rank
per card. NCCL refuses two ranks on one card, so ranks that share a card
use gloo, which carries CUDA tensors through host memory.

Config (``oryx.compute.distributed.*``): coordinator-address (host:port of
process 0), num-processes, process-id; all optional, and absent means
single-process, where init is a no-op.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh

log = logging.getLogger(__name__)

_initialized = False


@dataclass(frozen=True)
class DistributedConfig:
    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_config(cls, config: Config) -> "DistributedConfig":
        g = lambda k, d: config.get(f"oryx.compute.distributed.{k}", d)  # noqa: E731
        return cls(
            coordinator_address=g("coordinator-address", None),
            num_processes=int(g("num-processes", 1) or 1),
            process_id=int(g("process-id", 0) or 0),
        )

    @property
    def enabled(self) -> bool:
        return self.num_processes > 1 or self.coordinator_address is not None


def _dist():
    import torch.distributed as dist

    return dist


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def default_backend(num_processes: int) -> str:
    """NCCL where every process can have a card of its own, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_distributed(config: Config) -> bool:
    """Join the process group when configured; no-op (False) for
    single-process deployments and on repeat calls."""
    global _initialized
    dc = DistributedConfig.from_config(config)
    if not dc.enabled or _initialized:
        return False
    if dc.coordinator_address is None:
        raise ValueError(
            "oryx.compute.distributed.num-processes > 1 requires "
            "oryx.compute.distributed.coordinator-address"
        )
    backend = default_backend(dc.num_processes)
    _dist().init_process_group(
        backend=backend,
        init_method=f"tcp://{dc.coordinator_address}",
        world_size=dc.num_processes,
        rank=dc.process_id,
    )
    _initialized = True
    log.info(
        "joined process group (%s): process %d/%d",
        backend, dc.process_id, dc.num_processes,
    )
    return True


def shutdown_distributed() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _initialized
    from oryx_tpu_torch.parallel.submesh import forget_process_groups

    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    forget_process_groups()
    _initialized = False


def hybrid_shape(n_processes: int, local_devices: int, spec: MeshSpec) -> tuple[int, int, int]:
    """(per-process data, model, processes-on-data): resolve a (data,
    model) mesh spec against a multi-process topology. The model axis must
    fit inside one process so its collectives never cross processes; the
    data axis is process-major."""
    data, model = spec.resolve(n_processes * local_devices)
    if model > local_devices:
        raise ValueError(
            f"model axis {model} exceeds {local_devices} local devices; "
            "tensor-parallel groups must not span processes"
        )
    if local_devices % model != 0:
        raise ValueError(f"model axis {model} must divide local devices {local_devices}")
    if data % n_processes != 0:
        raise ValueError(f"data axis {data} must be a multiple of {n_processes} processes")
    per_host_data = data // n_processes
    if per_host_data * model != local_devices:
        raise ValueError(
            f"mesh {data}x{model} does not tile {n_processes} processes "
            f"x {local_devices} devices"
        )
    return per_host_data, model, n_processes


def global_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """The mesh across every process. Single-process: ``make_mesh``.
    Multi-process: each process contributes ``devices`` (default its
    local devices) as its data rows, in rank order, and the model axis
    stays inside each process. Entries may repeat, so two processes that
    share one card each pass ``[cuda:0, cuda:0]`` for a (2, 2) mesh."""
    from oryx_tpu_torch.parallel.shardspec import local_devices

    spec = spec or MeshSpec()
    devices = list(local_devices() if devices is None else devices)
    n_proc = process_count()
    if n_proc == 1:
        return make_mesh(spec, devices)
    per_host_data, model, hosts = hybrid_shape(n_proc, len(devices), spec)
    rank = process_index()
    grid = np.empty((per_host_data * hosts, model), dtype=object)
    rows = []
    for p in range(hosts):
        for r in range(per_host_data):
            d = p * per_host_data + r
            rows.append(p)
            for m in range(model):
                # another process's devices are named for the grid's
                # shape only: this process never touches them
                dev = devices[r * model + m] if p == rank else torch.device("meta")
                grid[d, m] = torch.device(dev)
    return Mesh(grid, row_process=rows)


def mesh_from_config(config: Config, device=None) -> Mesh | None:
    """The deployment's training mesh per ``oryx.compute.mesh.*``, or None
    where there is nothing to shard over: one device and no mesh shape
    configured. A configured shape on one card lays its cells on that
    card (entries repeat)."""
    from oryx_tpu_torch.parallel.shardspec import local_devices

    devices = local_devices(device)
    data = config.get_int("oryx.compute.mesh.data", -1)
    model = config.get_int("oryx.compute.mesh.model", 1)
    if process_count() == 1 and len(devices) == 1 and data <= 1 and model <= 1:
        return None
    spec = MeshSpec(data=data, model=model)
    if process_count() == 1:
        d, m = spec.resolve(max(len(devices), max(data, 1) * max(model, 1)))
        return make_mesh(MeshSpec(d, m), [devices[j % len(devices)]
                                          for j in range(d * m)])
    return global_mesh(spec, devices)


def barrier(name: str = "oryx") -> None:
    """Block until every process reaches this point (e.g. before an atomic
    model publish). No-op single-process."""
    if process_count() == 1:
        return
    log.debug("barrier %s", name)
    _dist().barrier()


def host_broadcast_bytes(payload: bytes | None, src_process: int) -> bytes:
    """Ship a byte string from one process to every process (length
    first, then the buffer). All processes must call it together."""
    if process_count() == 1:
        return payload or b""
    dist = _dist()
    is_src = process_index() == src_process
    n = torch.tensor(
        [len(payload) if (is_src and payload is not None) else 0],
        dtype=torch.int64,
    )
    dist.broadcast(n, src=src_process)
    total = int(n.item())
    buf = torch.zeros(total, dtype=torch.uint8)
    if is_src and total:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    if total:
        dist.broadcast(buf, src=src_process)
    return buf.numpy().tobytes()


def host_allgather(x) -> np.ndarray:
    """Gather a small host-side value from every process (e.g. per-process
    record counts). Returns [num_processes, ...] of the value's dtype:
    int64 travels whole (a millisecond timestamp, a mature offset)."""
    a = np.asarray(x)
    if process_count() == 1:
        return a[None]
    dist = _dist()
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return np.stack([o.numpy() for o in out])
