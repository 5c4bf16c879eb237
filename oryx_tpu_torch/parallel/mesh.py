"""Mesh construction and the explicit collectives (the port's counterpart
of oryx_tpu/parallel/mesh.py).

Design: one logical mesh with axes ("data", "model"), as in the JAX
package. The trainers shard their leading entity dimension over "data" and
keep factor tables replicated or sharded over "model". Where XLA inserts
the collectives in the JAX package (a psum for a Gram matrix, an
all-gather for a factor read), the port calls them itself:

- ``Mesh.psum(parts, axis)`` sums the cells' tensors along ``axis`` in a
  fixed order and hands every cell of the group the same sum on its own
  device; where the axis spans processes the local sum is followed by
  ``torch.distributed.all_reduce`` over the mesh's process group, so every
  process holds the same bits.
- ``Mesh.all_gather(parts, axis, dim)`` concatenates the cells' blocks
  along ``dim`` in ``axis`` order (``torch.distributed.all_gather`` over
  the group across processes).
- ``Mesh.ppermute(parts, axis, shift)`` rotates the cells' blocks along
  ``axis`` (``jax.lax.ppermute`` with the ring permutation ``j -> j +
  shift``; ``batch_isend_irecv`` across processes).
- ``Mesh.all_to_all(parts, axis, split_dim, concat_dim)`` is the tiled
  ``jax.lax.all_to_all`` (``torch.distributed.all_to_all`` across
  processes).

Across processes gloo carries CUDA tensors for all_reduce and all_gather;
its point-to-point and all-to-all take host tensors, so those two stage a
card's blocks through host memory explicitly when the group's backend is
gloo.

A ``Mesh`` is a grid of torch devices whose entries may repeat: a (2, 2)
mesh over one card runs its four cells on ``cuda:0``, one after another.
A process holds the cells of its own data rows (``local_rows``); the model
axis never spans processes (``parallel/distributed.hybrid_shape``).
``MeshArray`` is an array laid out on a mesh: each local cell's block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; -1 means 'all remaining devices'."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model if self.model > 0 else 1
        data = self.data if self.data > 0 else max(1, n_devices // model)
        if data * model > n_devices:
            raise ValueError(
                f"mesh {data}x{model} needs {data * model} devices, have {n_devices}"
            )
        return data, model


class Mesh:
    """A (data, model) grid of torch devices.

    ``row_process[d]`` is the rank of the process that holds data row d
    (all this process's rank for a mesh inside one process). A data axis
    that spans processes reduces over ``group``: the
    ``torch.distributed`` process group of exactly those processes, or
    None for the whole world (then the mesh must span every process)."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices, row_process=None, group=None):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for (d, m), dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[d, m] = torch.device(dev)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("a mesh is a non-empty (data, model) grid")
        self.devices = grid
        rank = _rank()
        self.row_process = tuple(
            rank for _ in range(grid.shape[0])
        ) if row_process is None else tuple(int(p) for p in row_process)
        if len(self.row_process) != grid.shape[0]:
            raise ValueError("row_process needs one rank per data row")
        self.process_index = rank
        self.group = group

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.row_process)) > 1

    @property
    def processes(self) -> list[int]:
        """The ranks whose processes hold the mesh's rows, ascending: the
        group's members, in the order its collectives rank them."""
        return sorted(set(self.row_process))

    def select_rows(self, rows, group=None) -> "Mesh":
        """The sub-mesh of data rows ``rows`` (in that order) with the
        whole model axis; ``group`` is the process group of its processes
        when they are several."""
        rows = list(rows)
        return Mesh(self.devices[rows, :],
                    row_process=[self.row_process[r] for r in rows],
                    group=group)

    def local_rows(self) -> list[int]:
        return [d for d, p in enumerate(self.row_process) if p == self.process_index]

    def cells(self) -> list[tuple[int, int]]:
        """This process's cells, row-major."""
        return [(d, m) for d in self.local_rows()
                for m in range(self.devices.shape[1])]

    def device(self, d: int, m: int) -> torch.device:
        return self.devices[d, m]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]}, "
                f"devices={sorted({str(d) for d in self.devices.ravel()})})")

    # -- collectives --------------------------------------------------------

    def _groups(self, axis: str) -> list[list[tuple[int, int]]]:
        """The local cells of each reduction group along ``axis``, in
        axis order."""
        if axis == MODEL_AXIS:
            return [[(d, m) for m in range(self.devices.shape[1])]
                    for d in self.local_rows()]
        if axis == DATA_AXIS:
            return [[(d, m) for d in self.local_rows()]
                    for m in range(self.devices.shape[1])]
        raise ValueError(f"unknown mesh axis {axis!r}")

    def _dist_group(self):
        """The process group a collective over the data axis runs in.
        Raises ValueError for a world-group mesh that leaves some process
        out: its collective would wait for that process forever."""
        import torch.distributed as dist

        if self.group is None and len(self.processes) != dist.get_world_size():
            raise ValueError(
                f"a mesh over processes {self.processes} of a world of "
                f"{dist.get_world_size()} needs their process group")
        return self.group

    def _crosses(self, axis: str) -> bool:
        return axis == DATA_AXIS and self.spans_processes

    def psum(self, parts: dict, axis: str) -> dict:
        """Sum ``parts[cell]`` over ``axis``: every cell gets its group's
        sum on its own device. The sum runs in axis order on the group's
        first device (then across the mesh's processes for a data axis
        that spans them), so every cell of a group holds the same bits."""
        out = {}
        for group in self._groups(axis):
            dev0 = self.device(*group[0])
            total = parts[group[0]].to(dev0, copy=True)
            for cell in group[1:]:
                total += parts[cell].to(dev0)
            if self._crosses(axis):
                import torch.distributed as dist

                dist.all_reduce(total, op=dist.ReduceOp.SUM,
                                group=self._dist_group())
            for cell in group:
                dev = self.device(*cell)
                out[cell] = total if dev == dev0 else total.to(dev)
        return out

    def all_gather(self, parts: dict, axis: str, dim: int = 0) -> dict:
        """Concatenate ``parts[cell]`` along ``dim`` in ``axis`` order:
        every cell of a group gets the whole on its own device. Across
        processes every process must hold blocks of one shape."""
        out = {}
        for group in self._groups(axis):
            dev0 = self.device(*group[0])
            whole = torch.cat([parts[c].to(dev0) for c in group], dim=dim)
            if self._crosses(axis):
                import torch.distributed as dist

                pg = self._dist_group()
                pieces = [torch.empty_like(whole)
                          for _ in range(dist.get_world_size(pg))]
                dist.all_gather(pieces, whole.contiguous(), group=pg)
                whole = torch.cat(pieces, dim=dim)
            for cell in group:
                dev = self.device(*cell)
                out[cell] = whole if dev == dev0 else whole.to(dev)
        return out

    def _staged(self) -> bool:
        """True when the group's backend takes host tensors only for
        point-to-point and all-to-all (gloo): blocks then go through host
        memory, explicitly."""
        import torch.distributed as dist

        return dist.get_backend(self._dist_group()) == "gloo"

    def ppermute(self, parts: dict, axis: str, shift: int = 1) -> dict:
        """Rotate the blocks along ``axis``: cell ``j`` receives the block of
        cell ``j - shift`` (``jax.lax.ppermute`` with ``perm = [(j, (j +
        shift) % n)]``), on its own device. Blocks must share one shape.
        Blocks that cross processes travel by ``batch_isend_irecv``, posted
        in source-row order on both sides."""
        out = {}
        ops, landing = [], []
        n = self.devices.shape[0] if axis == DATA_AXIS else self.devices.shape[1]
        for group in self._groups(axis):
            pos = {(c[0] if axis == DATA_AXIS else c[1]): c for c in group}
            for j, cell in pos.items():
                src = (j - shift) % n
                if src in pos:
                    out[cell] = parts[pos[src]].to(self.device(*cell))
            if not self._crosses(axis):
                continue
            import torch.distributed as dist

            pg, staged = self._dist_group(), self._staged()
            m = group[0][1]
            me = self.process_index
            for s in range(n):  # source-row order, identical everywhere
                d = (s + shift) % n
                owner_s, owner_d = self.row_process[s], self.row_process[d]
                if owner_s == owner_d:
                    continue
                tag = s * self.devices.shape[1] + m
                if owner_s == me:
                    t = parts[(s, m)].contiguous()
                    ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t,
                                          owner_d, group=pg, tag=tag))
                elif owner_d == me:
                    like = parts[pos[next(iter(pos))]]
                    buf = torch.empty(like.shape, dtype=like.dtype,
                                      device="cpu" if staged else like.device)
                    ops.append(dist.P2POp(dist.irecv, buf, owner_s, group=pg,
                                          tag=tag))
                    landing.append(((d, m), buf))
        if ops:
            import torch.distributed as dist

            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for cell, buf in landing:
            out[cell] = buf.to(self.device(*cell))
        return out

    def all_to_all(self, parts: dict, axis: str, split_dim: int,
                   concat_dim: int) -> dict:
        """The tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``):
        each cell's block splits into n equal chunks along ``split_dim``;
        chunk i goes to the i-th cell of its group, which concatenates what
        it receives along ``concat_dim`` in source order. Across processes
        one ``torch.distributed.all_to_all`` per group carries, to each
        process, the chunks of this process's rows for that process's
        rows."""
        out = {}
        for group in self._groups(axis):
            n = self.shape[axis]
            chunks = {}
            for cell in group:
                blk = parts[cell]
                if blk.shape[split_dim] % n:
                    raise ValueError(
                        f"dim {split_dim} of size {blk.shape[split_dim]} does "
                        f"not split over {n} cells")
                chunks[cell] = torch.tensor_split(blk, n, dim=split_dim)
            at = (lambda c: c[0]) if axis == DATA_AXIS else (lambda c: c[1])
            local = {at(c): c for c in group}
            recv = {}  # (src position, dst position) -> chunk
            if self._crosses(axis):
                recv = self._exchange_chunks(chunks, local)
            for j, cell in local.items():
                dev = self.device(*cell)
                pieces = [chunks[local[s]][j] if s in local else recv[(s, j)]
                          for s in range(n)]
                out[cell] = torch.cat([p.to(dev) for p in pieces],
                                      dim=concat_dim)
        return out

    def _exchange_chunks(self, chunks, local) -> dict:
        """The cross-process part of ``all_to_all`` for one model column:
        -> {(source row, local destination row): chunk}. One
        ``all_to_all_single`` over flat buffers, split per process (the
        processes may hold different numbers of rows)."""
        import torch.distributed as dist

        pg, staged = self._dist_group(), self._staged()
        mine = sorted(local)
        like = chunks[local[mine[0]]][0]
        dev = "cpu" if staged else like.device
        rows = {p: [d for d, q in enumerate(self.row_process) if q == p]
                for p in self.processes}
        me = self.process_index
        send = [chunks[local[s]][d].reshape(-1)
                for p in self.processes if p != me
                for s in mine for d in rows[p]]
        out_sizes = [0 if p == me else len(rows[p]) * len(mine) * like.numel()
                     for p in self.processes]
        in_sizes = list(out_sizes)
        flat = (torch.cat(send) if send else like.new_empty(0)).to(dev)
        recv_flat = torch.empty(sum(out_sizes), dtype=like.dtype, device=dev)
        dist.all_to_all_single(recv_flat, flat, out_sizes, in_sizes, group=pg)
        recv, at = {}, 0
        for p in self.processes:
            if p == me:
                continue
            for s in rows[p]:
                for d in mine:
                    recv[(s, d)] = recv_flat[at:at + like.numel()].view(like.shape)
                    at += like.numel()
        return recv


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """A mesh of ``spec``'s shape over the first data x model entries of
    ``devices`` (default: this process's devices, ``shardspec.local_devices``).
    Entries may repeat."""
    from oryx_tpu_torch.parallel.shardspec import local_devices

    devices = list(local_devices() if devices is None else devices)
    spec = spec or MeshSpec()
    data, model = spec.resolve(len(devices))
    grid = np.empty((data, model), dtype=object)
    for j in range(data * model):
        grid[j // model, j % model] = torch.device(devices[j])
    return Mesh(grid)


def _cycled(n: int, device) -> list[torch.device]:
    from oryx_tpu_torch.parallel.shardspec import local_devices, shard_devices

    devs = local_devices() if device is None else [torch.device(device)]
    return shard_devices(n, devs)


def host_mesh(n: int | None = None, device=None) -> Mesh:
    """Flat data-parallel mesh of n cells (default: one per local device)
    over this process's devices, cycled (``device`` names one device for
    every cell: ``host_mesh(8, "cpu")`` is the JAX tests' eight virtual
    CPU devices)."""
    from oryx_tpu_torch.parallel.shardspec import local_devices

    n = n or len(local_devices(device))
    return make_mesh(MeshSpec(data=n, model=1), _cycled(n, device))


def model_mesh(n: int | None = None, device=None) -> Mesh:
    """Mesh whose MODEL axis has n cells (default: one per local device):
    the layout the row-sharded factor table of ``train_als(shard_mesh=)``
    shards over."""
    from oryx_tpu_torch.parallel.shardspec import local_devices

    n = n or len(local_devices(device))
    return make_mesh(MeshSpec(data=1, model=n), _cycled(n, device))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class MeshArray:
    """An array laid out on a mesh: ``shards[cell]`` is local cell
    (d, m)'s block. ``axis`` names the mesh axis that dim ``dim`` (the
    leading one by default) is split over ("data" or "model"; its blocks
    are equal), or None when every cell holds the whole array."""

    __slots__ = ("mesh", "shards", "axis", "shape", "dim")

    def __init__(self, mesh: Mesh, shards: dict, axis: str | None, shape,
                 dim: int = 0):
        self.mesh = mesh
        self.shards = shards
        self.axis = axis
        self.shape = tuple(shape)
        self.dim = dim

    def block(self, d: int, m: int):
        return self.shards[(d, m)]

    def full(self) -> torch.Tensor:
        """The whole array on the host (every process's blocks)."""
        if self.axis is None:
            return next(iter(self.shards.values())).cpu()
        parts = self.mesh.all_gather(self.shards, self.axis, dim=self.dim)
        return next(iter(parts.values())).cpu()

    def __array__(self, dtype=None, copy=None):
        a = self.full().numpy()
        return a if dtype is None else a.astype(dtype)


def split_rows(x: torch.Tensor, mesh: Mesh, axis: str | None) -> MeshArray:
    """Lay ``x`` (whole, on the host or any device) out on ``mesh``: row
    blocks over ``axis`` (the row count must divide by the axis size), or
    the whole array in every cell for axis None. Each block is copied
    once to each device its cells use, and those cells share the copy:
    treat the blocks as read-only."""
    if axis is not None and x.shape[0] % mesh.shape[axis]:
        raise ValueError(
            f"{x.shape[0]} rows do not split over {mesh.shape[axis]} cells")
    step = 0 if axis is None else x.shape[0] // mesh.shape[axis]
    shards, copies = {}, {}
    for d, m in mesh.cells():
        j = 0 if axis is None else d if axis == DATA_AXIS else m
        key = (j, mesh.device(d, m))
        if key not in copies:
            block = x if axis is None else x[j * step:(j + 1) * step]
            copies[key] = block.to(key[1], copy=True)
        shards[(d, m)] = copies[key]
    return MeshArray(mesh, shards, axis, x.shape)


def shard_array(x, mesh: Mesh, leading: bool = True) -> MeshArray:
    """Place an array on the mesh, sharding the leading dim over "data"
    (padding it with zero rows to a multiple of the axis size), or fully
    replicated (``leading=False``, or a scalar)."""
    t = torch.as_tensor(np.asarray(x))
    if not leading or t.ndim == 0:
        return split_rows(t, mesh, None)
    n = mesh.shape[DATA_AXIS]
    rem = t.shape[0] % n
    if rem:
        t = torch.cat([t, t.new_zeros((n - rem, *t.shape[1:]))])
    return split_rows(t, mesh, DATA_AXIS)
