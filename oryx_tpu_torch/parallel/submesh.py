"""Sub-mesh partitioning for parallel hyperparameter candidates (the
port's counterpart of oryx_tpu/parallel/submesh.py).

The reference builds and evaluates model candidates concurrently on the
Spark cluster (framework/oryx-ml .../ml/MLUpdate.java:253-258,
ExecUtils.collectInParallel with oryx.ml.eval.parallelism). Threading the
builds over ONE mesh would only make them contend, and on a multi-process
pod two candidates' collectives would interleave in thread-scheduling
order and wedge the group. So the mesh is PARTITIONED along its data axis
into disjoint sub-meshes, one candidate per sub-mesh: each candidate's
collectives run entirely inside its own rows (and, across processes,
inside its own ``torch.distributed`` process group).

The active sub-mesh travels to the app's trainer through a thread-local
(the build threads of ml/update.py each enter ``candidate_mesh``); apps
resolve it via ``MLUpdate._build_mesh()`` at build time.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from oryx_tpu_torch.parallel.mesh import Mesh

_TLS = threading.local()
_GROUPS: dict[tuple[int, ...], object] = {}  # ranks -> process group
_GROUPS_LOCK = threading.Lock()


def current_candidate_mesh() -> Mesh | None:
    """The sub-mesh assigned to the candidate building on THIS thread, or
    None outside a partitioned build."""
    return getattr(_TLS, "mesh", None)


@contextmanager
def candidate_mesh(mesh: Mesh | None):
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield
    finally:
        _TLS.mesh = prev


def process_groups(process_ids: list[int], k: int) -> list[list[int]]:
    """Partition an ordered unit list into min(k, len) contiguous groups.

    THE partitioning contract of the project — processes here, mesh data
    rows in partition_mesh, factor-matrix rows in
    parallel/shardspec.RowShards — one implementation so no two layers
    can ever disagree about how an ordered axis splits:

    - groups are contiguous runs of the input, in input order;
    - sizes are as equal as possible, with the LARGER groups first
      (divmod remainder distributed to the leading groups);
    - k clamps to [1, len(process_ids)]: asking for more groups than
      units returns one unit per group, never empty groups — callers
      must read the EFFECTIVE parallelism from len(result), not from
      the k they asked for.

    Deterministic: every pod member computes the identical partition
    from (process list, k)."""
    k = max(1, min(k, len(process_ids)))
    base, extra = divmod(len(process_ids), k)
    groups: list[list[int]] = []
    at = 0
    for g in range(k):
        n = base + (1 if g < extra else 0)
        groups.append(process_ids[at : at + n])
        at += n
    return groups


def process_group(ranks: list[int]):
    """The ``torch.distributed`` group of ``ranks``, made once per process
    and then reused. ``new_group`` is collective over the WHOLE world:
    every process must ask for every group, in the same order, members or
    not, or the pod hangs at the next group call."""
    import torch.distributed as dist

    key = tuple(int(r) for r in ranks)
    with _GROUPS_LOCK:
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(ranks=list(key))
        return _GROUPS[key]


def forget_process_groups() -> None:
    """Drop the cached groups (they die with the process group)."""
    with _GROUPS_LOCK:
        _GROUPS.clear()


def pod_group_submesh(mesh: Mesh, k: int) -> tuple[int, list[list[int]], Mesh] | None:
    """Carve the pod-wide mesh into per-process-GROUP sub-meshes for the
    multi-process parallel candidate search (reference MLUpdate.java:
    253-258 parallelizes candidates across the Spark cluster; here each
    candidate trains on a disjoint slice of the pod). Data rows are grouped
    by the process that holds them (``Mesh.row_process``; the global mesh
    is host-major along data, parallel/distributed.py global_mesh),
    processes are split into contiguous groups, and THIS process gets
    (group_index, groups, its group's sub-mesh) — groups[g][0] is group
    g's leader, whose score row and winner artifact the gather/broadcast
    steps read. The sub-mesh carries its group's process group, so the
    collectives of a candidate build touch only the group's processes.

    Returns None when the mesh cannot be partitioned by process: one
    process, a mesh whose processes are not the whole world, or rows that
    are not host-major. Every None comes from pod-global inputs, so the
    whole pod always takes the SAME path; callers then run the serial
    lockstep search. Every process makes every group's process group, in
    group order (``process_group``)."""
    from oryx_tpu_torch.parallel.distributed import process_count, process_index

    if process_count() <= 1:
        return None
    row_owner = list(mesh.row_process)
    procs = sorted(set(row_owner))
    if len(procs) <= 1:
        return None
    if procs != list(range(process_count())):
        # a training mesh that leaves some process out would send that
        # member down the serial fallback while the others partition:
        # divergent control flow that wedges the pod's collectives
        return None
    if row_owner != sorted(row_owner):
        # rows not host-major: process groups would not be contiguous row
        # runs, so this and partition_mesh would carve different slices
        return None
    groups = process_groups(procs, k)
    if len(groups) <= 1:
        return None
    pgs = [process_group(ps) for ps in groups]
    me = process_index()
    my_group = next(g for g, ps in enumerate(groups) if me in ps)
    rows = [r for r, p in enumerate(row_owner) if p in groups[my_group]]
    return my_group, groups, mesh.select_rows(rows, group=pgs[my_group])


def partition_mesh(mesh: Mesh, k: int) -> list[Mesh]:
    """Split a (data, model) mesh inside one process into up to k disjoint
    sub-meshes along the data axis (the process_groups contract: contiguous
    slices in row order, sizes as equal as possible with larger slices
    first, k clamped to the row count; the model axis is kept whole inside
    every sub-mesh — tensor-parallel candidates stay tensor-parallel).
    Callers read the effective parallelism from the RESULT length; a 1-row
    data axis returns the whole mesh. A mesh across processes is carved by
    ``pod_group_submesh`` instead (ValueError here)."""
    if mesh.spans_processes:
        raise ValueError("partition_mesh: the mesh spans processes; "
                         "use pod_group_submesh")
    if k <= 1:
        return [mesh]
    row_groups = process_groups(list(range(mesh.devices.shape[0])), k)
    if len(row_groups) <= 1:
        return [mesh]
    return [mesh.select_rows(rows) for rows in row_groups]
