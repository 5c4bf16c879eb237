"""Sequence-parallel attention over the device mesh: ring and all-to-all
(the port of oryx_tpu/ops/attention.py).

The reference has no sequence models; long-context support is a
capability of this framework. Two schedules, both sharding the sequence
over the mesh "data" axis:

- ``ring_attention``: each cell keeps its Q shard and the K/V shards move
  around the ring one ``Mesh.ppermute`` step at a time (neighbour
  exchanges, never a full all-gather), folded in with online-softmax
  (flash-attention) rescaling: the full [S, S] score matrix never exists
  and K/V memory per cell stays S/n. Best when S is the scarce resource
  and heads are few.
- ``ulysses_attention`` (DeepSpeed-Ulysses style): one tiled
  ``Mesh.all_to_all`` swaps the sharded axis from sequence to heads (each
  cell then holds H/n full-sequence heads), attention runs locally and
  exactly, and a second all-to-all swaps back. Two collectives instead of
  n ring steps: cheaper when H >= n and per-head attention fits a device.

``attention`` is the exact single-device version both are held to; all
three support causal masking (the ring masks by global chunk position).
Products are ``torch.matmul`` in f32 with TF32 off (``full_f32``) and the
softmax runs in f32, as the JAX package's XLA einsums do: no Pallas kernel
is involved there, so none is a hand kernel here. Inputs are [..., S, D]
tensors or arrays (Ulysses: [..., H, S, D]), whole, or MeshArrays already
split over "data" along the sequence dim; outputs keep the sequence
sharding: a ``MeshArray`` whose blocks are the cells' sequence shards
(``.full()`` gives the whole). Leading batch and head dims broadcast.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from oryx_tpu_torch.ops.vector import full_f32
from oryx_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, MeshArray

_NEG_INF = -1e30


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Exact softmax attention. q,k,v: [..., S, D] -> [..., S, D] in q's
    dtype, on q's device. The causal mask is ``tril(k = sk - sq)``."""
    q, k, v = _tensor(q), _tensor(k), _tensor(v)
    with full_f32():
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill_(~keep, _NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    del s
    with full_f32():
        return torch.matmul(p, v.float()).to(q.dtype)


def _block_fold(q, k, v, m_prev, l_prev, o_prev, bias):
    """Fold one K/V block into the running online-softmax state.
    q: [..., Sq, D], k/v: [..., Sk, D]; m/l: [..., Sq], o: [..., Sq, D];
    bias: [Sq, Sk] or None (no mask)."""
    with full_f32():
        s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    scale = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    del s
    l_new = l_prev * scale + p.sum(dim=-1)
    with full_f32():
        o_new = o_prev * scale[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def _seq_shards(x, mesh: Mesh, name: str) -> dict:
    """The local cells' sequence shards of ``x`` (dim -2 split over
    "data"): a MeshArray's own blocks, or slices of a whole array, copied
    once to each device its cells use (read-only)."""
    if isinstance(x, MeshArray):
        if x.mesh is not mesh or x.axis != DATA_AXIS or x.dim != len(x.shape) - 2:
            raise ValueError(f"{name} is not split over this mesh's "
                             f"'{DATA_AXIS}' axis along its sequence dim")
        return x.shards
    t = _tensor(x)
    n = mesh.shape[DATA_AXIS]
    step = t.shape[-2] // n
    out, copies = {}, {}
    for d, m in mesh.cells():
        key = (d, mesh.device(d, m))
        if key not in copies:
            copies[key] = t.narrow(-2, d * step, step).to(key[1])
        out[(d, m)] = copies[key]
    return out


def _shape(x) -> tuple:
    return tuple(x.shape)


def ring_attention(q, k, v, mesh: Mesh, *, causal: bool = False) -> MeshArray:
    """Sequence-parallel attention: [..., S, D] inputs with S split over
    the mesh "data" axis (n cells). Each cell keeps its Q shard; the K/V
    shards move n - 1 ``ppermute`` steps around the ring, so every cell
    folds every shard, its own first. Under ``causal`` the mask goes by
    global chunk position: the cell's own chunk is triangular, earlier
    chunks are open, and a chunk wholly above the diagonal is not folded
    (folding it would add exp(-1e30 - m) = 0 and scale by exp(0) = 1,
    leaving the state bit for bit as it was). Returns [..., S, D] as a
    MeshArray split like q."""
    n = mesh.shape[DATA_AXIS]
    if _shape(q)[-2] % n or _shape(k)[-2] % n:
        raise ValueError(
            f"sequence length {_shape(q)[-2]} must be divisible by the {n}-way "
            f"'{DATA_AXIS}' axis"
        )
    qs, ks, vs = (_seq_shards(x, mesh, nm) for x, nm in ((q, "q"), (k, "k"), (v, "v")))
    cells = mesh.cells()
    state = {}
    for c in cells:
        lead = qs[c].shape[:-1]
        dev = qs[c].device
        state[c] = (
            torch.full(lead, _NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros(lead, dtype=torch.float32, device=dev),
            torch.zeros((*lead, qs[c].shape[-1]), dtype=torch.float32, device=dev),
        )
    k_cur, v_cur = ks, vs
    for i in range(n):
        for c in cells:
            my = c[0]
            src = (my - i) % n  # which global chunk this K/V block is
            bias = None
            if causal:
                if src > my:
                    continue  # wholly masked
                if src == my:
                    sq, sk = qs[c].shape[-2], k_cur[c].shape[-2]
                    tri = torch.ones((sq, sk), dtype=torch.bool,
                                     device=qs[c].device).tril()
                    bias = torch.zeros((sq, sk), dtype=torch.float32,
                                       device=qs[c].device).masked_fill_(~tri, _NEG_INF)
            state[c] = _block_fold(qs[c], k_cur[c], v_cur[c], *state[c], bias)
        if i < n - 1:
            k_cur = mesh.ppermute(k_cur, DATA_AXIS, 1)
            v_cur = mesh.ppermute(v_cur, DATA_AXIS, 1)
    out = {c: (o / torch.clamp(l, min=1e-30)[..., None]).to(qs[c].dtype)
           for c, (_, l, o) in state.items()}
    return MeshArray(mesh, out, DATA_AXIS, _shape(q), dim=len(_shape(q)) - 2)


def ulysses_attention(q, k, v, mesh: Mesh, *, causal: bool = False) -> MeshArray:
    """All-to-all sequence-parallel attention: [..., H, S, D] inputs with S
    split over the mesh "data" axis and H divisible by the axis size. Two
    tiled all-to-alls re-split sequence -> heads and back; attention itself
    runs locally and EXACTLY per head. Returns [..., H, S, D] as a
    MeshArray split like q."""
    n = mesh.shape[DATA_AXIS]
    if len(_shape(q)) < 3:
        raise ValueError("ulysses_attention needs [..., H, S, D] inputs")
    # validate q AND k (cross-attention may use a different S_k; mismatched
    # head counts are not supported by the all-to-all re-split)
    if _shape(k)[-3] != _shape(q)[-3]:
        raise ValueError(
            f"k head count {_shape(k)[-3]} must equal q's {_shape(q)[-3]}"
        )
    for name, arr in (("q", q), ("k", k)):
        h, s = _shape(arr)[-3], _shape(arr)[-2]
        if h % n:
            raise ValueError(
                f"{name} head count {h} must be divisible by the {n}-way "
                f"'{DATA_AXIS}' axis (use ring_attention when heads are scarce)"
            )
        if s % n:
            raise ValueError(
                f"{name} sequence length {s} must be divisible by the {n}-way "
                f"'{DATA_AXIS}' axis"
            )
    ndim = len(_shape(q))
    h_ax, s_ax = ndim - 3, ndim - 2
    # sequence-split -> head-split: [..., H, S/n, D] -> [..., H/n, S, D]
    qh, kh, vh = (
        mesh.all_to_all(_seq_shards(x, mesh, nm), DATA_AXIS, h_ax, s_ax)
        for x, nm in ((q, "q"), (k, "k"), (v, "v"))
    )
    o = {c: attention(qh[c], kh[c], vh[c], causal=causal) for c in mesh.cells()}
    del qh, kh, vh
    # head-split -> sequence-split
    out = mesh.all_to_all(o, DATA_AXIS, s_ax, h_ax)
    return MeshArray(mesh, out, DATA_AXIS, _shape(q), dim=s_ax)
