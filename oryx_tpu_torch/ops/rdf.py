"""Random decision forest on the card: histogram growth and device routing
(the port of oryx_tpu/ops/rdf.py).

The JAX package grows one tree as a ``lax.scan`` over depth levels and
vmaps it over trees; none of it is a Pallas kernel, so here it is one
Python loop over levels with an explicit tree axis ``[T, ...]`` of torch ops
on one device. The dense array forest, the implicit-heap layout (node i's
children at 2i+1, the '-' branch, and 2i+2, '+'), the binning and the node
IDs are the JAX package's, copied bit-identical; see its module docstring
for the design.

Each level:

- **The label histogram** ``[T, nodes, P, B, C]`` is one ``index_add_`` per
  tree into the flattened histogram. The flat index is int32: its
  per-example part (predictor, bin and, for classification, the class, as
  the stat columns are one-hot) is built once per forest, and a level only
  adds the node offset. A [T,N,P] int64 index at covertype (10 x 523k x 54)
  would be 2.3 GB, once per stat column. Classification adds integer
  bootstrap counts into integer-valued f32 cells below 2^24, so the sums
  are exact in any order, atomics included: given the same bootstrap
  weights and every feature at every node, the trees equal the JAX
  package's. Regression adds float (w, wy, wy^2) and its sums vary in order
  on the card.
- Only the level's own nodes are held (the JAX package pads every level to
  the last level's node count to compile one scan body).
- Bin order (categorical bins by per-bin target score, a stable sort as
  ``jnp.argsort``), cumulative left/right sums, the impurity gain, the
  per-node feature subset (uniform draws from a ``torch.Generator``; its
  seed is the integer the JAX package keys ``jax.random`` with, and the
  streams differ), the first maximum over P x B (``torch.argmax``, as
  ``jnp.argmax``), the split mask and the routing of examples to children.

``grow_forest(mesh=)`` splits the tree axis over the mesh's "data" axis
when the tree count divides it (the JAX package's sharded vmap): each cell
grows its trees from the per-tree weights and feature-subset draws one
device would use, so the forest is the single-device one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.device import resolve_device

MAX_BINS_CAP = 256


# ---------------------------------------------------------------------------
# node-ID strings (wire parity with the reference's TreePath IDs:
# root "r", '-' = left child, '+' = right child; RDFUpdate.java:423,480-481)
# ---------------------------------------------------------------------------

def heap_to_node_id(index: int) -> str:
    """Heap slot -> reference-style path ID ("r", "r-", "r+-", ...)."""
    path = []
    i = index
    while i > 0:
        parent = (i - 1) // 2
        path.append("-" if i == 2 * parent + 1 else "+")
        i = parent
    return "r" + "".join(reversed(path))


def node_id_to_heap(node_id: str) -> int:
    """Reference-style path ID -> heap slot."""
    if not node_id or node_id[0] != "r":
        raise ValueError(f"bad node ID: {node_id!r}")
    i = 0
    for c in node_id[1:]:
        if c == "-":
            i = 2 * i + 1
        elif c == "+":
            i = 2 * i + 2
        else:
            raise ValueError(f"bad node ID: {node_id!r}")
    return i


# ---------------------------------------------------------------------------
# binning (host numpy, bit-identical to the JAX package)
# ---------------------------------------------------------------------------

@dataclass
class BinnedData:
    """Quantile-binned dataset + the edges needed to bin future inputs.

    edges[p] has n_bins[p]-1 sorted cut points for numeric predictor p
    (bin b covers x <= edges[b], last bin is the overflow; NaN bins to the
    last bin); categorical predictors bin by value encoding directly.
    """

    binned: np.ndarray  # [N, P] int32
    edges: list[np.ndarray | None]  # per predictor; None for categorical
    n_bins: np.ndarray  # [P] int32
    is_categorical: np.ndarray  # [P] bool


def bin_column(
    values: np.ndarray, edges: np.ndarray | None, n_bins: int
) -> np.ndarray:
    """Bin one predictor column; NaN and unseen categories go to the last
    bin (searchsorted sends NaN past every edge)."""
    if edges is None:  # categorical: values are already encodings
        v = np.nan_to_num(values, nan=n_bins - 1).astype(np.int64)
        return np.clip(v, 0, n_bins - 1).astype(np.int32)
    return np.searchsorted(edges, values, side="left").astype(np.int32)


def bin_dataset(
    x: np.ndarray,
    is_categorical: np.ndarray,
    category_counts: np.ndarray,
    max_split_candidates: int,
) -> BinnedData:
    """Quantile-bin numeric columns of x [N,P] (categoricals pass through
    as encodings). max_split_candidates caps bins per predictor, like its
    namesake in RDFUpdate.java:121-151."""
    n, p = x.shape
    max_bins = min(int(max_split_candidates), MAX_BINS_CAP)
    binned = np.empty((n, p), dtype=np.int32)
    edges: list[np.ndarray | None] = []
    n_bins = np.empty(p, dtype=np.int32)
    for j in range(p):
        col = x[:, j]
        if is_categorical[j]:
            nb = max(int(category_counts[j]), 1)
            edges.append(None)
            n_bins[j] = nb
            binned[:, j] = bin_column(col, None, nb)
        else:
            finite = col[np.isfinite(col)]
            if len(finite) == 0:
                e = np.empty(0, dtype=np.float32)
            else:
                qs = np.quantile(finite, np.linspace(0, 1, max_bins + 1)[1:-1])
                e = np.unique(qs.astype(np.float32))
            edges.append(e)
            n_bins[j] = len(e) + 1
            binned[:, j] = bin_column(col, e, len(e) + 1)
    return BinnedData(binned, edges, n_bins, np.asarray(is_categorical, dtype=bool))


# ---------------------------------------------------------------------------
# forest container
# ---------------------------------------------------------------------------

@dataclass
class Forest:
    """Dense array forest; T trees x M=2^(max_depth+1)-1 heap slots.

    feature[t,m] is the split predictor (-1 = terminal/absent);
    split_left[t,m,b] says bin b of that predictor goes left. For
    classification class_counts[t,m,:] holds per-class training counts at
    every node (terminal prediction = normalized counts, the reference's
    CategoricalPrediction); for regression leaf_stats[t,m] = (count, sum)
    (NumericPrediction's running mean).
    """

    feature: np.ndarray  # [T, M] int32
    split_left: np.ndarray  # [T, M, B] bool
    class_counts: np.ndarray | None  # [T, M, C] f64, classification
    leaf_stats: np.ndarray | None  # [T, M, 2] f64 (count, sum), regression
    feature_importances: np.ndarray  # [P] f64, max-normalized
    max_depth: int

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def is_classification(self) -> bool:
        return self.class_counts is not None


# ---------------------------------------------------------------------------
# growth
# ---------------------------------------------------------------------------

def _impurity(counts: torch.Tensor, kind: str) -> torch.Tensor:
    """Impurity from class-count vectors [..., C]; nats for entropy."""
    n = counts.sum(dim=-1)
    p = counts / torch.clamp(n, min=1.0)[..., None]
    if kind == "gini":
        return 1.0 - (p * p).sum(dim=-1)
    return -torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)).sum(dim=-1)


def _variance(s: torch.Tensor) -> torch.Tensor:
    """Weighted variance from (w, wy, wy^2) stat vectors [..., 3]."""
    n = torch.clamp(s[..., 0], min=1.0)
    mean = s[..., 1] / n
    return torch.clamp(s[..., 2] / n - mean * mean, min=0.0)


def resolve_mtry(
    strategy: str | int | None,
    p: int,
    classification: bool,
    num_trees: int | None = None,
) -> int:
    """featureSubsetStrategy -> per-node feature count, MLlib semantics
    (the reference's RDFUpdate.java:143-165 passes the same strategy
    names to RandomForest): "auto" = "all" for a single tree, else
    sqrt(P) for classification / ceil(P/3) for regression; "all",
    "sqrt", "log2", "onethird" = ceil(P/3), or an explicit integer.
    num_trees=None (unknown) treats the forest as multi-tree."""
    onethird = max(1, -(-p // 3))  # ceil(p/3), matching MLlib
    if strategy is None or strategy == "auto":
        # MLlib: a single tree has no inter-tree decorrelation to buy
        # with feature subsampling, so "auto" degrades to "all"
        if num_trees == 1:
            return p
        return max(1, int(math.sqrt(p))) if classification else onethird
    if isinstance(strategy, int) or str(strategy).lstrip("-").isdigit():
        v = int(strategy)
        if not 1 <= v <= p:
            raise ValueError(f"feature-subset {v} outside [1, {p}]")
        return v
    named = {
        "all": p,
        "sqrt": max(1, int(math.sqrt(p))),
        "log2": max(1, int(math.log2(p))),
        "onethird": onethird,
    }
    if strategy not in named:
        raise ValueError(f"unknown feature-subset strategy {strategy!r}")
    return named[strategy]


def _grow_trees(
    binned: torch.Tensor,  # [N, P] int32
    y: torch.Tensor,  # [N] int64 (classification) or f32 (regression)
    weight: torch.Tensor,  # [T, N] f32 bootstrap multinomial counts
    n_bins: torch.Tensor,  # [P] int64
    is_cat: torch.Tensor,  # [P] bool
    gen: torch.Generator,
    *,
    max_depth: int,
    n_bins_max: int,
    n_classes: int,  # 0 => regression
    impurity: str,
    mtry: int,
    trees: tuple[int, int] | None = None,
):
    """All T trees level by level -> (feature [T,M] int32, split_left
    [T,M,B] bool, node stats [T,M,C] f32, importance [T,P] f32).
    ``trees = (first, total)`` grows trees [first, first + T) of a forest
    of ``total``: ``gen`` then draws every tree's feature subsets, and
    these trees take their own rows, so they come out as in the whole
    forest."""
    dev = binned.device
    n, p = binned.shape
    t = weight.shape[0]
    first, n_trees = trees if trees is not None else (0, t)
    b = n_bins_max
    m = 2 ** (max_depth + 1) - 1
    classification = n_classes > 0
    c = n_classes if classification else 3  # regression stats: (w, wy, wy2)
    pbc = p * b * c

    feature = torch.full((t, m), -1, dtype=torch.int32, device=dev)
    split_left = torch.zeros((t, m, b), dtype=torch.bool, device=dev)
    node_counts = torch.zeros((t, m, c), dtype=torch.float32, device=dev)
    importance = torch.zeros((t, p), dtype=torch.float32, device=dev)

    # the per-example part of the flat histogram index, built once:
    # (predictor, bin, class) for classification (one-hot stat columns
    # fold into the index), (predictor, bin) * C for regression
    cols = torch.arange(p, dtype=torch.int32, device=dev)[None, :]
    base = (cols * b + binned) * c  # [N, P] int32
    if classification:
        # a label outside [0, C) has an all-zero one-hot row in the JAX
        # package: it adds nothing anywhere
        in_range = (y >= 0) & (y < c)
        weight = weight * in_range[None, :]
        y = torch.where(in_range, y, torch.zeros_like(y))
        base = base + y.to(torch.int32)[:, None]
        stat_cols = None
    else:
        stat_cols = torch.stack([torch.ones_like(y), y, y * y], dim=1)  # [N, 3]
    base = base.reshape(-1)

    arange_b = torch.arange(b, device=dev)
    valid_bin = arange_b[None, :] < n_bins[:, None]  # [P, B]
    # split position j is valid only below the last in-use bin
    valid_pos = arange_b[None, :] < (n_bins[:, None] - 1)  # [P, B]
    tree_ix = torch.arange(t, device=dev)[:, None]
    ex_ix = torch.arange(n, device=dev)[None, :]
    binned_flat = binned.reshape(-1)

    node = torch.zeros((t, n), dtype=torch.int64, device=dev)
    for depth in range(max_depth):
        level_start, n_level = 2**depth - 1, 2**depth
        local = node - level_start
        active = (local >= 0) & (local < n_level)
        w = torch.where(active, weight, torch.zeros_like(weight))  # [T, N]
        loc = torch.clamp(local, 0, n_level - 1)

        # label histogram [T, n_level, P, B, C], one flat index_add_ per
        # tree (and per stat column for regression)
        hist = torch.zeros(t * n_level * pbc, dtype=torch.float32, device=dev)
        for ti in range(t):
            off = ((ti * n_level + loc[ti]) * pbc).to(torch.int32)  # [N]
            idx = (base.view(n, p) + off[:, None]).reshape(-1)
            if classification:
                hist.index_add_(0, idx, w[ti][:, None].expand(n, p).reshape(-1))
            else:
                for s in range(c):
                    v = (w[ti] * stat_cols[:, s])[:, None].expand(n, p).reshape(-1)
                    hist.index_add_(0, idx + s, v)
        hist = hist.view(t, n_level, p, b, c)

        total = hist.sum(dim=3)  # [T, n_level, P, C]
        # every predictor's histogram sums to the same node totals, so
        # predictor 0's are the node's stats, exactly
        node_stats = total[:, :, 0]  # [T, n_level, C]
        node_n = node_stats.sum(dim=-1)  # [T, n_level]

        # order bins: numeric keep natural order; categorical sort by the
        # per-bin target score (sorted-category subset trick)
        if classification:
            bin_n = hist.sum(dim=4)  # [T, n_level, P, B]
            maj = torch.argmax(total.sum(dim=2), dim=-1)  # [T, n_level]
            maj_n = torch.gather(
                hist, 4, maj[:, :, None, None, None].expand(t, n_level, p, b, 1)
            )[..., 0]
            score = maj_n / torch.clamp(bin_n, min=1.0)
        else:
            bin_n = hist[..., 0]
            score = hist[..., 1] / torch.clamp(bin_n, min=1.0)  # mean y
        # empty/padded bins sort last
        score = torch.where((bin_n > 0) & valid_bin, score,
                            torch.full_like(score, float("inf")))
        cat_order = torch.sort(score, dim=3, stable=True).indices
        nat_order = arange_b.expand_as(cat_order)
        order = torch.where(is_cat[None, None, :, None], cat_order, nat_order)

        ordered = torch.gather(hist, 3, order[..., None].expand(t, n_level, p, b, c))
        left = torch.cumsum(ordered, dim=3)  # [T, n_level, P, B, C]
        right = left[:, :, :, -1:, :] - left
        del ordered

        if classification:
            nl, nr = left.sum(dim=4), right.sum(dim=4)
            h_parent = _impurity(total, impurity)  # [T, n_level, P]
            h_l, h_r = _impurity(left, impurity), _impurity(right, impurity)
        else:
            nl, nr = left[..., 0], right[..., 0]
            h_parent = _variance(total)
            h_l, h_r = _variance(left), _variance(right)
        del left, right

        nn = torch.clamp(node_n, min=1.0)[:, :, None, None]
        gain = h_parent[..., None] - (nl / nn) * h_l - (nr / nn) * h_r
        ok = (nl > 0) & (nr > 0) & valid_pos
        # per-node "auto" feature subset: keep mtry features with the
        # smallest uniform draws (MLlib featureSubsetStrategy="auto")
        if mtry < p:
            u = torch.rand((n_trees, n_level, p), generator=gen,
                           device=gen.device)[first:first + t].to(dev)
            ranks = torch.argsort(torch.argsort(u, dim=2), dim=2)
            ok = ok & (ranks < mtry)[..., None]
        gain = torch.where(ok, gain, torch.full_like(gain, float("-inf")))

        flat = gain.reshape(t, n_level, p * b)
        best = torch.argmax(flat, dim=2)  # [T, n_level]
        best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
        best_p = best // b
        best_j = best % b
        should = (best_gain > 0.0) & (node_n >= 2.0) & torch.isfinite(best_gain)

        # goes-left mask over original bins: rank of bin in the chosen
        # predictor's order <= best_j (order is a permutation per row)
        order_best = torch.gather(
            order, 2, best_p[:, :, None, None].expand(t, n_level, 1, b))[:, :, 0]
        inv_best = torch.empty_like(order_best).scatter_(
            2, order_best, arange_b.expand_as(order_best))  # [T, n_level, B]
        left_mask = (inv_best <= best_j[..., None]) & should[..., None]

        slots = slice(level_start, level_start + n_level)
        feature[:, slots] = torch.where(
            should, best_p, torch.full_like(best_p, -1)).to(torch.int32)
        split_left[:, slots] = left_mask
        node_counts[:, slots] = node_stats
        importance.scatter_add_(
            1, best_p, torch.where(should, node_n, torch.zeros_like(node_n)))

        # route: split nodes push actives down, others freeze (terminal)
        bp = torch.gather(best_p, 1, loc)  # [T, N]
        ex_bin = binned_flat[ex_ix * p + bp]
        goes_left = left_mask.reshape(-1)[(tree_ix * n_level + loc) * b + ex_bin]
        child = 2 * node + 1 + (~goes_left).to(torch.int64)
        node = torch.where(active & torch.gather(should, 1, loc), child, node)

    # leaf-level stats for every node examples ended on
    final = torch.zeros(t * m * c, dtype=torch.float32, device=dev)
    slot = (tree_ix * m + node) * c  # [T, N]
    if classification:
        final.index_add_(0, (slot + y[None, :]).reshape(-1), weight.reshape(-1))
    else:
        for s in range(c):
            final.index_add_(0, (slot + s).reshape(-1),
                             (weight * stat_cols[:, s][None, :]).reshape(-1))
    final = final.view(t, m, c)
    # internal nodes keep their totals (prediction fallback parity with the
    # reference, where every PMML node records counts)
    node_counts = torch.where(final.sum(dim=2, keepdim=True) > 0, final, node_counts)
    return feature, split_left, node_counts, importance


def grow_forest(
    data: BinnedData,
    y: np.ndarray,
    *,
    num_trees: int,
    max_depth: int,
    impurity: str,
    n_classes: int,
    feature_subset: str | int | None = "auto",
    mesh=None,
    device=None,
) -> Forest:
    """Train the forest on ``device`` (the card unless the caller names the
    CPU): multinomial bootstrap weights per tree from RandomManager (the
    JAX package's stream), then every tree level by level.

    With a ``mesh`` whose "data" axis divides ``num_trees``, data row d
    grows its share of the trees on its first cell's device (``device``
    is not used) and the rows' trees are gathered over "data"; each cell
    draws from a generator of the same seed, so the forest equals the
    single-device one. A tree count the axis does not divide grows whole
    on the mesh's first cell (phantom trees would join the vote)."""
    dev = (mesh.device(*mesh.cells()[0]) if mesh is not None
           else resolve_device(device))
    n, p = data.binned.shape
    rng = RandomManager.get_random()
    weights = rng.multinomial(n, np.full(n, 1.0 / n), size=num_trees).astype(
        np.float32
    )  # [T, N]
    seed = int(rng.integers(2**31 - 1))
    classification = n_classes > 0
    mtry = resolve_mtry(feature_subset, p, classification, num_trees=num_trees)
    if classification:
        yy = torch.from_numpy(np.nan_to_num(y, nan=0.0).astype(np.int64))
    else:
        yy = torch.from_numpy(np.asarray(y, dtype=np.float32))
    binned = torch.from_numpy(np.ascontiguousarray(data.binned, dtype=np.int32))
    n_bins = torch.from_numpy(data.n_bins.astype(np.int64))
    is_cat = torch.from_numpy(np.asarray(data.is_categorical, dtype=bool))

    def grow(on: torch.device, lo: int, hi: int):
        gen = torch.Generator(device=on)
        gen.manual_seed(seed)
        return _grow_trees(
            binned.to(on), yy.to(on), torch.from_numpy(weights[lo:hi]).to(on),
            n_bins.to(on), is_cat.to(on), gen,
            max_depth=max_depth, n_bins_max=int(data.n_bins.max()),
            n_classes=n_classes, impurity=impurity, mtry=mtry,
            trees=(lo, num_trees),
        )

    from oryx_tpu_torch.parallel.mesh import DATA_AXIS

    if mesh is not None and num_trees % mesh.shape[DATA_AXIS] == 0:
        per = num_trees // mesh.shape[DATA_AXIS]
        rows = {d: grow(mesh.device(d, 0), d * per, (d + 1) * per)
                for d in mesh.local_rows()}
        cell0 = mesh.cells()[0]
        feature, split_left, counts, importance = (
            mesh.all_gather({c: rows[c[0]][j] for c in mesh.cells()}, DATA_AXIS)[cell0]
            for j in range(4))
    else:
        feature, split_left, counts, importance = grow(dev, 0, num_trees)
    feature = feature.cpu().numpy()
    split_left = split_left.cpu().numpy()
    counts = counts.cpu().numpy().astype(np.float64)
    imp = importance.cpu().numpy().sum(axis=0).astype(np.float64)
    imp = imp / imp.max() if imp.max() > 0 else imp
    if classification:
        return Forest(feature, split_left, counts, None, imp, max_depth)
    return Forest(
        feature, split_left, None,
        np.stack([counts[..., 0], counts[..., 1]], axis=-1),  # (w, wy)
        imp, max_depth,
    )


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def route_binned(
    feature: np.ndarray, split_left: np.ndarray, binned: np.ndarray, max_depth: int
) -> np.ndarray:
    """Host routing: binned examples [Ne,P] -> terminal heap slot per tree
    [T,Ne] (numpy, a copy of the JAX package's; the reference's
    DecisionTree.findTerminal)."""
    t = feature.shape[0]
    ne = binned.shape[0]
    node = np.zeros((t, ne), dtype=np.int64)
    tree_ix = np.arange(t)[:, None]
    for _ in range(max_depth):
        f = feature[tree_ix, node]  # [T, Ne]
        internal = f >= 0
        fb = binned[np.arange(ne)[None, :], np.clip(f, 0, None)]  # [T, Ne]
        goes_left = split_left[tree_ix, node, fb]
        child = 2 * node + 1 + (1 - goes_left.astype(np.int64))
        node = np.where(internal, child, node)
    return node


def route_binned_device(
    feature: torch.Tensor, split_left: torch.Tensor, binned: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Device routing (the port of ``route_binned_jit``), the semantics of
    route_binned: one gather loop over depth, batched over trees x
    examples, on the device the tensors are on. -> [T,Ne] int64."""
    t, m = feature.shape
    ne, p = binned.shape
    b = split_left.shape[2]
    dev = feature.device
    node = torch.zeros((t, ne), dtype=torch.int64, device=dev)
    tree_off = torch.arange(t, device=dev)[:, None] * m
    ex_off = torch.arange(ne, device=dev)[None, :] * p
    f_flat, s_flat, x_flat = feature.reshape(-1), split_left.reshape(-1), binned.reshape(-1)
    for _ in range(max_depth):
        f = f_flat[tree_off + node].to(torch.int64)  # [T, Ne]
        fb = x_flat[ex_off + torch.clamp(f, min=0)].to(torch.int64)
        goes_left = s_flat[(tree_off + node) * b + fb]
        child = 2 * node + 1 + (~goes_left).to(torch.int64)
        node = torch.where(f >= 0, child, node)
    return node


def class_probs_from_leaves(forest: Forest, leaves: np.ndarray) -> np.ndarray:
    """[Ne, C] probabilities from terminal slots [T, Ne]: uniform-weight
    vote of per-leaf normalized class counts."""
    counts = forest.class_counts[np.arange(forest.num_trees)[:, None], leaves]
    probs = counts / np.maximum(counts.sum(axis=-1, keepdims=True), 1e-12)
    return probs.mean(axis=0)


def regression_from_leaves(forest: Forest, leaves: np.ndarray) -> np.ndarray:
    """[Ne] uniform-weight mean of leaf means from terminal slots [T, Ne]."""
    stats = forest.leaf_stats[np.arange(forest.num_trees)[:, None], leaves]
    means = stats[..., 1] / np.maximum(stats[..., 0], 1e-12)
    return means.mean(axis=0)


def predict_class_probs(forest: Forest, binned: np.ndarray) -> np.ndarray:
    """[Ne, C] probabilities (reference WeightedPrediction.voteOnFeature
    over CategoricalPredictions), routed on the host."""
    leaves = route_binned(forest.feature, forest.split_left, binned, forest.max_depth)
    return class_probs_from_leaves(forest, leaves)


def predict_regression(forest: Forest, binned: np.ndarray) -> np.ndarray:
    """[Ne] regression prediction, routed on the host."""
    leaves = route_binned(forest.feature, forest.split_left, binned, forest.max_depth)
    return regression_from_leaves(forest, leaves)
