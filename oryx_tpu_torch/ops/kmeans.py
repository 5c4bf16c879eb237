"""k-means on the card: Lloyd's iterations, k-means|| init and the four
evaluation metrics (the port of oryx_tpu/ops/kmeans.py).

The reference's compute path (app/oryx-app-mllib .../kmeans/
KMeansUpdate.java:104-116, MLlib KMeans.train with k-means|| or random
init) becomes torch ops on one device; none of it is a Pallas kernel in
the JAX package, so none is a hand kernel here:

- Distances are the ||x||^2 - 2x.c + ||c||^2 expansion: one [N,D]x[D,K]
  product in full f32 (TF32 off, ``full_f32``; a TF32 product moves argmin
  results near ties), in the JAX package's operation order.
- A Lloyd iteration is that product, an argmin over K (the first of tied
  centers, as ``jnp.argmin``), and the weighted segment sums as two
  ``index_add_`` into [K,D] and [K] (the JAX package's one-hot [K,N]x[N,D]
  product would add a [N,K] f32 array, 2 GB at 5M x 100). Zero-weight rows
  never move a center; an empty cluster keeps its previous center. The sums
  run in another order than XLA's, so centers agree within a tolerance.
- k-means|| (Bahmani et al.) keeps the running min squared distance on the
  card and draws its distance-proportional candidates there from a
  ``torch.Generator`` (``RandomManager.get_generator``); the candidate set
  then goes to the host for the weighted maximin seeding (a numpy copy) and
  comes back for a weighted Lloyd refinement.
- The metrics mirror app/oryx-app-mllib .../kmeans/{SumSquaredError,
  DaviesBouldinIndex,DunnIndex,SilhouetteCoefficient}.java: euclidean
  distances, mean-distance cluster scatter, silhouette over a bounded sample
  with single-point clusters contributing 0.

Every entry point takes ``device=None`` (the card; ``device="cpu"`` only
when the caller names it) and points as a numpy array or a tensor already
on the device. A ``mesh`` raises: multi-device training is ROADMAP queue 1
item 11.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.vector import full_f32

SILHOUETTE_MAX_SAMPLE = 4096

# Distances are scored in row chunks of at most this many [rows, K] f32
# entries (1 GiB): k-means|| weights ~2k x rounds candidates, which at 5M
# points would otherwise be a 20 GB matrix.
_ASSIGN_CHUNK_ELEMS = 1 << 28

_NOT_PORTED_MESH = (
    "{}: mesh training is not ported to the PyTorch port yet "
    "(ROADMAP queue 1 item 11: multi-device)"
)


def _device_for(x, device) -> torch.device:
    """The device a call runs on: a tensor's own when the caller names
    none, else ``resolve_device`` (the card by default)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _on(x, device: torch.device) -> torch.Tensor:
    """f32 tensor on ``device`` from a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    a = np.ascontiguousarray(x, dtype=np.float32)
    if not a.flags.writeable:  # e.g. a view of another framework's array
        a = a.copy()
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# assignment + training
# ---------------------------------------------------------------------------

def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[N,K] squared euclidean distances via the matmul expansion, summed
    in the JAX package's order: (p2 - 2 cross) + c2, clamped at 0."""
    with full_f32():
        d = points @ centers.T
    p2 = (points * points).sum(dim=1, keepdim=True)
    c2 = (centers * centers).sum(dim=1)
    return d.mul_(-2.0).add_(p2).add_(c2[None, :]).clamp_(min=0.0)


def _assign(points: torch.Tensor, centers: torch.Tensor):
    """-> (ids, squared distance to the nearest center), in row chunks;
    ``torch.min`` returns the first of tied minima."""
    rows = max(1, _ASSIGN_CHUNK_ELEMS // max(centers.shape[0], 1))
    if len(points) <= rows:
        best, ids = torch.min(_sq_dists(points, centers), dim=1)
        return ids, best
    ids = torch.empty(len(points), dtype=torch.int64, device=points.device)
    best = torch.empty(len(points), dtype=torch.float32, device=points.device)
    for s in range(0, len(points), rows):
        best[s:s + rows], ids[s:s + rows] = torch.min(
            _sq_dists(points[s:s + rows], centers), dim=1)
    return ids, best


def assign_clusters(points, centers, device=None):
    """-> (cluster ids [N] int64, distance-to-nearest [N] f32) as tensors on
    the device; ties go to the first center, as ``jnp.argmin``."""
    dev = _device_for(points, device)
    ids, d2 = _assign(_on(points, dev), _on(centers, dev))
    return ids, torch.sqrt(d2)


def lloyd(points, weights, centers0, *, iterations: int, device=None):
    """Weighted Lloyd's from ``centers0`` -> (centers [K,D] f32, counts [K]
    f32, the weight of each center's final assignment), tensors on the
    device. Zero-weight rows never move a center; empty clusters keep their
    previous center."""
    dev = _device_for(points, device)
    p = _on(points, dev)
    w = _on(weights, dev)
    centers = _on(centers0, dev).clone()
    k = centers.shape[0]
    wp = p * w[:, None]

    def segment_sums(ids):
        sums = torch.zeros_like(centers).index_add_(0, ids, wp)
        counts = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(0, ids, w)
        return sums, counts

    for _ in range(iterations):
        ids, _ = _assign(p, centers)
        sums, counts = segment_sums(ids)
        centers = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp(counts, min=1.0)[:, None],
            centers,
        )
    # final assignment for cluster sizes
    _, counts = segment_sums(_assign(p, centers)[0])
    return centers, counts


def _kmeans_parallel_init(
    points: np.ndarray,
    pts_d: torch.Tensor,
    weights_d: torch.Tensor,
    k: int,
    gen: torch.Generator,
    rounds: int = 5,
) -> np.ndarray:
    """k-means|| oversampling on the card, reduced to k centers by weighted
    maximin seeding (host) and weighted Lloyd (card)."""
    dev = pts_d.device
    n = len(points)
    first = int(torch.randint(0, n, (1,), generator=gen, device=gen.device))
    candidates = [points[first]]
    new = pts_d[first:first + 1]
    ell = 2 * k
    w64 = weights_d.double()
    d2 = None  # running min squared distance to ANY candidate so far:
    # each round scores only the centers added last round
    for r in range(rounds):
        if len(new):  # an empty round keeps d2 and simply redraws below
            _, nd2 = _assign(pts_d, new)
            nd2 = nd2.double()
            d2 = nd2 if d2 is None else torch.minimum(d2, nd2)
        dw = d2 * w64
        total = float(dw.sum())
        if total <= 0:
            break
        prob = torch.clamp(ell * dw / total, max=1.0)
        draw = torch.rand(n, generator=gen, device=gen.device).to(dev)
        picked = torch.nonzero(draw < prob)[:, 0]
        new = pts_d[picked]
        candidates.extend(new.cpu().numpy())
        if len(candidates) >= max(ell * rounds, k):
            break
    cand = np.unique(np.stack(candidates), axis=0)
    if len(cand) <= k:
        # not enough distinct candidates: fill with random distinct points
        m = min(n, 2 * k)
        extra = torch.randperm(n, generator=gen, device=gen.device)[:m].cpu().numpy()
        cand = np.unique(np.concatenate([cand, points[extra]]), axis=0)
    # duplicate-heavy data may simply not have k distinct points: clamp
    k = min(k, len(cand))
    # weight candidates by the total point weight attracted to each
    cand_d = _on(cand, dev)
    ids, _ = _assign(pts_d, cand_d)
    w = torch.zeros(len(cand), dtype=torch.float32, device=dev).index_add_(
        0, ids, weights_d)
    w = w.cpu().numpy()
    seeds = _weighted_kmeanspp(cand, w, k)
    centers, _ = lloyd(cand_d, torch.from_numpy(w).to(dev), seeds, iterations=10)
    return centers.cpu().numpy()


def _weighted_kmeanspp(cand: np.ndarray, w: np.ndarray, k: int) -> np.ndarray:
    """Weighted MAXIMIN (farthest-point) seeding over the candidate set — a
    numpy copy of the JAX package's, bit-identical (without its unused
    ``key``). The heaviest candidate seeds first; each next seed is argmax
    over d^2-to-nearest-seed times attracted weight, so an uncovered
    well-separated cluster cannot be skipped."""
    wf = np.asarray(w, dtype=np.float64)
    first = int(wf.argmax())
    chosen = [first]
    d2 = ((cand - cand[first]) ** 2).sum(axis=1).astype(np.float64)
    for _ in range(1, k):
        pw = d2 * wf
        if pw.max() <= 0:
            # all remaining candidates coincide with chosen seeds:
            # duplicates are harmless (Lloyd merges them)
            chosen.append(first)
            continue
        idx = int(pw.argmax())
        chosen.append(idx)
        d2 = np.minimum(d2, ((cand - cand[idx]) ** 2).sum(axis=1))
    return cand[np.asarray(chosen, dtype=np.int64)]


@dataclass
class KMeansModelArrays:
    centers: np.ndarray  # [K,D] f32
    counts: np.ndarray  # [K] int64 cluster sizes on training data


def _random_init(points: np.ndarray, k: int, gen: torch.Generator):
    """k distinct points (not merely distinct indices): resample over
    progressively larger draws, then a full distinct scan."""
    n = len(points)
    for attempt in range(3):
        m = min(n, k * (2**attempt))
        draw = torch.randperm(n, generator=gen, device=gen.device)[:m].cpu().numpy()
        uniq = np.unique(points[draw], axis=0)  # note: sorts rows
        if len(uniq) >= k:
            break
    else:
        uniq = np.unique(points, axis=0)
    k = min(k, len(uniq))
    pick = torch.randperm(len(uniq), generator=gen, device=gen.device)[:k].cpu().numpy()
    return uniq[pick]


def train_kmeans(
    points: np.ndarray,
    k: int,
    iterations: int = 30,
    init: str = "k-means||",
    mesh=None,
    generator: torch.Generator | None = None,
    runs: int = 1,
    device=None,
    timings: dict | None = None,
) -> KMeansModelArrays:
    """Train k-means on ``device`` (the card unless the caller names the
    CPU). ``runs > 1`` restarts from fresh inits and keeps the lowest-SSE
    result (oryx.kmeans.runs). ``generator`` (a ``torch.Generator`` on the
    device) drives the init's draws; by default one from RandomManager.
    ``timings``, when given, receives upload_s, init_s and lloyd_s."""
    if mesh is not None:
        raise ValueError(_NOT_PORTED_MESH.format("train_kmeans"))
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32)
    points = points[~np.isnan(points).any(axis=1)]
    n = len(points)
    if n == 0:
        raise ValueError("no valid points")
    gen = generator if generator is not None else RandomManager.get_generator(dev)
    if runs > 1:
        best, best_sse = None, np.inf
        for _ in range(runs):  # each run draws on from the same stream
            m = train_kmeans(points, k, iterations, init, generator=gen,
                             device=dev, timings=timings)
            sse = sum_squared_error(points, m.centers, device=dev)
            if best is None or sse < best_sse:
                best, best_sse = m, sse
        return best
    if k >= n:
        # only in this degenerate regime is the distinct-row count worth
        # computing; a full-dataset np.unique on every call would dominate
        # host time for large N
        k = min(k, len(np.unique(points, axis=0)))

    t0 = time.perf_counter()
    pts_d = _on(points, dev)
    weights_d = torch.ones(n, dtype=torch.float32, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    if init == "random":
        centers0 = _random_init(points, k, gen)
    else:
        centers0 = _kmeans_parallel_init(points, pts_d, weights_d, k, gen)
    t2 = time.perf_counter()
    centers, counts = lloyd(pts_d, weights_d, centers0, iterations=iterations)
    out = KMeansModelArrays(
        centers.cpu().numpy(), counts.cpu().numpy().round().astype(np.int64)
    )
    if timings is not None:
        timings["upload_s"] = timings.get("upload_s", 0.0) + t1 - t0
        timings["init_s"] = timings.get("init_s", 0.0) + t2 - t1
        timings["lloyd_s"] = timings.get("lloyd_s", 0.0) + time.perf_counter() - t2
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# evaluation metrics (KMeansUpdate.java:137-173 strategies)
# ---------------------------------------------------------------------------

def _cluster_metrics(points, centers, device=None):
    """Per-cluster (count, mean dist, sum sq dist) over assigned points —
    the ClusterMetric reduction of AbstractKMeansEvaluation.java; the
    assignment on the device, the f64 reduction on the host."""
    ids, dist = assign_clusters(points, centers, device=device)
    ids = ids.cpu().numpy()
    dist = dist.cpu().numpy().astype(np.float64)
    k = len(centers)
    counts = np.bincount(ids, minlength=k).astype(np.float64)
    sum_d = np.bincount(ids, weights=dist, minlength=k)
    sum_d2 = np.bincount(ids, weights=dist**2, minlength=k)
    mean_d = np.divide(sum_d, counts, out=np.zeros(k), where=counts > 0)
    return ids, counts, mean_d, sum_d2


def _center_distances(centers, dev: torch.device) -> np.ndarray:
    c = _on(centers, dev)
    return np.sqrt(np.maximum(_sq_dists(c, c).cpu().numpy(), 0))


def sum_squared_error(points, centers, device=None) -> float:
    _, _, _, sum_d2 = _cluster_metrics(points, centers, device=device)
    return float(sum_d2.sum())


def davies_bouldin_index(points, centers, device=None) -> float:
    """Lower is better; for each cluster i, max over j of
    (scatter_i + scatter_j) / d(center_i, center_j), averaged."""
    dev = _device_for(points, device)
    _, _, mean_d, _ = _cluster_metrics(points, centers, device=dev)
    k = len(centers)
    if k < 2:
        return 0.0
    cd = _center_distances(centers, dev)
    total = 0.0
    for i in range(k):
        ratios = [
            (mean_d[i] + mean_d[j]) / cd[i, j]
            for j in range(k)
            if j != i and cd[i, j] > 0
        ]
        total += max(ratios) if ratios else 0.0
    return total / k


def dunn_index(points, centers, device=None) -> float:
    """Higher is better: min inter-centroid distance over max mean
    intra-cluster distance."""
    dev = _device_for(points, device)
    _, _, mean_d, _ = _cluster_metrics(points, centers, device=dev)
    k = len(centers)
    if k < 2:
        return 0.0
    cd = _center_distances(centers, dev)
    inter = min(cd[i, j] for i in range(k) for j in range(i + 1, k))
    intra = mean_d.max()
    return float(inter / intra) if intra > 0 else 0.0


def _silhouette(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Vectorized silhouette: one [S,S] pairwise-distance product and a
    [S,K] per-cluster mean-distance reduction; singleton clusters
    contribute 0 (SilhouetteCoefficient.java's convention)."""
    d = torch.sqrt(_sq_dists(points, points))  # [S,S]
    ids, _ = _assign(points, centers)
    k = centers.shape[0]
    onehot = torch.nn.functional.one_hot(ids, k).to(torch.float32)  # [S,K]
    n_c = onehot.sum(dim=0)  # [K]
    with full_f32():
        sum_to_cluster = d @ onehot  # [S,K]
    own_n = n_c[ids]
    a = torch.gather(sum_to_cluster, 1, ids[:, None])[:, 0] / torch.clamp(
        own_n - 1.0, min=1.0)
    mean_other = torch.where(
        (n_c[None, :] > 0) & (onehot == 0),
        sum_to_cluster / torch.clamp(n_c[None, :], min=1.0),
        torch.tensor(float("inf"), device=points.device),
    )
    b = mean_other.min(dim=1).values
    m = torch.maximum(a, b)
    s = torch.where((own_n > 1) & (m > 0) & torch.isfinite(b), (b - a) / m,
                    torch.zeros_like(a))
    return s.mean()


def silhouette_coefficient(points, centers, generator=None, device=None) -> float:
    """Mean silhouette over a bounded sample (the [S,S] distance matrix caps
    S at SILHOUETTE_MAX_SAMPLE); the sample is drawn on the device from
    ``generator`` (by default one from RandomManager)."""
    dev = _device_for(points, device)
    p = _on(points, dev)
    if len(p) > SILHOUETTE_MAX_SAMPLE:
        gen = generator if generator is not None else RandomManager.get_generator(dev)
        idx = torch.randperm(len(p), generator=gen, device=gen.device)
        p = p[idx[:SILHOUETTE_MAX_SAMPLE].to(dev)]
    return float(_silhouette(p, _on(centers, dev)))


def online_update(
    center: np.ndarray, count: int, new_point: np.ndarray, new_count: int
) -> tuple[np.ndarray, int]:
    """ClusterInfo.update (app/oryx-app-common .../kmeans/ClusterInfo.java:52):
    shift the centroid toward the new (mean) point by newCount/total."""
    center = np.asarray(center, dtype=np.float64)
    total = count + new_count
    frac = new_count / total
    return center + frac * (np.asarray(new_point, dtype=np.float64) - center), total
