"""The build-and-evaluate harnesses of ALS, RDF and k-means (the port's
copy of those parts of oryx_tpu/ml/quality.py): synthesize data from the
same seeds, train on the card, and measure quality — ALS's held-out AUC
(with NaN factor rows surfaced as a first-class diagnostic), the forest's
held-out accuracy on a planted rule, and k-means' SSE against the planted
centers and its silhouette. ``chip_smoke.py`` runs them on the card at the
bench's shapes.

The serving recall gate (``evaluate_score_mode_recall``): the quantized
(int8 + exact rescore) and approx score modes are measured for recall@k
against the exact top-k on a standing synthetic corpus; either mode below
``MIN_SCORE_MODE_RECALL`` fails the gate, so speed can never silently buy
wrong answers. The seq harness comes with its own slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

# The recall@k floor quantized/approx serving must hold against exact
# top-k (the serve path's acceptance bar; enforced by the tier-1 gate in
# the tests and by the smoke run's gate line on the card).
MIN_SCORE_MODE_RECALL = 0.95


@dataclass
class BuildReport:
    build_s: float
    agg_s: float
    auc: float
    nan_rows: int
    interactions: int
    timings: dict = field(default_factory=dict)
    # the trained factors (ops/als.py ALSModelArrays) and the aggregated
    # training data, for a caller that looks further at the build
    model: object = None
    data: object = None


def build_and_evaluate(
    n_users: int,
    n_items: int,
    nnz: int,
    features: int = 50,
    iterations: int = 10,
    lam: float = 0.01,
    alpha: float = 1.0,
    compute_dtype: str = "bfloat16",
    seed: int = 7,
    holdout_p: float = 0.02,
    sample_users: int = 2000,
    device=None,
    timings: dict | None = None,
) -> BuildReport:
    """Synthesize (ml/synth.py), train on ``device`` (the card unless the
    caller names the CPU) and evaluate one ALS build. The held-out AUC
    measures each compute_dtype's quality on every run. ``timings``, when
    given, is the dict train_als fills (lists_s, train_s, train_flops) and
    also receives synth_s; the report carries the same dict."""
    from oryx_tpu_torch.ml.synth import synthesize_interactions
    from oryx_tpu_torch.ops.als import aggregate_interactions, train_als

    # offset the eval stream from the data stream: same-seed generators
    # share the underlying bitstream, which would correlate the holdout
    # mask with the generator's user-activity draws
    rng = np.random.default_rng(seed + 1_000_003)
    timings = {} if timings is None else timings
    t_synth = time.perf_counter()
    users, items, values = synthesize_interactions(
        n_users, n_items, nnz, seed=seed
    )
    timings["synth_s"] = time.perf_counter() - t_synth
    test_mask = rng.random(nnz) < holdout_p
    tr = ~test_mask

    t0 = time.perf_counter()
    data = aggregate_interactions(users[tr], items[tr], values[tr], implicit=True)
    agg_s = time.perf_counter() - t0
    model = train_als(
        data,
        features=features,
        lam=lam,
        alpha=alpha,
        iterations=iterations,
        implicit=True,
        compute_dtype=compute_dtype,
        timings=timings,
        device=device,
    )
    build_s = time.perf_counter() - t0

    x_np = np.asarray(model.x, dtype=np.float32)
    y_np = np.asarray(model.y, dtype=np.float32)
    nan_rows = int(
        np.isnan(x_np).any(axis=1).sum() + np.isnan(y_np).any(axis=1).sum()
    )

    auc = holdout_auc(model, users, items, test_mask, rng, sample_users)
    return BuildReport(
        build_s=build_s,
        agg_s=agg_s,
        auc=float(auc),
        nan_rows=nan_rows,
        interactions=nnz,
        timings=timings,
        model=model,
        data=data,
    )


def holdout_auc(
    model, users, items, test_mask, rng, sample_users: int = 2000
) -> float:
    """Mean per-user AUC of ``model`` on the held-out interactions
    (``test_mask``) of ``sample_users`` users drawn from ``rng``, with
    each sampled user's training items excluded as negatives."""
    from oryx_tpu_torch.ml.evaluate import auc_mean_per_user

    tr = ~test_mask
    # AUC on a user sample (a full per-user python loop would dominate
    # the wall-clock; 2000 users gives a +/-0.005 CI on the mean)
    uid_to_row = {u: j for j, u in enumerate(model.user_ids)}
    iid_to_row = {i: j for j, i in enumerate(model.item_ids)}
    tu_all, ti_all = users[test_mask], items[test_mask]
    known: dict[int, set[int]] = {}
    tu, ti = [], []
    sample = set(
        rng.choice(
            np.unique(tu_all),
            size=min(sample_users, len(np.unique(tu_all))),
            replace=False,
        ).tolist()
    )
    for u, i in zip(tu_all, ti_all):
        if u not in sample:
            continue
        ur, ir = uid_to_row.get(str(u)), iid_to_row.get(str(i))
        if ur is None or ir is None:
            continue
        tu.append(ur)
        ti.append(ir)
    # known (training) items for the sampled users, excluded as negatives
    smp = np.isin(users, np.fromiter(sample, dtype=np.int64)) & tr
    for u, i in zip(users[smp], items[smp]):
        ur, ir = uid_to_row.get(str(u)), iid_to_row.get(str(i))
        if ur is not None and ir is not None:
            known.setdefault(ur, set()).add(ir)
    return auc_mean_per_user(
        model.x,
        model.y,
        np.asarray(tu, dtype=np.int64),
        np.asarray(ti, dtype=np.int64),
        known,
    )



@dataclass
class RecallReport:
    """Measured recall@k of the approximate serving score modes against
    exact top-k on the standing corpus. green = both modes at/above the
    floor."""

    recall_quantized: float
    recall_approx: float
    k: int
    n_queries: int
    n_items: int
    features: int
    min_recall: float
    approx_recall_target: float
    eval_s: float

    @property
    def green(self) -> bool:
        return (
            self.recall_quantized >= self.min_recall
            and self.recall_approx >= self.min_recall
        )


def mean_recall_at_k(got_idx: np.ndarray, exact_idx: np.ndarray, k: int) -> float:
    """Mean per-query |top-k ∩ exact top-k| / k — the ONE recall
    definition the gate and the smoke's measured-recall fields share, so
    the numbers they report can never drift in meaning."""
    return float(
        np.mean([
            len(set(map(int, g[:k])) & set(map(int, e[:k]))) / k
            for g, e in zip(got_idx, exact_idx)
        ])
    )


def recall_corpus(n_items: int, features: int, n_queries: int, seed: int):
    """The gate's standing corpus, (item matrix [n_items, features] f32,
    queries [n_queries, features] f32): low-rank structure plus noise,
    like a trained Y — pure iid gaussians under-stress quantization
    (scores concentrate), planted structure gives realistic near-ties.
    The same draws as the JAX package's gate."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((max(8, features // 4), features))
    y = (
        rng.standard_normal((n_items, basis.shape[0])) @ basis
        + 0.5 * rng.standard_normal((n_items, features))
    ).astype(np.float32)
    xs = rng.standard_normal((n_queries, features)).astype(np.float32)
    return y, xs


def rescored_topk(y: np.ndarray, xs: np.ndarray, cand_idx, k: int) -> np.ndarray:
    """Exact f32 re-rank of each query's candidate rows on the host (the
    serve path's ``_rerank_exact``), then top-k: what a client sees."""
    cand_idx = np.asarray(cand_idx)
    out = np.empty((xs.shape[0], k), dtype=np.int64)
    for qi in range(xs.shape[0]):
        rows = cand_idx[qi]
        scores = y[rows] @ xs[qi]
        order = np.argsort(-scores, kind="stable")[:k]
        out[qi] = rows[order]
    return out


def evaluate_score_mode_recall(
    n_items: int = 100_000,
    features: int = 50,
    k: int = 10,
    n_queries: int = 256,
    seed: int = 23,
    approx_recall_target: float = 0.95,
    min_recall: float = MIN_SCORE_MODE_RECALL,
    overfetch: int | None = None,
    device=None,
) -> RecallReport:
    """Measure recall@k of the quantized and approx serving modes against
    the exact top-k on a standing synthetic corpus (deterministic seed —
    the same corpus every run, so the number is a gate, not a dice roll).

    Each mode is measured the way serving runs it (apps/als/serving.py):
    the serving entry ``topk_dot_batch`` selects an over-fetched candidate
    set on ``device`` (the card by default), the candidates are re-ranked
    EXACTLY in f32 on the host, and the top-k of that re-rank is what a
    client sees. The quantized row scores a ``QuantizedMatrix`` view: on
    the card that is the int8 ``topk_dot_partial`` and ``topk_merge``; on
    ``device="cpu"`` their plain versions. The approx row goes through
    ``topk_dot_batch(..., recall=target)``, which computes exactly, as
    ``jax.lax.approx_max_k`` does off the TPU. The exact reference is the
    plain f32 product with TF32 off (``topk_dot_batch_xla``). The overfetch
    defaults to k + 8 — the rescore set a no-exclusion request gets — so
    the gate is never more forgiving than production's weakest case."""
    import torch

    from oryx_tpu_torch.device import resolve_device
    from oryx_tpu_torch.ops.als import topk_dot_batch, topk_dot_batch_xla
    from oryx_tpu_torch.ops.transfer import quantized_device_put

    dev = resolve_device(device)
    t0 = time.perf_counter()
    y, xs = recall_corpus(n_items, features, n_queries, seed)
    if overfetch is None:
        overfetch = min(n_items, k + 8)
    xs_d = torch.from_numpy(xs).to(dev)
    y_d = torch.from_numpy(y).to(dev)
    _, exact_idx = topk_dot_batch_xla(xs_d, y_d, k=k)
    exact_idx = exact_idx.cpu().numpy()

    # quantized: int8 rows + per-row scales, the serving view's layout
    _, q_idx = topk_dot_batch(
        xs_d, quantized_device_put(y, device=dev), k=overfetch
    )
    recall_q = mean_recall_at_k(
        rescored_topk(y, xs, q_idx.cpu().numpy(), k), exact_idx, k
    )
    # approx: the serving entry at the recall target, exact rescore of
    # whatever it returns
    _, a_idx = topk_dot_batch(
        xs_d, y_d, k=min(overfetch, n_items), recall=approx_recall_target
    )
    recall_a = mean_recall_at_k(
        rescored_topk(y, xs, a_idx.cpu().numpy(), k), exact_idx, k
    )
    return RecallReport(
        recall_quantized=recall_q,
        recall_approx=recall_a,
        k=k,
        n_queries=n_queries,
        n_items=n_items,
        features=features,
        min_recall=min_recall,
        approx_recall_target=approx_recall_target,
        eval_s=time.perf_counter() - t0,
    )


@dataclass
class RDFReport:
    build_s: float
    accuracy: float
    examples: int
    trees: int
    noise_rate: float
    n_classes: int
    timings: dict = field(default_factory=dict)
    # the forest, its binned training data and labels, and the held-out
    # rows binned with the training edges, for a caller that looks further
    # at the build
    forest: object = None
    data: object = None
    y_train: np.ndarray | None = None
    test_binned: np.ndarray | None = None

    @property
    def accuracy_ceiling(self) -> float:
        """Achievable held-out accuracy: flipped labels agree with the
        rule by chance 1/n_classes of the time."""
        return 1.0 - self.noise_rate * (1.0 - 1.0 / self.n_classes)


def build_and_evaluate_rdf(
    n_examples: int = 581_012,
    n_features: int = 54,
    n_classes: int = 7,
    num_trees: int = 20,
    max_depth: int = 10,
    noise_rate: float = 0.1,
    holdout_p: float = 0.1,
    seed: int = 13,
    feature_subset: str | int = 14,
    device=None,
) -> RDFReport:
    """Planted-rule synthetic at UCI-covertype shape (581k x 54, 7
    classes), the JAX package's harness on the same data from the same
    seed: the label is a rule over 4 axis-aligned thresholds with
    ``noise_rate`` labels flipped, so a healthy forest lands near
    ``accuracy_ceiling``. Grown on ``device`` (the card unless the caller
    names the CPU); the held-out rows are binned with the training edges
    and routed on the same device. ``timings`` gets bin_s and grow_s."""
    from oryx_tpu_torch.device import resolve_device
    from oryx_tpu_torch.ops.rdf import (
        bin_column,
        bin_dataset,
        class_probs_from_leaves,
        grow_forest,
        route_binned_device,
    )

    import torch

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_examples, n_features)).astype(np.float32)
    r1 = (x[:, 0] > 0).astype(np.int64)
    r2 = (x[:, 7] > 0.5).astype(np.int64)
    r3 = (x[:, 21] > -0.5).astype(np.int64)
    r4 = (x[:, 40] > 0.3).astype(np.int64)
    y_true = (r1 * 4 + r2 * 2 + r3 + r4) % n_classes
    flip = rng.random(n_examples) < noise_rate
    y = np.where(
        flip, rng.integers(0, n_classes, n_examples), y_true
    ).astype(np.int32)

    test = rng.random(n_examples) < holdout_p
    tr = ~test

    timings: dict = {}
    t0 = time.perf_counter()
    binned = bin_dataset(
        x[tr],
        is_categorical=np.zeros(n_features, dtype=bool),
        category_counts=np.zeros(n_features, dtype=np.int32),
        max_split_candidates=32,
    )
    t1 = time.perf_counter()
    forest = grow_forest(
        binned, y[tr], num_trees=num_trees, max_depth=max_depth,
        impurity="entropy", n_classes=n_classes,
        feature_subset=feature_subset, device=dev,
    )
    build_s = time.perf_counter() - t0
    timings["bin_s"], timings["grow_s"] = t1 - t0, build_s - (t1 - t0)

    xt = x[test]
    test_binned = np.empty_like(xt, dtype=np.int32)
    for j in range(n_features):
        test_binned[:, j] = bin_column(
            xt[:, j], binned.edges[j], int(binned.n_bins[j])
        )
    leaves = route_binned_device(
        torch.from_numpy(forest.feature).to(dev),
        torch.from_numpy(forest.split_left).to(dev),
        torch.from_numpy(test_binned).to(dev),
        forest.max_depth,
    ).cpu().numpy()
    probs = class_probs_from_leaves(forest, leaves)
    acc = float((np.argmax(probs, axis=1) == y[test]).mean())
    return RDFReport(
        build_s=build_s,
        accuracy=acc,
        examples=n_examples,
        trees=num_trees,
        noise_rate=noise_rate,
        n_classes=n_classes,
        timings=timings,
        forest=forest,
        data=binned,
        y_train=y[tr],
        test_binned=test_binned,
    )


@dataclass
class KMeansReport:
    build_s: float
    sse_ratio: float  # model SSE / planted-centers SSE (1.0 = perfect)
    silhouette: float
    points: int
    k: int
    timings: dict = field(default_factory=dict)
    # the trained centers and the points on the device, for a caller that
    # looks further at the build
    model: object = None
    points_device: object = None


def build_and_evaluate_kmeans(
    n_points: int = 1_000_000,
    dims: int = 20,
    k: int = 50,
    iterations: int = 10,
    spread: float = 5.0,
    seed: int = 19,
    device=None,
) -> KMeansReport:
    """Planted Gaussian blobs (the JAX package's harness on the same data
    from the same seed): k true centers at ``spread`` separation,
    unit-variance clusters. A healthy k-means|| + Lloyd's run recovers
    near the generating structure: SSE within a small factor of the
    planted-centers SSE, positive silhouette. Trained and measured on
    ``device`` (the card unless the caller names the CPU); ``timings``
    gets the trainer's upload_s, init_s and lloyd_s."""
    from oryx_tpu_torch.device import resolve_device
    from oryx_tpu_torch.ops.kmeans import (
        silhouette_coefficient,
        sum_squared_error,
        train_kmeans,
    )

    import torch

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers_true = (rng.standard_normal((k, dims)) * spread).astype(np.float32)
    pts = (
        centers_true[rng.integers(0, k, n_points)]
        + rng.standard_normal((n_points, dims))
    ).astype(np.float32)

    timings: dict = {}
    t0 = time.perf_counter()
    model = train_kmeans(pts, k=k, iterations=iterations, device=dev,
                         timings=timings)
    build_s = time.perf_counter() - t0

    pts_d = torch.from_numpy(pts).to(dev)  # one upload for the metrics
    sse_model = sum_squared_error(pts_d, model.centers)
    sse_true = sum_squared_error(pts_d, centers_true)
    sil = silhouette_coefficient(pts_d, model.centers)
    return KMeansReport(
        build_s=build_s,
        sse_ratio=float(sse_model / sse_true),
        silhouette=float(sil),
        points=n_points,
        k=k,
        timings=timings,
        model=model,
        points_device=pts_d,
    )
