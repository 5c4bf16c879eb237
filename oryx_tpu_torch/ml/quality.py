"""The ALS build-and-evaluate harness (the port's copy of the ALS part of
oryx_tpu/ml/quality.py): synthesize interactions, train, and measure the
held-out AUC, with NaN factor rows surfaced as a first-class diagnostic.
``chip_smoke.py`` runs it on the card at the bench's north-star shape. The
RDF, k-means and serving-recall harnesses come with their own slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


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
    from oryx_tpu_torch.ml.evaluate import auc_mean_per_user
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
    auc = auc_mean_per_user(
        model.x,
        model.y,
        np.asarray(tu, dtype=np.int64),
        np.asarray(ti, dtype=np.int64),
        known,
    )
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
