"""Evaluation metrics for the batch harness (the port's copy of
oryx_tpu/ml/evaluate.py).

Parity targets: the reference's implicit-ALS mean per-user AUC with sampled
negatives (app/oryx-app-mllib .../als/Evaluation.areaUnderCurve, :70-130),
explicit RMSE (Evaluation.rmse:49-55), and classification accuracy. The
clustering indices (Davies-Bouldin, Dunn, Silhouette, SSE) live with the
k-means ops, which come with the k-means slice (ROADMAP queue 1 item 7).
Scoring is numpy on the host, over factors already brought back.
"""

from __future__ import annotations

import numpy as np

from oryx_tpu_torch.common.rng import RandomManager


def rmse(x: np.ndarray, y: np.ndarray, users: np.ndarray, items: np.ndarray, values: np.ndarray) -> float:
    """Root-mean-square error of x_u . y_i vs held-out values; negated by
    callers that need bigger-is-better."""
    if len(values) == 0:
        return float("nan")
    preds = np.einsum("ik,ik->i", x[users], y[items])
    return float(np.sqrt(np.mean((preds - values) ** 2)))


def auc_mean_per_user(
    x: np.ndarray,
    y: np.ndarray,
    test_users: np.ndarray,
    test_items: np.ndarray,
    known_by_user: dict[int, set[int]] | None = None,
    negatives_per_positive: int = 1,
) -> float:
    """Mean per-user AUC: for each test user, P(score(held-out positive) >
    score(sampled negative)), negatives drawn from items the user has not
    interacted with. Same statistic as the reference's custom AUC."""
    if len(test_users) == 0:
        return float("nan")
    rng = RandomManager.get_random()
    n_items = y.shape[0]
    known_by_user = known_by_user or {}
    aucs = []
    for u in np.unique(test_users):
        pos = test_items[test_users == u]
        known = known_by_user.get(int(u), set()) | set(int(i) for i in pos)
        if len(known) >= n_items or len(pos) == 0:
            continue
        n_neg = len(pos) * negatives_per_positive
        negs = []
        # rejection-sample negatives; bounded tries keeps it honest on
        # dense users
        tries = 0
        while len(negs) < n_neg and tries < 20 * n_neg:
            c = int(rng.integers(n_items))
            tries += 1
            if c not in known:
                negs.append(c)
        if not negs:
            continue
        user_scores = y @ x[int(u)]
        pos_s = user_scores[pos]
        neg_s = user_scores[np.asarray(negs)]
        # all-pairs comparison, ties count half
        wins = (pos_s[:, None] > neg_s[None, :]).mean()
        ties = (pos_s[:, None] == neg_s[None, :]).mean()
        aucs.append(wins + 0.5 * ties)
    return float(np.mean(aucs)) if aucs else float("nan")


def accuracy(predicted: np.ndarray, actual: np.ndarray) -> float:
    if len(actual) == 0:
        return float("nan")
    return float(np.mean(np.asarray(predicted) == np.asarray(actual)))
