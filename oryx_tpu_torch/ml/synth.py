"""Synthetic MovieLens-shaped interaction data (the port's copy of
oryx_tpu/ml/synth.py, which the bench and the Spark-MLlib baseline runner
share): the same generator and seed give the same interactions in both
packages.

The bench host has no dataset egress, so the ALS north-star measurement
(BASELINE.json: model-build wall-clock at MovieLens-25M scale) runs on
data synthesized to the ML-25M shape: ~162k users x 59k items x 25M
interactions, Zipf-skewed item popularity, log-normal user activity.
Every build that is compared with another MUST consume this exact
generator with the same seed — otherwise a comparison of two builds
compares two different problems.

Planted latent structure: users and items carry genres and most of a
user's interactions stay inside their genre. Without structure the
held-out AUC hovers near the popularity baseline and says nothing about
model quality; with it a well-trained model must clear ~0.8, so the
reported AUC is a real quality signal.
"""

from __future__ import annotations

import numpy as np


def synthesize_interactions(
    n_users: int,
    n_items: int,
    nnz: int,
    seed: int = 7,
    n_genres: int = 32,
    in_genre_p: float = 0.8,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (users, items, values): nnz interactions with ML-25M-like
    marginals and planted genre structure. Deterministic in seed."""
    rng = np.random.default_rng(seed)
    item_w = 1.0 / np.power(np.arange(1, n_items + 1), 0.9)
    item_w /= item_w.sum()
    user_w = rng.lognormal(0.0, 1.1, n_users)
    user_w /= user_w.sum()
    item_genre = rng.integers(0, n_genres, n_items)
    user_genre = rng.integers(0, n_genres, n_users)
    users = rng.choice(n_users, size=nnz, p=user_w).astype(np.int64)
    items = rng.choice(n_items, size=nnz, p=item_w).astype(np.int64)
    # redraw the in-genre portion from the user's own genre, popularity-
    # weighted within it (one vectorized choice per genre)
    in_genre = rng.random(nnz) < in_genre_p
    ug = user_genre[users]
    for g in range(n_genres):
        rows = np.nonzero(in_genre & (ug == g))[0]
        pool = np.nonzero(item_genre == g)[0]
        if rows.size == 0 or pool.size == 0:
            continue
        w = item_w[pool] / item_w[pool].sum()
        items[rows] = rng.choice(pool, size=rows.size, p=w)
    values = rng.choice(
        [0.5, 1, 1.5, 2, 2.5, 3, 3.5, 4, 4.5, 5], size=nnz
    ).astype(np.float64)
    return users, items, values
