"""Locality-sensitive hashing over factor vectors (the port's copy of
oryx_tpu/apps/als/lsh.py; with the same ``RandomManager`` test seed both
packages draw the same hyperplanes and so the same partitions).

Mirrors the reference's LocalitySensitiveHash (app/oryx-app-serving
.../als/model/LocalitySensitiveHash.java:36-177): pick the fewest sign-bit
hyperplane hashes (<= MAX_HASHES) whose probed-partition fraction meets the
configured sample rate while still probing >= num_cores partitions; choose
hyperplanes greedily by minimum total |cos| to those already chosen;
partition index = sign-bit fingerprint of the hyperplane dots; candidates =
all partitions within max_bits_differing Hamming distance of the query's.

The card's fused top-k (ops/topk.py) scores the whole catalog, so LSH is
off by default (oryx.als.sample-rate = 1.0). Configured with a sample rate
below 1 (upstream Oryx's published setting is 0.3), the candidate
partitions are scored on the host, as in the JAX package: that is the
configured mode's design, not a fallback, and no device failure ever
routes a request to it (apps/als/serving.py).
"""

from __future__ import annotations

import logging
import math

import numpy as np

from oryx_tpu_torch.common.rng import RandomManager

log = logging.getLogger(__name__)

MAX_HASHES = 16
_CANDIDATES_SINCE_BEST = 1000


def _choose_hash_count(sample_rate: float, num_cores: int) -> tuple[int, int]:
    """(num_hashes, max_bits_differing): fewest hashes achieving the sample
    rate, probing as many partitions as possible while <= num_cores
    (LocalitySensitiveHash.java:44-74 — the probe count may overshoot
    num_cores by one binomial step, by design)."""
    num_hashes = 0
    bits_differing = 0
    while num_hashes < MAX_HASHES:
        bits_differing = 0
        partitions_to_try = 1
        while bits_differing < num_hashes and partitions_to_try < num_cores:
            bits_differing += 1
            partitions_to_try += math.comb(num_hashes, bits_differing)
        if bits_differing == num_hashes and partitions_to_try < num_cores:
            num_hashes += 1
            continue  # can't keep all cores busy; more hashes
        if partitions_to_try <= sample_rate * (1 << num_hashes):
            break
        num_hashes += 1
    return num_hashes, bits_differing


class LocalitySensitiveHash:
    def __init__(
        self,
        sample_rate: float,
        num_features: int,
        num_cores: int | None = None,
        max_bits_differing: int | None = None,
    ):
        if num_cores is None:
            import os

            num_cores = os.cpu_count() or 1
        num_hashes, bits_differing = _choose_hash_count(sample_rate, num_cores)
        if max_bits_differing is not None:
            # explicit oryx.als.lsh-max-bits-differing override of the
            # derived Hamming-ball radius (wider = more candidate
            # partitions probed = higher recall, lower speedup)
            bits_differing = max(0, min(int(max_bits_differing), num_hashes))
        self.max_bits_differing = bits_differing
        log.info(
            "LSH with %d hashes, querying partitions with up to %d bits differing",
            num_hashes,
            bits_differing,
        )

        rng = RandomManager.get_random()
        vectors: list[np.ndarray] = []
        for _ in range(num_hashes):
            # greedy most-orthogonal pick: keep sampling random unit vectors
            # until 1000 in a row fail to lower the total |cos| to the
            # already-chosen hyperplanes
            best_score = np.inf
            best: np.ndarray | None = None
            since_best = 0
            while since_best < _CANDIDATES_SINCE_BEST:
                cand = rng.standard_normal(num_features).astype(np.float32)
                cand /= max(float(np.linalg.norm(cand)), 1e-12)
                score = sum(abs(float(v @ cand)) for v in vectors)
                if score < best_score:
                    best = cand
                    if score == 0.0:
                        break
                    best_score = score
                    since_best = 0
                else:
                    since_best += 1
            vectors.append(best)
        # [H, F]; empty H means one partition holding everything
        self.hash_vectors = (
            np.stack(vectors) if vectors else np.zeros((0, num_features), dtype=np.float32)
        )

        # all 2^H partition indices ordered by ascending popcount, so a
        # Hamming-ball query is a prefix of this list XOR the query index
        size = 1 << num_hashes
        order = np.argsort([bin(i).count("1") * size + i for i in range(size)], kind="stable")
        self._by_popcount = np.arange(size, dtype=np.int64)[order]
        self._prefix_for_bits = np.cumsum(
            [math.comb(num_hashes, b) for b in range(num_hashes + 1)]
        )

    @property
    def num_hashes(self) -> int:
        return self.hash_vectors.shape[0]

    @property
    def num_partitions(self) -> int:
        return 1 << self.num_hashes

    def index_for(self, vector: np.ndarray) -> int:
        """Sign-bit fingerprint: bit i set iff hyperplane_i . v > 0."""
        if self.num_hashes == 0:
            return 0
        dots = self.hash_vectors @ np.asarray(vector, dtype=np.float32)
        return int(np.sum((dots > 0.0) << np.arange(self.num_hashes)))

    def indices_for(self, matrix: np.ndarray) -> np.ndarray:
        """Vectorized index_for over rows of [N, F] -> [N] int64."""
        n = matrix.shape[0]
        if self.num_hashes == 0:
            return np.zeros(n, dtype=np.int64)
        bits = (matrix.astype(np.float32) @ self.hash_vectors.T) > 0.0
        return bits @ (1 << np.arange(self.num_hashes, dtype=np.int64))

    def candidate_indices(self, vector: np.ndarray) -> np.ndarray:
        """All partition indices within max_bits_differing of the query's
        (LocalitySensitiveHash.java:156-177)."""
        main = self.index_for(vector)
        if self.max_bits_differing == self.num_hashes:
            return np.arange(self.num_partitions, dtype=np.int64)
        how_many = int(self._prefix_for_bits[self.max_bits_differing])
        return self._by_popcount[:how_many] ^ main


def measured_topn_recall(
    got_ids, query_vec: np.ndarray, mat: np.ndarray, ids, k: int
) -> float:
    """|got ∩ exact top-k| / k for ONE query: the exact top-k is rescored
    from the full matrix, so an LSH (or any approximate) answer's recall
    is MEASURED, never assumed from a sample-rate or recall-target knob.
    Used by the bench's LSH HTTP stage to exactly rescore a sample of its
    own responses (mirrors the reference's eval of hash sampling)."""
    scores = mat @ np.asarray(query_vec, dtype=np.float32)
    kk = min(k, scores.shape[0])
    top = np.argpartition(-scores, kk - 1)[:kk]
    top = top[np.argsort(-scores[top], kind="stable")]
    exact = {ids[int(j)] for j in top}
    return len(set(got_ids) & exact) / max(1, kk)
