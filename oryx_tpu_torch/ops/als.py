"""ALS scoring and incremental fold-in (the port's counterpart of
oryx_tpu/ops/als.py:1609-1842; training waits for the next slice).

- Fold-in mirrors ALSUtils.computeTargetQui / computeUpdatedXu
  (app/oryx-app-common .../als/ALSUtils.java:37-106): interpolate the
  predicted strength toward 1/0 by the interaction strength, then solve
  (Y^T.Y) dXu = dQui.Yi against the cached Cholesky factor -- batched
  triangular solves over a whole micro-batch.
- Scoring: ``topk_dot_batch`` routes exact and quantized requests with
  k <= 128 to the fused kernel (ops/topk.py) -- on a CUDA tensor it
  launches the hand-written kernel or raises, never anything else. k > 128
  and approx mode go through one plain large product and a stable sort, as
  the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from oryx_tpu_torch.ops.topk import (
    _row_chunks,
    _scores,
    _stable_topk,
    quantize_queries,
    topk_dot_batch_cuda,
)
from oryx_tpu_torch.ops.transfer import QuantizedMatrix

# Largest k dispatched to the fused kernel. The serving micro-batcher
# derives a k bucket from this so default /recommend overfetch (k=18) stays
# on the fused path -- keep them coupled (serving/batcher.py K_BUCKETS).
PALLAS_TOPK_MAX_K = 128


# ---------------------------------------------------------------------------
# incremental fold-in (speed layer + anonymous serving estimates)
# ---------------------------------------------------------------------------

def compute_target_qui(value, current, *, implicit: bool):
    """Target predicted-strength after an interaction of ``value``.

    Implicit: interpolate from the current prediction toward 1 (positive
    value) or 0 (negative), fraction value/(1+value); NaN means "no change
    needed" (already out of range). Explicit: the value itself.
    Parity: ALSUtils.computeTargetQui (…/als/ALSUtils.java:37-60).
    """
    if not implicit:
        return value
    pos = (value > 0.0) & (current < 1.0)
    neg = (value < 0.0) & (current > 0.0)
    up = current + (value / (1.0 + value)) * (1.0 - torch.clamp(current, min=0.0))
    dn = current + (value / (value - 1.0)) * (-torch.clamp(current, max=1.0))
    nan = torch.full_like(current, float("nan"))
    return torch.where(pos, up, torch.where(neg, dn, nan))


def fold_in_batch(chol, values, xus, yis, *, implicit: bool = True):
    """Fold one interaction per row into user vectors: [N] values, [N, K]
    current vectors (all-zero = new user, whose current prediction counts
    as 0.5) and [N, K] item vectors against one [K, K] lower Cholesky
    factor of Y'Y. Returns the [N, K] updated vectors; a NaN target leaves
    its row unchanged. Parity: ALSUtils.computeUpdatedXu
    (…/als/ALSUtils.java:74-106), and the JAX package's vmapped
    ``fold_in_batch`` / ``fold_in_batch_explicit``."""
    had_xu = (xus != 0.0).any(dim=1)
    qui = torch.where(had_xu, (xus * yis).sum(dim=1), torch.zeros_like(values))
    current = torch.where(had_xu, qui, torch.full_like(qui, 0.5))
    target = compute_target_qui(values, current, implicit=implicit)
    dqui = torch.where(torch.isnan(target), torch.zeros_like(target), target - qui)
    rhs = (dqui[:, None] * yis)[:, :, None]
    lower = chol.expand(xus.shape[0], -1, -1)
    z = torch.linalg.solve_triangular(lower, rhs, upper=False)
    dxu = torch.linalg.solve_triangular(lower.transpose(-1, -2), z, upper=True)
    return xus + dxu[:, :, 0]


def compute_updated_xu(chol, value, xu, yi, *, implicit: bool):
    """``fold_in_batch`` for one interaction: [K] vector in, [K] out."""
    value = torch.as_tensor(value, dtype=xu.dtype, device=xu.device)
    return fold_in_batch(
        chol, value.reshape(1), xu[None, :], yi[None, :], implicit=implicit
    )[0]


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _plain_topk(xs, y, k: int, scales=None, sx=None):
    vals, idx = [], []
    for lo, hi in _row_chunks(xs.shape[0], y.shape[0]):
        s = _scores(xs[lo:hi], y, scales)
        if sx is not None:
            s = s * sx[lo:hi, None]
        v, i = _stable_topk(s, k)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def topk_dot_batch_xla(xs, y, *, k: int):
    """Batched plain top-k: one [B, I] product in f32 and a stable sort, in
    (value desc, index asc) order -- the counterpart of the JAX package's
    XLA form (matmul + lax.top_k)."""
    return _plain_topk(xs, y, k)


def topk_dot_batch_approx(xs, y, *, k: int, recall: float):
    """Approximate top-k at a recall target. ``jax.lax.approx_max_k``
    computes exactly off the TPU, and so does this: the exact plain form
    (recall is accepted for signature parity)."""
    del recall
    return _plain_topk(xs, y, k)


def topk_dot_batch_quant_xla(xs, q, scale, *, k: int, recall: float = 1.0):
    """Batched top-k over an int8 item matrix (q [I,F] int8, scale [I] f32):
    queries quantize per row as the kernel's do, the dot of the quantized
    values is exact in f32 (each sum stays below 2^24), and scores are
    (dot * scale) * sx, selected after both scales as in the JAX form.
    recall < 1 computes exactly (see topk_dot_batch_approx)."""
    del recall
    xq, sx = quantize_queries(xs)
    return _plain_topk(xq, q, k, scales=scale, sx=sx)


def topk_dot_batch(xs, y, *, k: int, recall: float = 1.0):
    """Batched top-k scoring. Exact requests with k <= PALLAS_TOPK_MAX_K go
    to the fused kernel wrapper (ops/topk.py), for both a bf16/f32 item
    matrix and a QuantizedMatrix: on a CUDA tensor that is always the
    hand-written kernel, and a failure raises -- there is no silent
    fallback. k > 128 and recall < 1 take the plain large product."""
    if isinstance(y, QuantizedMatrix):
        if recall >= 1.0 and k <= PALLAS_TOPK_MAX_K:
            return topk_dot_batch_cuda(xs, y.q, k=k, scales=y.scale)
        return topk_dot_batch_quant_xla(xs, y.q, y.scale, k=k, recall=recall)
    if xs.dtype != y.dtype:
        # mixed-precision queries score in the matrix's dtype (the bf16
        # serving view); accumulation is f32 either way
        xs = xs.to(y.dtype)
    if recall < 1.0:
        return topk_dot_batch_approx(xs, y, k=k, recall=float(recall))
    if k <= PALLAS_TOPK_MAX_K:
        return topk_dot_batch_cuda(xs, y, k=k)
    return topk_dot_batch_xla(xs, y, k=k)
