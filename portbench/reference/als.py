"""Plain reference of implicit ALS (Hu, Koren and Volinsky, 2008): the
same sweeps as the program's ``train_als`` from the same interactions
and the same initial item factors, written out directly.

Each side's lists keep at most ``cap`` interactions a row, those of the
largest |value| first, ties in the order the interactions were given (the
program's stated truncation rule). A row's system is

    A = F'F + F_u' diag(alpha r) F_u + lambda I,   b = F_u' ((1 + alpha r) p)

with F the fixed side's factors, F_u its rows that the row interacted
with and p = 1 where r > 0. Rows are solved in groups of similar length,
padded with zero rows, by a Cholesky factorization. Rows with no
interactions solve to zero.

The reference works in float64. ``tf32=True`` runs it in float32 with
TF32 products instead: the precision below the configuration's float32
with TF32 off, which is the control.
"""

from __future__ import annotations

import numpy as np
import torch

ELEMENTS = 1 << 26  # gathered elements a group holds at most


def side_lists(entity, other, values, n_entities: int, cap: int, device):
    """(entity, other, value) sorted by entity, each entity's entries by
    descending |value| in input order among ties, cut to ``cap``; and the
    kept count per entity."""
    e = torch.as_tensor(np.asarray(entity, dtype=np.int64), device=device)
    o = torch.as_tensor(np.asarray(other, dtype=np.int64), device=device)
    v = torch.as_tensor(np.asarray(values, dtype=np.float64), device=device)
    order = torch.sort(-v.abs(), stable=True).indices
    order = order[torch.sort(e[order], stable=True).indices]
    e, o, v = e[order], o[order], v[order]
    counts = torch.bincount(e, minlength=n_entities)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e.numel(), device=device) - starts[e]
    keep = rank < cap
    return e[keep], o[keep], v[keep], torch.clamp(counts, max=cap)


class Side:
    """One side's kept lists, grouped for solving: rows sorted by length,
    cut into groups whose padded gather fits ``ELEMENTS``."""

    def __init__(self, lists, n_entities: int, features: int):
        e, o, v, counts = lists
        self.n = n_entities
        device = e.device
        offsets = torch.cumsum(counts, 0) - counts
        rows = torch.sort(counts, descending=True, stable=True).indices
        rows = rows[counts[rows] > 0]
        lens = counts[rows].tolist()
        self.groups = []
        lo = 0
        while lo < len(rows):
            p = lens[lo]
            size = max(1, ELEMENTS // (p * features))
            hi = min(len(rows), lo + size)
            g_rows = rows[lo:hi]
            pos = torch.arange(p, device=device)
            valid = pos[None, :] < counts[g_rows][:, None]
            at = torch.where(valid, offsets[g_rows][:, None] + pos[None, :], 0)
            self.groups.append((g_rows, torch.where(valid, o[at], -1), torch.where(valid, v[at], 0.0)))
            lo = hi


def half_sweep(fixed: torch.Tensor, side: Side, lam: float, alpha: float,
               strict: bool = True) -> torch.Tensor:
    """Solve every row of ``side`` against the fixed factors. ``strict``
    raises where a system cannot be factored; otherwise its row comes out
    non-finite."""
    k = fixed.shape[1]
    dt = fixed.dtype
    gram = fixed.T @ fixed
    eye = torch.eye(k, dtype=dt, device=fixed.device)
    padded = torch.cat([fixed, torch.zeros((1, k), dtype=dt, device=fixed.device)])
    out = torch.zeros((side.n, k), dtype=dt, device=fixed.device)
    for rows, other, val in side.groups:
        fu = padded[other]  # [g, p, k]; -1 picks the zero row
        w = (alpha * val).to(dt)
        pref = (val > 0).to(dt)
        a = gram[None] + fu.transpose(1, 2) @ (fu * w[:, :, None]) + lam * eye[None]
        b = (fu.transpose(1, 2) @ ((1.0 + w) * pref)[:, :, None])
        chol, info = torch.linalg.cholesky_ex(a)
        if strict and bool((info != 0).any()):
            raise RuntimeError("a reference system is not positive definite")
        out[rows] = torch.cholesky_solve(b, chol)[:, :, 0]
    return out


def train(users, items, values, n_users: int, n_items: int, y0: np.ndarray, *,
          lam: float, alpha: float, sweeps: int, cap: int, device,
          tf32: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(X, Y) after ``sweeps`` sweeps from ``y0``: float64, or with
    ``tf32`` float32 with TF32 products."""
    k = y0.shape[1]
    dt = torch.float32 if tf32 else torch.float64
    u = Side(side_lists(users, items, values, n_users, cap, device), n_users, k)
    i = Side(side_lists(items, users, values, n_items, cap, device), n_items, k)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        y = torch.as_tensor(np.asarray(y0), device=device).to(dt)
        x = torch.zeros((n_users, k), dtype=dt, device=device)
        for _ in range(sweeps):
            x = half_sweep(y, u, lam, alpha, strict=not tf32)
            y = half_sweep(x, i, lam, alpha, strict=not tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return x, y


def _f64(t, device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    return t.to(device=device, dtype=torch.float64)


def judge(x, y, x_ref: torch.Tensor, y_ref: torch.Tensor, rows: int = 2048) -> dict:
    """The numbers compared: ``factor_err``, the larger of the two tables'
    relative Frobenius distances from the reference; ``score_err``, the
    relative Frobenius distance of the whole score matrix X Y' from the
    reference's, which a rotation of the factors that leaves every score
    unchanged does not move. Both are infinite where the program's tables
    hold a non-finite value or have the wrong shape."""
    dev = x_ref.device
    got = [_f64(x, dev), _f64(y, dev)]
    ref = [x_ref.to(torch.float64), y_ref.to(torch.float64)]
    if any(g.shape != r.shape or not bool(torch.isfinite(g).all()) for g, r in zip(got, ref)):
        return {"factor_err": float("inf"), "score_err": float("inf")}
    factor = max(float(torch.linalg.norm(g - r) / torch.linalg.norm(r)) for g, r in zip(got, ref))
    num = den = 0.0
    for lo in range(0, ref[0].shape[0], rows):
        pr = ref[0][lo:lo + rows] @ ref[1].T
        num += float(((got[0][lo:lo + rows] @ got[1].T - pr) ** 2).sum())
        den += float((pr ** 2).sum())
    return {"factor_err": factor, "score_err": (num / den) ** 0.5 if den else float("inf")}
