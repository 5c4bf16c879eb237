"""Linear-system solves with singularity detection (the port's counterpart
of oryx_tpu/ops/solver.py).

The reference factors Y^T.Y once (RRQR with a rank check) and reuses the
factorization for many right-hand sides (LinearSystemSolver.getSolver,
framework/oryx-common .../math/LinearSystemSolver.java:38-80; Solver.java:
31-48), raising on singular systems. Here: the Cholesky factor of the
(symmetric PSD) Gram matrix, cached; solves are batched triangular solves.

``torch.linalg.cholesky_ex`` reports a failed factorization through
``info``; the partial factor it leaves is finite on the CPU (XLA's Cholesky
returns NaN), so every check here reads ``info`` as well as finiteness.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.vector import full_f32


class SingularMatrixError(Exception):
    """Raised when the system is singular/ill-conditioned
    (reference SingularMatrixSolverException)."""


_MAX_COND = 1e10


def _chol_solve(chol, b):
    """Solve (L L^T) x = b for b [K] or [K, N]."""
    with full_f32():
        y = torch.linalg.solve_triangular(chol, b.float(), upper=False)
        return torch.linalg.solve_triangular(chol.T, y, upper=True)


@dataclass(frozen=True)
class Solver:
    """A factored SPD system; solve() accepts one RHS vector or a batch
    ([N, K] rows)."""

    chol: torch.Tensor

    def solve(self, b):
        b = torch.as_tensor(b, dtype=torch.float32, device=self.chol.device)
        if b.ndim == 1:
            return _chol_solve(self.chol, b[:, None])[:, 0]
        return _chol_solve(self.chol, b.T).T

    def solve_f(self, b) -> np.ndarray:
        return self.solve(b).cpu().numpy().astype(np.float32)


def make_solver(packed_or_full, device=None) -> Solver:
    """Factor an SPD matrix (e.g. Y^T.Y) on ``device`` (the card unless
    the caller names the CPU). Accepts the full [K,K] matrix or the packed
    lower-triangular row-major form the reference passes around
    (LinearSystemSolver.java:38-56)."""
    a = np.asarray(packed_or_full, dtype=np.float32)
    if a.ndim == 1:
        # packed lower triangle -> full symmetric
        n = int((np.sqrt(8 * a.size + 1) - 1) / 2)
        if n * (n + 1) // 2 != a.size:
            raise ValueError(f"not a packed triangular size: {a.size}")
        full = np.zeros((n, n), dtype=np.float32)
        full[np.tril_indices(n)] = a
        full = full + np.tril(full, -1).T
        a = full
    dev = resolve_device(device)
    chol, info = torch.linalg.cholesky_ex(torch.from_numpy(a).to(dev))
    chol_np = chol.cpu().numpy()
    if int(info) != 0 or not np.all(np.isfinite(chol_np)):
        raise SingularMatrixError("Cholesky failed: matrix not positive definite")
    d = np.abs(np.diag(chol_np))
    if d.min() <= 0 or (d.max() / max(d.min(), 1e-30)) ** 2 > _MAX_COND:
        raise SingularMatrixError(
            f"ill-conditioned system (cond~{(d.max() / max(d.min(), 1e-30)) ** 2:.2e})"
        )
    return Solver(chol)


def batched_spd_solve_ex(a, b):
    """(x [N,K], ok [N]): x_i solves a_i x_i = b_i through the Cholesky
    factor, and ok is False where the factorization failed (``info``, or a
    non-finite factor). The caller keeps TF32 off (``full_f32``)."""
    chol, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0) & torch.isfinite(chol).all(dim=-1).all(dim=-1)
    y = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
    return x, ok


def batched_spd_solve(a, b):
    """Solve a_i x_i = b_i for a batch of small SPD systems [N,K,K],[N,K]
    (the per-user normal-equation solve at the heart of ALS). A system
    whose factorization fails solves to NaN, as XLA's does."""
    with full_f32():
        x, ok = batched_spd_solve_ex(a.float(), b.float())
    return torch.where(ok[:, None], x, torch.full_like(x, float("nan")))
