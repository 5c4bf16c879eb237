"""The Gram matrix on tensors (the port's counterpart of ``gram`` in
oryx_tpu/ops/vector.py; its other helpers have no caller in the port).

The reference's VectorMath.transposeTimesSelf (framework/oryx-common
.../math/VectorMath.java) — the Gram matrix X^T.X that ALS needs every
half-iteration — is one product in full f32: on the card with TF32 off
(``full_f32``), as the JAX package asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_f32():
    """f32 products stay full f32 on the card: TF32 off for the block,
    restored afterwards (the JAX package's ``Precision.HIGHEST``)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def gram(x):
    """X^T.X in f32 (bf16 inputs upcast first)."""
    x = x.float()
    with full_f32():
        return x.T @ x

