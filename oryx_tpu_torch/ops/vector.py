"""Vector and matrix primitives on tensors (the port of
oryx_tpu/ops/vector.py).

The reference's VectorMath (framework/oryx-common .../math/VectorMath.java:
37-129: dot, norm, cosineSimilarity, transposeTimesSelf, randomVectorF).
transposeTimesSelf — the Gram matrix X^T.X that ALS needs every
half-iteration — is one product in full f32: on the card with TF32 off
(``full_f32``), as the JAX package asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.device import resolve_device


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


def dot(x, y):
    """The dot product of two vectors (both flattened)."""
    return torch.dot(x.reshape(-1), y.reshape(-1))


def norm(x):
    """The Euclidean norm of ``x`` (all its entries)."""
    return torch.linalg.vector_norm(x)


def cosine_similarity(x, y, norm_y=None):
    """dot(x, y) / (|x| |y|), with ``norm_y`` standing in for |y| where
    the caller has it already."""
    ny = norm(y) if norm_y is None else norm_y
    return dot(x, y) / (norm(x) * ny)


def gram(x):
    """X^T.X in f32 (bf16 inputs upcast first)."""
    x = x.float()
    with full_f32():
        return x.T @ x


def random_unit_vectors(n: int, dim: int, generator=None, device=None):
    """n random unit-norm f32 rows (VectorMath.randomVectorF +
    normalization), drawn on ``device`` (the card unless the caller asks
    for the CPU) from ``generator``, by default the next one of
    ``RandomManager`` (deterministic under its test seed)."""
    device = resolve_device(device)
    if generator is None:
        generator = RandomManager.get_generator(device)
    v = torch.randn((n, dim), generator=generator, device=device)
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
