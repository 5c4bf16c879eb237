"""The port's math tier: hand-written CUDA kernels for the serving top-k
(``topk``), torch ops for the trainers and the vector primitives below."""

from oryx_tpu_torch.ops.vector import (
    cosine_similarity,
    dot,
    gram,
    norm,
    random_unit_vectors,
)
