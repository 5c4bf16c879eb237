"""Operations and bytes of the top-k scoring kernels (``topk_dot_partial``
then ``topk_merge``) over ``dispatches`` dispatches that score ``rows``
query rows in all against an ``items`` x ``features`` view.

Operations: 2 * rows * items * features (a multiply and an add each).
Bytes: each input read once and each output written once: the view
(itemsize bytes an element, plus any per-row scale) once a dispatch, the
f32 queries, and the selected k (value f32 and index int32) a row.
Selection is not counted.
"""

# The view each serving score mode streams: bytes an element, bytes of a
# row's scale, and the peak (a key of peaks.py) its products run at.
VIEWS = {
    "exact": {"itemsize": 2, "row_scale_bytes": 0, "peak": "bfloat16_flops"},
    "quantized": {"itemsize": 1, "row_scale_bytes": 4, "peak": "int8_ops"},
}


def view(score_mode: str) -> dict:
    """The view of ``score_mode``; raises ValueError for a mode these
    counts do not know, rather than count it as another."""
    if score_mode not in VIEWS:
        raise ValueError(f"no top-k counts for score mode {score_mode!r}; known: {sorted(VIEWS)}")
    return VIEWS[score_mode]


def work(dispatches: int, rows: int, items: int, features: int, itemsize: int,
         k: int, row_scale_bytes: int = 0) -> tuple[float, float]:
    ops = 2.0 * rows * items * features
    n_bytes = (float(dispatches) * items * (features * itemsize + row_scale_bytes)
               + rows * features * 4.0 + rows * k * 8.0)
    return ops, n_bytes


def bound_s(ops: float, n_bytes: float, peak_ops: float, peak_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / peak_ops, n_bytes / peak_bytes)
