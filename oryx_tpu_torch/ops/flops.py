"""Analytic FLOP accounting and the card's peak for MFU reporting (the
port's counterpart of oryx_tpu/ops/flops.py).

The FLOP counts are analytic lower bounds over the dominant matmul terms
only (top-k selection, masking and solves are excluded unless noted), so
a reported MFU slightly understates true utilization — never the reverse.
"""

from __future__ import annotations

# Dense peaks of an H100 SXM in FLOP/s (OP/s for int8), from NVIDIA's data
# sheet, at its full 700 W power limit. float32 runs on the CUDA cores
# (TF32 off). Keyed by substrings of torch.cuda.get_device_name(); the
# SXM part reports itself as "NVIDIA H100 80GB HBM3".
_PEAKS = {
    ("H100", "HBM3"): {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12},
    ("H100", "SXM"): {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12},
}


def normalize_dtype(dtype: str) -> str:
    """Canonical dtype tag for peak lookup: int8 / bfloat16 / float32.
    Unrecognized tags conservatively map to bfloat16 (the serving
    default), never to the higher int8 peak."""
    d = str(dtype).lower()
    if d in ("int8", "i8", "s8"):
        return "int8"
    if d in ("float32", "f32"):
        return "float32"
    return "bfloat16"


def peak_flops_for_name(device_name: str, dtype: str = "bfloat16") -> float | None:
    """Dense peak FLOP/s of the card named ``device_name`` at ``dtype``, or
    None for a card this table does not know (MFU is then omitted rather
    than guessed)."""
    for parts, peaks in _PEAKS.items():
        if all(p in device_name for p in parts):
            return peaks[normalize_dtype(dtype)]
    return None


def device_peak_flops(dtype: str = "bfloat16") -> float | None:
    """Peak FLOP/s of CUDA card 0; None without a card or for a card the
    table does not know."""
    import torch

    if not torch.cuda.is_available():
        return None
    return peak_flops_for_name(torch.cuda.get_device_name(0), dtype)


def topk_score_flops(n_queries: int, n_items: int, features: int) -> float:
    """FLOPs for exact top-k scoring: one [B,F]x[F,I] matmul = 2·B·I·F
    (selection excluded)."""
    return 2.0 * n_queries * n_items * features


def als_halfstep_flops(n_rows: int, pad_width: int, k: int, n_fixed: int) -> float:
    """Analytic FLOPs for one ALS half-sweep over n_rows padded lists of
    width pad_width against k features (ops/als.py _half_step): the
    normal-equation product 2·B·P·K² + the RHS product 2·B·P·K, plus the
    fixed side's gram 2·M·K². Cholesky/solves (O(B·K³/3)) excluded."""
    return (
        2.0 * n_rows * pad_width * k * k
        + 2.0 * n_rows * pad_width * k
        + 2.0 * n_fixed * k * k
    )


def mfu(achieved_flops_per_s: float, peak: float | None) -> float | None:
    """Model FLOPs Utilization in [0,1], or None when no peak is known."""
    if not peak or peak <= 0:
        return None
    return achieved_flops_per_s / peak
