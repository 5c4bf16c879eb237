"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W power limit). A run prints the
card's own power limit beside its result."""

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bfloat16_flops": 989e12,
    "int8_ops": 1979e12,
    "tf32_flops": 495e12,
    "float32_flops": 67e12,
    "float64_flops": 67e12,
}
