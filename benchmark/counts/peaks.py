"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, 700 W),
and the least time of some work on it."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
PEAK = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}


def least_s(n_bytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0) -> float:
    """Seconds: the larger of the bytes over the memory rate and the slower
    of the bf16 products on the tensor cores and the f32 work on the CUDA
    cores (the two run side by side)."""
    return max(n_bytes / HBM_BYTES_PER_S, bf16_ops / BF16_FLOPS, f32_ops / F32_FLOPS)


def product_s(products) -> float:
    """Seconds of products [(flops, precision)] each at its precision's peak."""
    return sum(f / PEAK[p] for f, p in products)
