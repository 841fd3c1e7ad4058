# Frozen copy of chip_smoke.py's bound arithmetic at commit bc3af59 (the
# constants beside CAPS / HYPOTHESES, time_searches' K1 bytes bound and
# time_k2's operations bound), with the H100's bf16 peak beside them.
"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W power limit) and the work counts of kernels K1 and K2."""

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
# H100 SXM float32 outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two operations, so 3.35e13 instructions a second; K2's
# subtractions, products and sums cannot fuse and count one each
FP32_OPS_PER_S = 3.35e13
K2_OPS_PER_PAIR = 8              # 3 subtractions, 3 products, 2 sums
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak


def k1_bound_s(nbytes: float) -> float:
    """K1's least time: each support, query and result byte moved once
    (``(2 * G * C + S) * 4 * B`` bytes a search)."""
    return nbytes / HBM_BYTES_PER_S


def k2_bound_s(valid_pairs: float, nbytes: float) -> float:
    """K2's least time: the exact all-pairs search over the valid points,
    the larger of its operations and its bytes."""
    return max(valid_pairs * K2_OPS_PER_PAIR / FP32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)


def mfu_percent(flops: float, seconds: float) -> float:
    """A step's share of the bf16 peak, in percent."""
    return 100.0 * flops / seconds / BF16_FLOPS_PER_S
