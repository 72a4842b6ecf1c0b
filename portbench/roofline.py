"""The card's published peaks and, for each of the program's kernels, the
bytes and operations a call needs as a function of its shapes (a copy of
``chip_smoke.py``'s ``bound_ms`` arithmetic, in seconds).

Peaks: NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM, 67
TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32. Each input
byte is counted read once and each output byte written once.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 495e12


def bound_s(nbytes: float, flops: float, peak: float = PEAK_F32_S):
    """(least seconds, what bounds it): the bytes over the memory rate, or
    the operations over the peak rate of the unit that does them,
    whichever is larger."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def chol_inv_bound_s(B: int, m: int):
    """The chol-inv kernel on B instances of m × m: K read and L⁻¹
    written in full (f32); ⅔m³ operations an instance (Cholesky m³/3,
    triangular inverse m³/3)."""
    return bound_s(2 * B * m * m * 4, B * 2 * m ** 3 / 3)


def fused_solve_bound_s(B: int, m: int, n: int, refine: int):
    """The fused K1 solve: A, the lower triangle of L⁻¹ and the five input
    vectors read, dx and dy written; the products' multiply-adds and the
    elementwise steps."""
    nbytes = B * (m * n + m * (m + 1) // 2 + 3 * n + 2 * m + n + m) * 4
    base = 4 * m * n + 2 * m * (m + 1) + 3 * n + m
    sweep = 2 * m * n + 5 * n + 4 * m
    return bound_s(nbytes, B * ((1 + refine) * base + refine * sweep))


def scaled_gram_bound_s(B: int, m: int, n: int):
    """The scaled Gram kernel K = A·diag(d)·Aᵀ: A and d read, K written;
    the lower half m(m+1)n of 2m²n operations, three times over (three
    TF32 products make each f32 product), at the TF32 rate."""
    return bound_s(B * (m * n + n + m * m) * 4, 3 * B * m * (m + 1) * n,
                   PEAK_TF32_S)
