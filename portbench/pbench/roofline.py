"""The card's published peaks and the least time of the Pines gravity kernel.

Frozen copies of `chip_smoke.py`'s peaks and `pines_ops_per_lane`, the
operations counted from the field's shape alone. The bytes term reads each
lane's position and writes its acceleration once, and the field's
coefficients once: C for every (n, m) of the degrees the kernel sums and S
for m > 0, four bytes each, whatever table layout or padding a kernel
chooses to stage them in.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the 700 W power limit: 67 TFLOP/s of f32
# counts a fused multiply-add as two operations; the kernel is built
# without contraction, so each of its operations is one instruction at half
# that. HBM3 at 3.35 TB/s.
F32_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12


def pines_ops_per_lane(degree: int, order: int, q_lo: int = 0) -> int:
    """f32 operations one lane needs for degrees (q_lo, degree] of a
    degree x order field, counted from the recursion: at degree step k
    (k = 0 .. degree - 1) only orders m <= k + 2 of the order + 2 columns are
    nonzero; each takes 7 operations for its Legendre row and, where the
    degree accumulates, 25 for d, e, f and the four sums; then the powers
    (6 a column), the order sums (4 a column), the prelude and the final
    combination (~20)."""
    width = order + 2
    cols = [min(k + 3, width) for k in range(degree)]
    accumulated = sum(c for k, c in enumerate(cols) if k + 1 > q_lo)
    return 7 * sum(cols) + 25 * accumulated + 10 * (width - 1) + 20


def pines_coefficient_bytes(degree: int, order: int, q_lo: int = 0) -> int:
    """Bytes of the f32 coefficients of degrees max(q_lo + 1, 2) .. degree:
    C for m = 0 .. min(n, order), S for m = 1 .. min(n, order)."""
    count = 0
    for n in range(max(q_lo + 1, 2), degree + 1):
        m = min(n, order)
        count += (m + 1) + m
    return 4 * count


def pines_bound_s(lanes: int, degree: int, order: int, q_lo: int = 0) -> tuple[float, str]:
    """The least time one call over `lanes` lanes could take on the card,
    and which of its two terms bounds it."""
    ops_s = lanes * pines_ops_per_lane(degree, order, q_lo) / F32_OPS_PER_S
    bytes_s = (24 * lanes + pines_coefficient_bytes(degree, order, q_lo)) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"
