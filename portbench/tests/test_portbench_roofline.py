"""The Pines kernel's least time counts the same work whatever implements it."""

import pytest

from pbench import roofline


@pytest.mark.parametrize("degree, ops, coeff_bytes", [(21, 8976, 1920), (70, 84730, 20148)])
def test_counts_pinned(degree, ops, coeff_bytes):
    assert roofline.pines_ops_per_lane(degree, degree) == ops
    assert roofline.pines_coefficient_bytes(degree, degree) == coeff_bytes


def test_bound_at_ten_thousand_lanes():
    # operations bound both fields; 2.68 us and 25.3 us at 10,000 lanes
    t21, by21 = roofline.pines_bound_s(10_000, 21, 21)
    t70, by70 = roofline.pines_bound_s(10_000, 70, 70)
    assert by21 == by70 == "operations"
    assert t21 == pytest.approx(2.679e-6, rel=1e-3)
    assert t70 == pytest.approx(25.29e-6, rel=1e-3)


def test_bytes_bind_one_lane():
    t, by = roofline.pines_bound_s(1, 70, 70)
    assert by == "bytes" and t == pytest.approx((24 + 20148) / roofline.HBM_BYTES_PER_S)
