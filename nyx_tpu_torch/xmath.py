"""Angle reduction and small vector helpers on torch tensors.

Port of the parts of nyx_tpu/xmath.py that the Monte Carlo path needs:
`reduce_deg` and `linear_angle_deg` keep periodic arguments small BEFORE
any trig call, in exact arithmetic, so rotation angles stay accurate
decades from J2000.
"""

from __future__ import annotations

import math

import torch


def reduce_deg(x):
    """x mod 360 into [-180, 180] (exact: 360*k is exact for |k| < 2^45)."""
    k = torch.round(x * (1.0 / 360.0))
    return x - k * 360.0


def linear_angle_deg(base_deg: float, rate_deg_per_day: float, d_days):
    """(base + rate * d) mod 360, accurate for large day counts.

    Splits both rate and day count into integer + fraction so every product
    stays exactly representable before the modulo.
    """
    d_i = torch.floor(d_days)
    d_f = d_days - d_i
    r_i = float(math.floor(rate_deg_per_day))
    r_f = rate_deg_per_day - r_i
    big = r_i * d_i
    big_mod = big - torch.round(big * (1.0 / 360.0)) * 360.0
    small = r_i * d_f + r_f * d_days + base_deg
    return reduce_deg(big_mod + small)


def norm(x, keepdim: bool = False):
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))
