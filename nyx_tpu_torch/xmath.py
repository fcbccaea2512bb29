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


def linear_angle_deg(base_deg, rate_deg_per_day, d_days):
    """(base + rate * d) mod 360, accurate for large day counts.

    Splits both rate and day count into integer + fraction so every product
    stays exactly representable before the modulo. `base_deg` and
    `rate_deg_per_day` are numbers or tensors that broadcast against
    `d_days` (a series of angles at once).
    """
    d_i = torch.floor(d_days)
    d_f = d_days - d_i
    if isinstance(rate_deg_per_day, torch.Tensor):
        r_i = torch.floor(rate_deg_per_day)
    else:
        r_i = float(math.floor(rate_deg_per_day))
    r_f = rate_deg_per_day - r_i
    big = r_i * d_i
    big_mod = big - torch.round(big * (1.0 / 360.0)) * 360.0
    small = r_i * d_f + r_f * d_days + base_deg
    return reduce_deg(big_mod + small)


def norm(x, keepdim: bool = False):
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


class LastCall:
    """The last value of a function of an epoch tensor `t`, per key, reused
    while the same tensor object comes back unmodified.

    The models of one EOM call share its epochs' tensor, so they share, by
    this, the body-fixed rotation and the ephemeris lookups that each would
    compute again (each torch operation is a kernel launch from the host).
    A new tensor, or one written in place since, recomputes."""

    def __init__(self):
        self._last = {}

    def peek(self, key, t):
        """The value kept for `key` if it was computed from `t` as it is, else None."""
        hit = self._last.get(key)
        if hit is not None and hit[0] is t and hit[1] == getattr(t, "_version", None):
            return hit[2]
        return None

    def put(self, key, t, value):
        self._last[key] = (t, getattr(t, "_version", None), value)

    def get(self, key, t, fn):
        """The value kept for `key` and `t`, or fn() kept as it."""
        out = self.peek(key, t)
        if out is None:
            out = fn()
            self.put(key, t, out)
        return out
