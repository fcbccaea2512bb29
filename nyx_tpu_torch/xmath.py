"""Angle reduction and small vector helpers on torch tensors.

Port of nyx_tpu/xmath.py: `reduce_rad`, `reduce_deg` and
`linear_angle_deg` keep periodic arguments small BEFORE any trig call, in
exact arithmetic, so rotation angles stay accurate decades from J2000; the
vector helpers (`unit`, `tilde_matrix`, `rotv`, `projv`) and `gauss_solve`
work on tensors of any leading shape and keep their device. `LastCall`
shares one EOM call's lookups between the models of that call.
`FORWARD_AD` is held across every forward-mode AD section: torch keeps
forward-mode AD process-wide (one dual level at a time, whatever the
thread), so threads (a mesh's shards) take turns there.
"""

from __future__ import annotations

import math
import threading

import torch

PI = 3.141592653589793
TWO_PI = 6.283185307179586
DEG2RAD = PI / 180.0
RAD2DEG = 180.0 / PI

# 2*pi split into three parts (24-bit chunks): k*TWO_PI_A and k*TWO_PI_B are
# exact for |k| < 2^24, so Cody-Waite reduction holds to ~|x|*2^-48.
TWO_PI_A = 6.283185303211212
TWO_PI_B = 3.968374073792802e-09
TWO_PI_C = 2.4492935982947064e-16

# Held across each forward-mode AD section (re-entrant: sections nest).
FORWARD_AD = threading.RLock()


def reduce_rad(x):
    """x mod 2pi, into [-pi, pi], via three-part Cody-Waite reduction."""
    k = torch.round(x * (1.0 / TWO_PI))
    return ((x - k * TWO_PI_A) - k * TWO_PI_B) - k * TWO_PI_C


def reduce_deg(x):
    """x mod 360 into [-180, 180] (exact: 360*k is exact for |k| < 2^45)."""
    k = torch.round(x * (1.0 / 360.0))
    return x - k * 360.0


def sin_rad(x):
    return torch.sin(reduce_rad(x))


def cos_rad(x):
    return torch.cos(reduce_rad(x))


def sin_deg(x):
    return torch.sin(reduce_deg(x) * DEG2RAD)


def cos_deg(x):
    return torch.cos(reduce_deg(x) * DEG2RAD)


def sincos_deg(x):
    r = reduce_deg(x) * DEG2RAD
    return torch.sin(r), torch.cos(r)


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


def norm(x, axis: int = -1, keepdim: bool = False):
    """Euclidean norm over `axis` (the last by default)."""
    return torch.sqrt(torch.sum(x * x, dim=axis, keepdim=keepdim))


def unit(x, axis: int = -1):
    return x / torch.linalg.norm(x, dim=axis, keepdim=True)


def tilde_matrix(v):
    """Skew-symmetric cross-product matrix [..., 3, 3] such that
    tilde(a) @ b == a x b (utils.rs tilde_matrix)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def rotv(v, axis, theta_rad):
    """Rodrigues rotation of `v` about unit `axis` by `theta` (utils.rs
    rotv). Batched over leading dims."""
    k = unit(axis)
    c = torch.cos(theta_rad)[..., None]
    s = torch.sin(theta_rad)[..., None]
    kxv = torch.linalg.cross(torch.broadcast_to(k, v.shape), v)
    kdv = torch.sum(k * v, dim=-1, keepdim=True)
    return v * c + kxv * s + k * kdv * (1.0 - c)


def projv(a, b):
    """Projection of `a` onto `b` (utils.rs projv)."""
    bb = torch.sum(b * b, dim=-1, keepdim=True)
    return b * torch.sum(a * b, dim=-1, keepdim=True) / bb


def gauss_solve(m, rhs):
    """Batched dense linear solve by Gaussian elimination with partial
    pivoting: `m` [..., n, n], `rhs` [..., n, k] -> [..., n, k].

    The reference wrote it because its TPU backend has no float64 LU; it is
    kept for its callers, step for step the reference's (each row swap a
    permutation product, then back substitution), so the two round alike.
    """
    n = m.shape[-1]
    a = torch.cat([m, rhs], dim=-1)  # [..., n, n+k]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    idx = torch.arange(n, device=m.device)
    for col in range(n):
        # partial pivot: strongest remaining row for this column
        colv = torch.abs(a[..., :, col])
        piv = torch.argmax(torch.where(idx >= col, colv, torch.full_like(colv, -1.0)), dim=-1)
        e_p = (piv[..., None, None] == idx).to(m.dtype)
        e_c = eye[col][(None,) * (a.dim() - 2) + (None, slice(None))]
        perm = (torch.broadcast_to(eye, a.shape[:-2] + (n, n))
                - e_c * e_c.transpose(-1, -2) - e_p * e_p.transpose(-1, -2)
                + e_p * e_c.transpose(-1, -2) + e_c * e_p.transpose(-1, -2))
        a = perm @ a
        pivval = a[..., col:col + 1, col:col + 1]
        factors = a[..., col + 1:, col:col + 1] / pivval
        a = torch.cat([a[..., :col + 1, :], a[..., col + 1:, :] - factors * a[..., col:col + 1, :]],
                      dim=-2)
    # back substitution
    rows = [None] * n
    for col in range(n - 1, -1, -1):
        acc = a[..., col, n:]
        if col < n - 1:
            x_below = torch.stack(rows[col + 1:], dim=-2)
            acc = acc - torch.einsum("...j,...jk->...k", a[..., col, col + 1:n], x_below)
        rows[col] = acc / a[..., col, col:col + 1]
    return torch.stack(rows, dim=-2)


class LastCall:
    """The last value of a function of an epoch tensor `t`, per key, reused
    while the same tensor object comes back unmodified.

    The models of one EOM call share its epochs' tensor, so they share, by
    this, the body-fixed rotation and the ephemeris lookups that each would
    compute again (each torch operation is a kernel launch from the host).
    A new tensor, or one written in place since, recomputes. Each host
    thread keeps its own values, so the shards of a mesh, one thread each,
    do not evict each other's."""

    def __init__(self):
        self._local = threading.local()

    @property
    def _last(self) -> dict:
        d = getattr(self._local, "last", None)
        if d is None:
            d = self._local.last = {}
        return d

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
