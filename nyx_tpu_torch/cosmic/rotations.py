"""Inertial <-> body-fixed orientation (torch port of nyx_tpu/cosmic/rotations.py).

The IAU Earth model as a function of TDB seconds past J2000 returning a
3x3 DCM per lane, plus the elementwise DCM products. Every function runs at
the dtype and on the device of its input tensor.
"""

from __future__ import annotations

import math

import torch

from ..xmath import linear_angle_deg, reduce_deg

_D2R = math.pi / 180.0
_DAYS_PER_CENTURY = 36_525.0


def dcm_from_euler_ra_dec_w(alpha_deg, delta_deg, w_deg):
    """ICRF -> body-fixed DCM from IAU (RA, DEC, prime meridian) angles.

    The 3-1-3 composition R3(w) R1(pi/2-delta) R3(pi/2+alpha) is expanded
    in closed form, angles reduced mod 360 before the trig calls.
    """
    alpha = reduce_deg(alpha_deg) * _D2R
    delta = reduce_deg(delta_deg) * _D2R
    w = reduce_deg(w_deg) * _D2R
    b = math.pi / 2 - delta
    c = math.pi / 2 + alpha
    cw, sw = torch.cos(w), torch.sin(w)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    m00, m01, m02 = cc, sc, torch.zeros_like(cc)
    m10, m11, m12 = -cb * sc, cb * cc, sb
    m20, m21, m22 = sb * sc, -sb * cc, cb
    return torch.stack(
        [
            torch.stack([cw * m00 + sw * m10, cw * m01 + sw * m11, cw * m02 + sw * m12], -1),
            torch.stack([-sw * m00 + cw * m10, -sw * m01 + cw * m11, -sw * m02 + cw * m12], -1),
            torch.stack([m20, m21, m22], -1),
        ],
        -2,
    )


def iau_earth_angles(t_tdb_s):
    """IAU_EARTH orientation angles (deg) at TDB seconds past J2000."""
    d = t_tdb_s / 86_400.0
    T = d / _DAYS_PER_CENTURY
    alpha = 0.0 - 0.641 * T
    delta = 90.0 - 0.557 * T
    w = linear_angle_deg(190.147, 360.985_623_5, d)
    return alpha, delta, w


def iau_earth_dcm(t_tdb_s):
    """J2000 -> IAU_EARTH body-fixed DCM."""
    a, de, w = iau_earth_angles(t_tdb_s)
    return dcm_from_euler_ra_dec_w(a, de, w)


def iau_earth_dcm32_pole(t_tdb_s):
    """(dcm_f32 [..,3,3], pole_f64 [..,3]) for the split-precision gravity
    rotation (Harmonics.accel, precision="split").

    The pole row stays f64 (it feeds the closed-form J2/J3) and depends
    only on the slow precession angles, so small-angle polynomials give it
    with no transcendental. The fast angle w only enters rows 0/1, which
    feed the f32 field evaluation: f64 angle reduction, then f32 trig.
    `t_tdb_s` is an f64 tensor.
    """
    d = t_tdb_s / 86_400.0
    T = d / _DAYS_PER_CENTURY
    a = -0.641 * T * _D2R
    b = 0.557 * T * _D2R
    a2 = a * a
    b2 = b * b
    sb = b * (1.0 - b2 * (1.0 / 6.0))
    cb = 1.0 - b2 * 0.5 * (1.0 - b2 * (1.0 / 12.0))
    # c = pi/2 + alpha: sin(c) = cos(alpha), cos(c) = -sin(alpha)
    sc = 1.0 - a2 * 0.5 * (1.0 - a2 * (1.0 / 12.0))
    cc = -(a * (1.0 - a2 * (1.0 / 6.0)))
    pole = torch.stack([sb * sc, -sb * cc, cb], -1)

    f32 = torch.float32
    w32 = (linear_angle_deg(190.147, 360.985_623_5, d) * _D2R).to(f32)
    cw, sw = torch.cos(w32), torch.sin(w32)
    cb32, sb32 = cb.to(f32), sb.to(f32)
    cc32, sc32 = cc.to(f32), sc.to(f32)
    m00, m01 = cc32, sc32
    m10, m11, m12 = -cb32 * sc32, cb32 * cc32, sb32
    row0 = torch.stack([cw * m00 + sw * m10, cw * m01 + sw * m11, sw * m12], -1)
    row1 = torch.stack([-sw * m00 + cw * m10, -sw * m01 + cw * m11, cw * m12], -1)
    dcm32 = torch.stack([row0, row1, pole.to(f32)], -2)
    return dcm32, pole


def apply_dcm(dcm, v):
    """dcm [...,3,3] @ v [...,3], expanded elementwise."""
    return torch.stack(
        [
            dcm[..., 0, 0] * v[..., 0] + dcm[..., 0, 1] * v[..., 1] + dcm[..., 0, 2] * v[..., 2],
            dcm[..., 1, 0] * v[..., 0] + dcm[..., 1, 1] * v[..., 1] + dcm[..., 1, 2] * v[..., 2],
            dcm[..., 2, 0] * v[..., 0] + dcm[..., 2, 1] * v[..., 1] + dcm[..., 2, 2] * v[..., 2],
        ],
        -1,
    )


def apply_dcm_t(dcm, v):
    """dcm^T [...,3,3] @ v [...,3], expanded elementwise."""
    return torch.stack(
        [
            dcm[..., 0, 0] * v[..., 0] + dcm[..., 1, 0] * v[..., 1] + dcm[..., 2, 0] * v[..., 2],
            dcm[..., 0, 1] * v[..., 0] + dcm[..., 1, 1] * v[..., 1] + dcm[..., 2, 1] * v[..., 2],
            dcm[..., 0, 2] * v[..., 0] + dcm[..., 1, 2] * v[..., 1] + dcm[..., 2, 2] * v[..., 2],
        ],
        -1,
    )
