"""StateParameter: named scalar state queries (torch port of nyx_tpu/md/param.py).

The parameter names, the set of those in degrees and the default event
precisions are copied from the reference (md/param.py:20-104). `value`
evaluates every parameter of the reference's `value` (md/param.py:106-222)
on flat state tensors, the same formulas in float64, the Brouwer mean
short elements (`_brouwer_mean_short`, :234-) and the B-plane's B.R, B.T
and linearized time of flight included. Every branch is on the parameter's
name, never on a tensor's value, so `torch.func.jacfwd` traces `value`
(the targeter's dual Jacobian, `MvnSpacecraft`'s element dispersions).
"""

from __future__ import annotations

import math

import torch
from torch.linalg import vector_norm

from ..cosmic import orbit as om
from ..errors import StateError

_R2D = 180.0 / math.pi
_TWO_PI = 2 * math.pi
_SLOTS = {"x": 0, "y": 1, "z": 2, "vx": 3, "vy": 4, "vz": 5, "cr": 6, "cd": 7, "prop_mass": 8}


class StateParameter:
    SMA = "sma"
    ECC = "ecc"
    INC = "inc"
    RAAN = "raan"
    AOP = "aop"
    TA = "ta"
    EA = "ea"
    MA = "ma"
    RMAG = "rmag"
    VMAG = "vmag"
    X = "x"
    Y = "y"
    Z = "z"
    VX = "vx"
    VY = "vy"
    VZ = "vz"
    ENERGY = "energy"
    FPA = "fpa"
    DECLINATION = "declination"
    RIGHT_ASC = "right_asc"
    PERIAPSIS_RADIUS = "periapsis_radius"
    APOAPSIS_RADIUS = "apoapsis_radius"
    HEIGHT = "height"
    PERIAPSIS_HEIGHT = "periapsis_height"
    APOAPSIS_HEIGHT = "apoapsis_height"
    CR = "cr"
    CD = "cd"
    PROP_MASS = "prop_mass"
    HMAG = "hmag"
    C3 = "c3"
    PERIOD = "period"
    AOL = "aol"  # argument of latitude = aop + ta
    SEMI_PARAMETER = "semi_parameter"
    SEMI_MINOR_AXIS = "semi_minor_axis"
    TRUE_LONGITUDE = "true_longitude"
    VELOCITY_DECLINATION = "velocity_declination"
    HX = "hx"
    HY = "hy"
    HZ = "hz"
    HYPERBOLIC_ANOMALY = "hyperbolic_anomaly"
    EQUINOCTIAL_H = "equinoctial_h"
    EQUINOCTIAL_K = "equinoctial_k"
    EQUINOCTIAL_P = "equinoctial_p"
    EQUINOCTIAL_Q = "equinoctial_q"
    EQUINOCTIAL_LAMBDA = "equinoctial_lambda"
    BROUWER_MEAN_SHORT_SMA = "brouwer_mean_short_sma"
    BROUWER_MEAN_SHORT_ECC = "brouwer_mean_short_ecc"
    BROUWER_MEAN_SHORT_INC = "brouwer_mean_short_inc"
    BROUWER_MEAN_SHORT_RAAN = "brouwer_mean_short_raan"
    BROUWER_MEAN_SHORT_AOP = "brouwer_mean_short_aop"
    BROUWER_MEAN_SHORT_MA = "brouwer_mean_short_ma"
    BDOT_R = "bdot_r"  # hyperbolic B-plane B.R (km)
    BDOT_T = "bdot_t"  # hyperbolic B-plane B.T (km)
    B_LTOF = "b_ltof"  # linearized time of flight (s)
    # spacecraft-level parameters, evaluated by Spacecraft.value_of
    EPOCH = "epoch_tai_s"
    GUIDANCE_MODE = "guidance_mode"
    ISP = "isp_s"
    THRUST = "thrust_n"
    THRUST_X = "thrust_x"
    THRUST_Y = "thrust_y"
    THRUST_Z = "thrust_z"
    DRY_MASS = "dry_mass"
    TOTAL_MASS = "total_mass"

    # default event-finding precision per parameter (value units), mirroring
    # md/param.rs default_event_precision
    DEFAULT_PRECISION = {
        "sma": 1e-3, "ecc": 1e-5, "inc": 1e-3, "raan": 1e-3, "aop": 1e-3,
        "ta": 1e-3, "ea": 1e-3, "ma": 1e-3, "rmag": 1e-3, "vmag": 1e-6,
        "height": 1e-3, "declination": 1e-3, "fpa": 1e-3, "aol": 1e-3,
    }

    ANGLES_DEG = {
        "inc", "raan", "aop", "ta", "ea", "ma", "fpa", "declination",
        "right_asc", "aol", "true_longitude", "velocity_declination",
        "hyperbolic_anomaly", "equinoctial_lambda",
        "brouwer_mean_short_inc", "brouwer_mean_short_raan",
        "brouwer_mean_short_aop", "brouwer_mean_short_ma",
    }


def value(param: str, y, mu: float, radius_km: float = 0.0):
    """Evaluate a StateParameter on flat state tensors y [..., >=6]."""
    p = param.lower()
    if p in _SLOTS:
        return y[..., _SLOTS[p]]
    r = y[..., 0:3]
    v = y[..., 3:6]
    rmag = vector_norm(r, dim=-1)
    vmag = vector_norm(v, dim=-1)
    if p == "rmag":
        return rmag
    if p == "vmag":
        return vmag
    if p == "height":
        return rmag - radius_km
    if p == "energy":
        return vmag**2 / 2 - mu / rmag
    if p == "hmag":
        return vector_norm(torch.linalg.cross(r, v, dim=-1), dim=-1)
    if p == "declination":
        return torch.arcsin(r[..., 2] / rmag) * _R2D
    if p == "right_asc":
        return torch.remainder(torch.atan2(r[..., 1], r[..., 0]), _TWO_PI) * _R2D
    if p == "fpa":
        rdotv = torch.sum(r * v, dim=-1)
        return torch.arcsin(rdotv / (rmag * vmag)) * _R2D
    if p == "velocity_declination":
        return torch.arcsin(v[..., 2] / vmag) * _R2D
    if p in ("hx", "hy", "hz"):
        h = torch.linalg.cross(r, v, dim=-1)
        return h[..., {"hx": 0, "hy": 1, "hz": 2}[p]]

    if p in ("bdot_r", "bdot_t", "b_ltof"):
        from ..cosmic.bplane import bplane_from_rv

        b_r, b_t, ltof, _ = bplane_from_rv(r, v, mu)
        return {"bdot_r": b_r, "bdot_t": b_t, "b_ltof": ltof}[p]

    el = om.keplerian_from_cartesian(r, v, mu)
    if p.startswith("brouwer_mean_short_"):
        key = p[len("brouwer_mean_short_"):]
        out = _brouwer_mean_short(el, mu, radius_km)[key]
        return out * _R2D if key in ("inc", "raan", "aop", "ma") else out
    sma, e, inc, raan, aop, ta = (el[k] for k in ("sma", "ecc", "inc", "raan", "aop", "ta"))
    if p == "semi_parameter":
        return sma * (1 - e**2)
    if p == "semi_minor_axis":
        return sma * torch.sqrt(torch.abs(1 - e**2))
    if p == "true_longitude":
        return torch.remainder(raan + aop + ta, _TWO_PI) * _R2D
    if p == "hyperbolic_anomaly":
        # H from nu: tanh(H/2) = sqrt((e-1)/(e+1)) tan(nu/2)
        th = torch.sqrt(torch.abs((e - 1) / (e + 1))) * torch.tan(ta / 2)
        return torch.atanh(torch.clamp(th, -1 + 1e-15, 1 - 1e-15)) * 2 * _R2D
    if p == "equinoctial_h":
        return e * torch.sin(aop + raan)
    if p == "equinoctial_k":
        return e * torch.cos(aop + raan)
    if p == "equinoctial_p":
        return torch.tan(inc / 2) * torch.sin(raan)
    if p == "equinoctial_q":
        return torch.tan(inc / 2) * torch.cos(raan)
    if p in ("equinoctial_lambda", "ea", "ma"):
        ea = om.true_to_ecc_anomaly(ta, e)
        if p == "ea":
            return ea * _R2D
        ma = om.ecc_to_mean_anomaly(ea, e)
        if p == "ma":
            return ma * _R2D
        return torch.remainder(ma + aop + raan, _TWO_PI) * _R2D
    if p == "sma":
        return sma
    if p == "ecc":
        return e
    if p == "inc":
        return inc * _R2D
    if p == "raan":
        return raan * _R2D
    if p == "aop":
        return aop * _R2D
    if p == "ta":
        return ta * _R2D
    if p == "aol":
        return torch.remainder(aop + ta, _TWO_PI) * _R2D
    if p == "periapsis_radius":
        return sma * (1 - e)
    if p == "apoapsis_radius":
        return sma * (1 + e)
    if p == "periapsis_height":
        return sma * (1 - e) - radius_km
    if p == "apoapsis_height":
        return sma * (1 + e) - radius_km
    if p == "c3":
        return -mu / sma
    if p == "period":
        return 2 * math.pi * torch.sqrt(torch.abs(sma) ** 3 / mu)
    raise StateError(f"unknown StateParameter {param!r}")


def default_precision(param: str) -> float:
    return StateParameter.DEFAULT_PRECISION.get(param.lower(), 1e-3)


#: Earth J2 (GMAT/EGM96 value), copied from nyx_tpu/md/param.py:229: the
#: BrouwerMeanShort parameters are defined for Earth orbits
_EARTH_J2 = 1.082626925638815e-3


def _brouwer_mean_short(el, mu, radius_km):
    """First-order J2 osculating -> mean (short-periodics removed) elements,
    Brouwer's artillery solution in the Lyddane-stabilized form (Schaub &
    Junkins, first-order mapping appendix; GMAT's BrouwerMeanShort), the
    reference's formulas term for term. Batched.

    Returns dict(sma, ecc, inc, raan, aop, ma), angles in radians.
    """
    a, e, i = el["sma"], el["ecc"], el["inc"]
    Om, w, f = el["raan"], el["aop"], el["ta"]
    M = om.ecc_to_mean_anomaly(om.true_to_ecc_anomaly(f, e), e)
    req = radius_km if radius_km else 6378.1363
    sin, cos = torch.sin, torch.cos

    gma2 = -_EARTH_J2 / 2.0 * (req / a) ** 2  # osc -> mean sign
    eta = torch.sqrt(1.0 - e**2)
    gma2p = gma2 / eta**4
    th = cos(i)
    th2 = th * th
    crit = 1.0 - 5.0 * th2  # critical-inclination divisor
    a_r = (1.0 + e * cos(f)) / eta**2
    cf = cos(f)

    am = a + a * gma2 * (
        (3 * th2 - 1) * (a_r**3 - 1.0 / eta**3)
        + 3 * (1 - th2) * a_r**3 * cos(2 * w + 2 * f)
    )

    de1 = gma2p / 8.0 * e * eta**2 * (1 - 11 * th2 - 40 * th2 * th2 / crit) * cos(2 * w)
    de = de1 + eta**2 / 2.0 * (
        gma2 * (
            (3 * th2 - 1) / eta**6
            * (e * eta + e / (1 + eta) + 3 * cf + 3 * e * cf**2 + e**2 * cf**3)
            + 3 * (1 - th2) / eta**6
            * (e + 3 * cf + 3 * e * cf**2 + e**2 * cf**3)
            * cos(2 * w + 2 * f)
        )
        - gma2p * (1 - th2) * (3 * cos(2 * w + f) + cos(2 * w + 3 * f))
    )

    di = (
        -e * de1 / (eta**2 * torch.tan(i))
        + gma2p / 2.0 * th * torch.sqrt(1 - th2)
        * (3 * cos(2 * w + 2 * f) + 3 * e * cos(2 * w + f) + e * cos(2 * w + 3 * f))
    )

    mwo = (
        M + w + Om
        + gma2p / 8.0 * eta**3 * (1 - 11 * th2 - 40 * th2 * th2 / crit)
        - gma2p / 16.0 * (
            2 + e**2 - 11 * (2 + 3 * e**2) * th2
            - 40 * (2 + 5 * e**2) * th2 * th2 / crit
            - 400 * e**2 * th2**3 / crit**2
        )
        + gma2p / 4.0 * (
            -6 * crit * (f - M + e * sin(f))
            + (3 - 5 * th2) * (
                3 * sin(2 * w + 2 * f) + 3 * e * sin(2 * w + f) + e * sin(2 * w + 3 * f)
            )
        )
        - gma2p / 8.0 * e**2 * th * (11 + 80 * th2 / crit + 200 * th2 * th2 / crit**2)
        - gma2p / 2.0 * th * (
            6 * (f - M + e * sin(f))
            - 3 * sin(2 * w + 2 * f) - 3 * e * sin(2 * w + f) - e * sin(2 * w + 3 * f)
        )
    )

    edm = (
        gma2p / 8.0 * e * eta**3 * (1 - 11 * th2 - 40 * th2 * th2 / crit)
        - gma2p / 4.0 * eta**3 * (
            2 * (3 * th2 - 1) * ((a_r * eta) ** 2 + a_r + 1) * sin(f)
            + 3 * (1 - th2) * (
                (-((a_r * eta) ** 2) - a_r + 1) * sin(2 * w + f)
                + ((a_r * eta) ** 2 + a_r + 1.0 / 3.0) * sin(2 * w + 3 * f)
            )
        )
    )

    dom = (
        -gma2p / 8.0 * e**2 * th * (11 + 80 * th2 / crit + 200 * th2 * th2 / crit**2)
        - gma2p / 2.0 * th * (
            6 * (f - M + e * sin(f))
            - 3 * sin(2 * w + 2 * f) - 3 * e * sin(2 * w + f) - e * sin(2 * w + 3 * f)
        )
    )

    # Lyddane combinations avoid small-e / small-i indeterminacy
    d1 = (e + de) * sin(M) + edm * cos(M)
    d2 = (e + de) * cos(M) - edm * sin(M)
    m_mean = torch.remainder(torch.atan2(d1, d2), _TWO_PI)
    e_mean = torch.sqrt(d1**2 + d2**2)
    si2 = sin(i / 2)
    d3 = (si2 + cos(i / 2) * di / 2) * sin(Om) + si2 * dom * cos(Om)
    d4 = (si2 + cos(i / 2) * di / 2) * cos(Om) - si2 * dom * sin(Om)
    om_mean = torch.remainder(torch.atan2(d3, d4), _TWO_PI)
    i_mean = 2 * torch.arcsin(torch.sqrt(d3**2 + d4**2))
    w_mean = torch.remainder(mwo - m_mean - om_mean, _TWO_PI)
    return dict(sma=am, ecc=e_mean, inc=i_mean, raan=om_mean, aop=w_mean, ma=m_mean)
