"""StateParameter: named scalar state queries (torch port of nyx_tpu/md/param.py).

The parameter names, the set of those in degrees and the default event
precisions are copied from the reference (md/param.py:20-104). `value`
evaluates every parameter of the reference's `value` (md/param.py:106-222)
on flat state tensors, the same formulas in float64, except two groups
that raise `StateError`: the Brouwer mean elements (`brouwer_mean_short_*`)
and the B-plane parameters (`bdot_r`, `bdot_t`, `b_ltof`).
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
    if p.startswith("brouwer_mean_short_") or p in ("bdot_r", "bdot_t", "b_ltof"):
        raise StateError(f"parameter {param!r} is not available in the port yet")
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

    el = om.keplerian_from_cartesian(r, v, mu)
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
