"""StateParameter: named scalar state queries (torch port of nyx_tpu/md/param.py).

The parameter names and the set of those in degrees are copied from the
reference (md/param.py:20-104). `value` evaluates only the ones the Monte
Carlo dispersions and the guidance objectives need: the state slots and
the osculating Keplerian elements (angles in degrees).
"""

from __future__ import annotations

import math

from ..cosmic import orbit as om
from ..errors import StateError

_R2D = 180.0 / math.pi
_SLOTS = {"x": 0, "y": 1, "z": 2, "vx": 3, "vy": 4, "vz": 5, "cr": 6, "cd": 7, "prop_mass": 8}
_ELEMENTS = {"sma": 1.0, "ecc": 1.0, "inc": _R2D, "raan": _R2D, "aop": _R2D, "ta": _R2D}


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

    ANGLES_DEG = {
        "inc", "raan", "aop", "ta", "ea", "ma", "fpa", "declination",
        "right_asc", "aol", "true_longitude", "velocity_declination",
        "hyperbolic_anomaly", "equinoctial_lambda",
        "brouwer_mean_short_inc", "brouwer_mean_short_raan",
        "brouwer_mean_short_aop", "brouwer_mean_short_ma",
    }


def value(param: str, y, mu: float):
    """Evaluate a StateParameter on flat state tensors y [..., >=6]."""
    p = param.lower()
    if p in _SLOTS:
        return y[..., _SLOTS[p]]
    if p in _ELEMENTS:
        el = om.keplerian_from_cartesian(y[..., 0:3], y[..., 3:6], mu)
        return el[p] * _ELEMENTS[p]
    raise StateError(f"parameter {param!r} is not available in the port yet")
