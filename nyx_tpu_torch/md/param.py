"""StateParameter: named scalar state queries (torch port of nyx_tpu/md/param.py).

Only the parameters the Monte Carlo dispersions need are ported: the state
slots and the osculating Keplerian elements (angles in degrees).
"""

from __future__ import annotations

import math

from ..cosmic import orbit as om
from ..errors import StateError

_R2D = 180.0 / math.pi
_SLOTS = {"x": 0, "y": 1, "z": 2, "vx": 3, "vy": 4, "vz": 5, "cr": 6, "cd": 7, "prop_mass": 8}
_ELEMENTS = {"sma": 1.0, "ecc": 1.0, "inc": _R2D, "raan": _R2D, "aop": _R2D, "ta": _R2D}


def value(param: str, y, mu: float):
    """Evaluate a StateParameter on flat state tensors y [..., >=6]."""
    p = param.lower()
    if p in _SLOTS:
        return y[..., _SLOTS[p]]
    if p in _ELEMENTS:
        el = om.keplerian_from_cartesian(y[..., 0:3], y[..., 3:6], mu)
        return el[p] * _ELEMENTS[p]
    raise StateError(f"parameter {param!r} is not available in the port yet")
