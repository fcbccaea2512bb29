"""Reference frames (torch port of nyx_tpu/cosmic/frames.py).

A `Frame` is a (center body, orientation) pair plus optional gravitational
parameter and shape. Orientation IDs follow NAIF conventions: 1 = J2000;
`10000 + body` for the analytic IAU body-fixed frames. The port rotates
J2000 and IAU_EARTH; the other IAU models are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..constants import EARTH_FLATTENING, GM_BY_NAIF, NAIF, RADIUS_BY_NAIF
from ..errors import ConfigError
from . import rotations

J2000_ORIENT = 1


def iau_orient(body: int) -> int:
    return 10_000 + body


@dataclass(frozen=True)
class Frame:
    center: int  # NAIF id of the center body
    orientation: int = J2000_ORIENT
    mu_km3_s2: Optional[float] = None
    radius_km: Optional[float] = None
    flattening: float = 0.0

    def __post_init__(self):
        if self.mu_km3_s2 is None and self.center in GM_BY_NAIF:
            object.__setattr__(self, "mu_km3_s2", GM_BY_NAIF[self.center])
        if self.radius_km is None and self.center in RADIUS_BY_NAIF:
            object.__setattr__(self, "radius_km", RADIUS_BY_NAIF[self.center])

    @property
    def is_inertial(self) -> bool:
        return self.orientation == J2000_ORIENT

    @property
    def mu(self) -> float:
        if self.mu_km3_s2 is None:
            raise ConfigError(f"frame {self} has no GM defined")
        return self.mu_km3_s2

    def dcm_from_j2000(self, t_tdb_s):
        """DCM [..., 3, 3] rotating J2000 vectors into this frame, at the
        dtype and on the device of `t_tdb_s`."""
        o = self.orientation
        if o == J2000_ORIENT:
            eye = torch.eye(3, dtype=t_tdb_s.dtype, device=t_tdb_s.device)
            return eye.expand(t_tdb_s.shape + (3, 3))
        if o == iau_orient(NAIF.EARTH):
            return rotations.iau_earth_dcm(t_tdb_s)
        raise ConfigError(f"no orientation model for frame orientation {o} in the port")

    def __str__(self):
        """The reference's names: "Earth J2000", "IAU_Earth", ..."""
        names = {
            NAIF.EARTH: "Earth",
            NAIF.MOON: "Moon",
            NAIF.SUN: "Sun",
            NAIF.MARS: "Mars",
            NAIF.EARTH_MOON_BARYCENTER: "EMB",
            NAIF.SSB: "SSB",
        }
        c = names.get(self.center, str(self.center))
        if self.orientation == J2000_ORIENT:
            return f"{c} J2000"
        if self.orientation >= 10_000:
            return f"IAU_{c}"
        return f"{c}/{self.orientation}"


class Frames:
    """Common frames, mirroring anise::constants::frames."""

    EME2000 = Frame(NAIF.EARTH, J2000_ORIENT)
    EARTH_J2000 = EME2000
    IAU_EARTH = Frame(NAIF.EARTH, iau_orient(NAIF.EARTH), flattening=EARTH_FLATTENING)
