"""Reference frames (torch port of nyx_tpu/cosmic/frames.py).

A `Frame` is a (center body, orientation) pair plus optional gravitational
parameter and shape. Orientation IDs follow NAIF conventions: 1 = J2000;
`10000 + body` for the analytic IAU body-fixed frames (Earth, Moon, Mars,
Sun); 3000 = ITRF93. No rotation is driven by a binary PCK: the BPC reader
(`ephem/daf.py`) reads the files, but, as in the reference
(nyx_tpu/cosmic/frames.py:76-79), ITRF93's rotation raises.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..constants import EARTH_FLATTENING, GM_BY_NAIF, NAIF, RADIUS_BY_NAIF
from ..errors import ConfigError
from ..xmath import LastCall
from . import rotations

J2000_ORIENT = 1
ITRF93_ORIENT = 3000


def iau_orient(body: int) -> int:
    return 10_000 + body


# The analytic body-fixed orientations, by orientation id.
_IAU_MODELS = {
    iau_orient(NAIF.EARTH): rotations.iau_earth_dcm,
    iau_orient(NAIF.MOON): rotations.iau_moon_dcm,
    iau_orient(NAIF.MARS): rotations.iau_mars_dcm,
    iau_orient(NAIF.SUN): rotations.iau_sun_dcm,
}


_LAST_DCM = LastCall()


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

    def with_mu_km3_s2(self, mu: float) -> "Frame":
        """This frame with another gravitational parameter (ANISE's
        Frame::with_mu_km3_s2)."""
        return replace(self, mu_km3_s2=mu)

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
        if o in _IAU_MODELS:
            # the field and the tides of one EOM call rotate at the same epochs
            return _LAST_DCM.get(o, t_tdb_s, lambda: _IAU_MODELS[o](t_tdb_s))
        if o == ITRF93_ORIENT:
            raise ConfigError("ITRF93 has no orientation model: as in the reference, no rotation "
                              "is driven by a binary PCK")
        raise ConfigError(f"no orientation model for frame orientation {o}")

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
        if self.orientation == ITRF93_ORIENT:
            return "Earth ITRF93"
        if self.orientation >= 10_000:
            return f"IAU_{c}"
        return f"{c}/{self.orientation}"


class Frames:
    """Common frames, mirroring anise::constants::frames."""

    EME2000 = Frame(NAIF.EARTH, J2000_ORIENT)
    EARTH_J2000 = EME2000
    MOON_J2000 = Frame(NAIF.MOON, J2000_ORIENT)
    SUN_J2000 = Frame(NAIF.SUN, J2000_ORIENT)
    MARS_J2000 = Frame(NAIF.MARS_BARYCENTER, J2000_ORIENT)
    EMB_J2000 = Frame(NAIF.EARTH_MOON_BARYCENTER, J2000_ORIENT)
    SSB_J2000 = Frame(NAIF.SSB, J2000_ORIENT, mu_km3_s2=0.0)
    IAU_EARTH = Frame(NAIF.EARTH, iau_orient(NAIF.EARTH), flattening=EARTH_FLATTENING)
    IAU_MOON = Frame(NAIF.MOON, iau_orient(NAIF.MOON))
    IAU_MARS = Frame(NAIF.MARS, iau_orient(NAIF.MARS))
    IAU_SUN = Frame(NAIF.SUN, iau_orient(NAIF.SUN))
    EARTH_ITRF93 = Frame(NAIF.EARTH, ITRF93_ORIENT, flattening=EARTH_FLATTENING)
