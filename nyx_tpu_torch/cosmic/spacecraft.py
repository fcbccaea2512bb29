"""Spacecraft state (torch port of nyx_tpu/cosmic/spacecraft.py).

The propagated state vector layout is the reference's:

    [x, y, z, vx, vy, vz, Cr, Cd, prop_mass_kg]

Ensembles live on the device as `[B, 9]` float64 tensors; this class is the
host-side scalar wrapper. Thrusters, guidance modes and a state-carried
STM are not ported yet (the OD filter builds its STMs itself).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..time import Epoch
from .orbit import Orbit


@dataclass
class Spacecraft:
    orbit: Orbit
    dry_mass_kg: float = 0.0
    prop_mass_kg: float = 0.0
    srp_area_m2: float = 0.0
    cr: float = 1.8
    drag_area_m2: float = 0.0
    cd: float = 2.2

    @classmethod
    def from_orbit(cls, orbit: Orbit) -> "Spacecraft":
        return cls(orbit)

    @classmethod
    def new(
        cls, orbit, dry_mass_kg, prop_mass_kg, srp_area_m2, drag_area_m2, cr, cd
    ) -> "Spacecraft":
        return cls(
            orbit,
            dry_mass_kg=dry_mass_kg,
            prop_mass_kg=prop_mass_kg,
            srp_area_m2=srp_area_m2,
            cr=cr,
            drag_area_m2=drag_area_m2,
            cd=cd,
        )

    @property
    def epoch(self) -> Epoch:
        return self.orbit.epoch

    @property
    def frame(self):
        return self.orbit.frame

    def to_vector(self) -> np.ndarray:
        """State vector [x,y,z,vx,vy,vz,Cr,Cd,prop_mass] (9,)."""
        return np.concatenate(
            [self.orbit.r_km, self.orbit.v_km_s, [self.cr, self.cd, self.prop_mass_kg]]
        ).astype(np.float64)

    def set_vector(self, epoch: Epoch, vec) -> "Spacecraft":
        """A copy at `epoch` holding the state vector `vec` (Cr clamped into
        [0, 2])."""
        vec = np.asarray(vec, dtype=np.float64)
        orbit = Orbit(vec[0:3].copy(), vec[3:6].copy(), epoch, self.orbit.frame)
        return replace(
            self,
            orbit=orbit,
            cr=float(np.clip(vec[6], 0.0, 2.0)),
            cd=float(vec[7]),
            prop_mass_kg=float(vec[8]),
        )
