"""Spacecraft state (torch port of nyx_tpu/cosmic/spacecraft.py).

The propagated state vector layout is the reference's:

    [x, y, z, vx, vy, vz, Cr, Cd, prop_mass_kg]

Ensembles live on the device as `[B, 9]` float64 tensors; this class is the
host-side scalar wrapper. Thrusters, guidance modes and the STM are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

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
