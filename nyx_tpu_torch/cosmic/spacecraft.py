"""Spacecraft state (torch port of nyx_tpu/cosmic/spacecraft.py).

The propagated state vector layout is the reference's:

    [x, y, z, vx, vy, vz, Cr, Cd, prop_mass_kg]

Ensembles live on the device as `[B, 9]` float64 tensors, with guided
dynamics appending the guidance mode as a tenth column; this class is the
host-side scalar wrapper, with an optional thruster, the guidance mode and
an optional state-carried 9x9 STM (`with_stm`), which `PropInstance`
propagates beside the state.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..constants import STD_GRAVITY_M_S2
from ..errors import StateError
from ..time import Epoch
from .orbit import Orbit

STATE_DIM = 9
IDX_CR = 6
IDX_CD = 7
IDX_PROP_MASS = 8


class GuidanceMode:
    """Guidance mode flags (reference: cosmic/spacecraft.rs:52-60)."""

    Coast = 0
    Thrust = 1
    Inhibit = 2


@dataclass(frozen=True)
class Thruster:
    """A constant-thrust engine (reference: dynamics/guidance/mod.rs:51-66)."""

    thrust_N: float
    isp_s: float

    @property
    def exhaust_velocity_m_s(self) -> float:
        return self.isp_s * STD_GRAVITY_M_S2


@dataclass
class Spacecraft:
    orbit: Orbit
    dry_mass_kg: float = 0.0
    prop_mass_kg: float = 0.0
    srp_area_m2: float = 0.0
    cr: float = 1.8
    drag_area_m2: float = 0.0
    cd: float = 2.2
    thruster: Optional[Thruster] = None
    mode: int = GuidanceMode.Coast
    stm: Optional[np.ndarray] = None  # (9, 9) when enabled

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

    @classmethod
    def from_srp_defaults(cls, orbit, dry_mass_kg, srp_area_m2) -> "Spacecraft":
        """A spacecraft with SRP area and the default Cr (1.8), no drag area."""
        return cls(orbit, dry_mass_kg=dry_mass_kg, srp_area_m2=srp_area_m2)

    @classmethod
    def from_drag_defaults(cls, orbit, dry_mass_kg, drag_area_m2) -> "Spacecraft":
        """A spacecraft with drag area and the default Cd (2.2), no SRP area."""
        return cls(orbit, dry_mass_kg=dry_mass_kg, drag_area_m2=drag_area_m2)

    @classmethod
    def from_thruster(
        cls, orbit, dry_mass_kg, prop_mass_kg, thruster, mode=GuidanceMode.Coast
    ) -> "Spacecraft":
        return cls(
            orbit,
            dry_mass_kg=dry_mass_kg,
            prop_mass_kg=prop_mass_kg,
            thruster=thruster,
            mode=mode,
        )

    def with_srp(self, srp_area_m2, cr) -> "Spacecraft":
        return replace(self, srp_area_m2=srp_area_m2, cr=cr)

    def with_drag(self, drag_area_m2, cd) -> "Spacecraft":
        return replace(self, drag_area_m2=drag_area_m2, cd=cd)

    def with_dv(self, dv_km_s) -> "Spacecraft":
        """A copy with `dv_km_s` (inertial, km/s) added to the velocity."""
        orbit = Orbit(self.orbit.r_km.copy(), self.orbit.v_km_s + np.asarray(dv_km_s, dtype=np.float64),
                      self.orbit.epoch, self.orbit.frame)
        return replace(self, orbit=orbit)

    def with_stm(self) -> "Spacecraft":
        """A copy carrying an identity STM, propagated beside the state."""
        return replace(self, stm=np.eye(STATE_DIM))

    def with_orbit(self, orbit: Orbit) -> "Spacecraft":
        return replace(self, orbit=orbit)

    @property
    def total_mass_kg(self) -> float:
        return self.dry_mass_kg + self.prop_mass_kg

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

    def value_of(self, param: str) -> float:
        """A StateParameter of this spacecraft, including the spacecraft-
        level ones the flat state cannot express (spacecraft.rs
        `State::value`): epoch, masses, thruster isp and thrust, guidance
        mode. The others go through the port's `md.param.value`."""
        from ..md import param as param_mod

        p = param.lower()
        if p == "epoch_tai_s":
            return self.epoch.to_tai_seconds()
        if p == "guidance_mode":
            return float(self.mode)
        if p == "dry_mass":
            return self.dry_mass_kg
        if p == "total_mass":
            return self.total_mass_kg
        if p in ("isp_s", "thrust_n", "thrust_x", "thrust_y", "thrust_z"):
            if self.thruster is None:
                raise StateError(f"{param} requires a thruster (none set)")
            if p == "isp_s":
                return self.thruster.isp_s
            if p == "thrust_n":
                return self.thruster.thrust_N
            # the reference returns Unavailable without an active guidance
            # law evaluation (spacecraft.rs:531-543)
            raise StateError(
                f"{param} requires an active guidance law evaluation; query the guidance law directly"
            )
        y = torch.from_numpy(self.to_vector())
        frame = self.orbit.frame
        return float(param_mod.value(p, y, frame.mu, frame.radius_km or 0.0))

    def __str__(self):
        return (
            f"Spacecraft(total {self.total_mass_kg:.3f} kg, "
            f"Cr={self.cr}, Cd={self.cd}) {self.orbit}"
        )
