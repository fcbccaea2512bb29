"""Atmospheric drag (torch port of nyx_tpu/dynamics/drag.py).

F = -1/2 * 1e3 * rho * Cd * A * |v_rel| * v_rel / m (km/s^2), with the
atmosphere-relative velocity v_rel = v - omega x r. The exponential density
model is ported; the constant and StdAtm-1976 models are not yet.
`estimate=True` marks Cd (state slot 7) estimable (`estimation_index`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..cosmic.frames import Frame, Frames
from ..xmath import norm


@dataclass(frozen=True)
class AtmDensity:
    """Exponential density (kg/m^3; altitudes in meters as the reference)."""

    rho0: float
    r0_m: float
    ref_alt_m: float

    @classmethod
    def earth_exponential(cls) -> "AtmDensity":
        return cls(3.614e-13, 700_000.0, 88_667.0)

    def density(self, alt_km):
        """rho(altitude above mean equatorial radius), kg/m^3, batched."""
        return self.rho0 * torch.exp(-(alt_km * 1e3 - self.r0_m) / self.ref_alt_m)


@dataclass(frozen=True)
class Drag:
    density: AtmDensity
    frame: Frame = Frames.IAU_EARTH
    estimate: bool = False

    # Earth's prime-meridian rotation rate (IAU W-dot), rad/s
    _EARTH_OMEGA = 360.985_623_5 * math.pi / (180.0 * 86_400.0)

    @classmethod
    def earth_exp(cls) -> "Drag":
        return cls(AtmDensity.earth_exponential())

    def required_bodies(self):
        return ()

    def estimation_index(self) -> Optional[int]:
        return 7 if self.estimate else None

    def force_per_mass(self, ctx, t_tdb, r, v, sc):
        """Acceleration [B,3] km/s^2. `sc`: dict with cd, drag_area_m2, mass_kg."""
        rmag = norm(r)
        alt_km = rmag - (self.frame.radius_km or 0.0)
        rho = self.density.density(alt_km)
        # omega x r with omega = (0, 0, w): the same values as the full
        # cross product, without building omega on the device every call
        w = self._EARTH_OMEGA
        w_x_r = torch.stack([-(w * r[..., 1]), w * r[..., 0], torch.zeros_like(rmag)], dim=-1)
        v_rel = v - w_x_r
        vmag = norm(v_rel, keepdim=True)
        aom = sc["drag_area_m2"] / sc["mass_kg"]
        return -0.5e3 * (rho * sc["cd"] * aom)[..., None] * vmag * v_rel
