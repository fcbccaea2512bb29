"""Atmospheric drag (torch port of nyx_tpu/dynamics/drag.py).

F = -1/2 * 1e3 * rho * Cd * A * |v_rel| * v_rel / m (km/s^2), with the
atmosphere-relative velocity v_rel = v - omega x r. The constant,
exponential and StdAtm-1976 density models of the reference
(drag.rs:41-283) are ported; each density runs at the dtype of the
altitudes it is given. `estimate=True` marks Cd (state slot 7) estimable
(`estimation_index`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..cosmic.frames import Frame, Frames
from ..errors import ConfigError
from ..xmath import norm


@dataclass(frozen=True)
class AtmDensity:
    """Density model config (kg/m^3; altitudes in meters as the reference)."""

    kind: str  # "constant" | "exponential" | "stdatm"
    rho: float = 0.0
    rho0: float = 0.0
    r0_m: float = 0.0
    ref_alt_m: float = 1.0
    max_alt_m: float = 1_000_000.0

    @classmethod
    def constant(cls, rho: float) -> "AtmDensity":
        return cls("constant", rho=rho)

    @classmethod
    def exponential(cls, rho0: float, r0_m: float, ref_alt_m: float) -> "AtmDensity":
        return cls("exponential", rho0=rho0, r0_m=r0_m, ref_alt_m=ref_alt_m)

    @classmethod
    def earth_exponential(cls) -> "AtmDensity":
        # the reference's defaults, drag.rs:52-58
        return cls.exponential(3.614e-13, 700_000.0, 88_667.0)

    @classmethod
    def std_atm1976(cls, max_alt_m: float = 1_000_000.0) -> "AtmDensity":
        return cls("stdatm", max_alt_m=max_alt_m)

    def density(self, alt_km):
        """rho(altitude above mean equatorial radius), kg/m^3, batched."""
        if self.kind == "constant":
            return torch.full_like(alt_km, self.rho)
        if self.kind == "exponential":
            return self.rho0 * torch.exp(-(alt_km * 1e3 - self.r0_m) / self.ref_alt_m)
        if self.kind == "stdatm":
            # the 6th-order log10-density fit (AVS/Basilisk, as the
            # reference's drag.rs:252-268), valid below max_alt_m
            scale = (alt_km - 526.8000) / 292.8563
            logdensity = (
                0.34047 * scale**6
                - 0.5889 * scale**5
                - 0.5269 * scale**4
                + 1.0036 * scale**3
                + 0.60713 * scale**2
                - 2.3024 * scale
                - 12.575
            )
            high = 10.0 ** (-7e-5 * alt_km - 14.464)
            return torch.where(alt_km > self.max_alt_m / 1e3, high, 10.0**logdensity)
        raise ConfigError(self.kind)


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

    @classmethod
    def std_atm1976(cls) -> "Drag":
        return cls(AtmDensity.std_atm1976())

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
