"""Solar radiation pressure with a conical shadow model.

Torch port of nyx_tpu/dynamics/srp.py: cannonball SRP, flux 1367 W/m^2 at
1 AU scaled by (AU/r)^2, Cr * A area, illumination factor from the
max-occultation shadow model over a list of shadow bodies (`cislunar`:
the Earth and the Moon). Acceleration points from Sun to spacecraft.
`estimate=True` marks Cr (state slot 6) estimable (`estimation_index`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..constants import AU_KM, NAIF, RADIUS_BY_NAIF, SOLAR_FLUX_W_M2, SPEED_OF_LIGHT_M_S
from ..cosmic.eclipse import illumination_factor
from ..xmath import norm


@dataclass(frozen=True)
class SolarPressure:
    shadow_bodies: Tuple[int, ...] = (NAIF.EARTH,)
    phi_w_m2: float = SOLAR_FLUX_W_M2
    estimate: bool = False

    @classmethod
    def default(cls, *shadow_bodies) -> "SolarPressure":
        return cls(tuple(shadow_bodies) or (NAIF.EARTH,))

    @classmethod
    def cislunar(cls) -> "SolarPressure":
        """Earth and Moon shadows (the reference's srp.py:32)."""
        return cls((NAIF.EARTH, NAIF.MOON))

    def required_bodies(self):
        return (NAIF.SUN,) + tuple(self.shadow_bodies)

    def estimation_index(self) -> Optional[int]:
        return 6 if self.estimate else None

    def force_per_mass(self, ctx, t_tdb, r, v, sc):
        """Acceleration [B,3] km/s^2 at the dtype of `r`. `sc`: dict with
        cr, srp_area_m2, mass_kg."""
        dt = r.dtype
        r_sun_c = ctx.table.position(ctx.body_index(NAIF.SUN), t_tdb, dtype=dt)
        r_sc_to_sun = r_sun_c - r
        occulters = []
        for body in self.shadow_bodies:
            radius = RADIUS_BY_NAIF[body]
            if body == ctx.frame.center:
                occulters.append((-r, radius))
            else:
                rb = ctx.table.position(ctx.body_index(body), t_tdb, dtype=dt)
                occulters.append((rb - r, radius))
        k = illumination_factor(r_sc_to_sun, occulters)
        d_sun = norm(r_sc_to_sun)
        flux_pressure = k * (self.phi_w_m2 / SPEED_OF_LIGHT_M_S) * (AU_KM / d_sun) ** 2
        u_away = -r_sc_to_sun / d_sun[..., None]
        aom = sc["srp_area_m2"] / sc["mass_kg"]
        return 1e-3 * (sc["cr"] * aom * flux_pressure)[..., None] * u_away
