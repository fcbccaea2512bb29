"""Physical constants and gravitational parameters.

GM values are the DE440 system values (km^3/s^2); the reference attaches GMs to
frames loaded from its planetary constants kernel (`pck08.pca`), and its tests
override Earth's GM with GMAT's 398600.4415 (reference: nyx-core/src/lib.rs:83).
Body radii follow the IAU/GMAT values used by the reference force models.

Copied unchanged from nyx_tpu/constants.py (host-only, no JAX).
"""

from __future__ import annotations

# Speed of light (m/s) — reference: nyx-core/src/cosmic/mod.rs:179-186
SPEED_OF_LIGHT_M_S = 299_792_458.0
SPEED_OF_LIGHT_KM_S = 299_792.458

# Astronomical unit, km
AU_KM = 149_597_870.7

# Standard gravity, m/s^2 — reference: cosmic/mod.rs:186
STD_GRAVITY_M_S2 = 9.80665

# Solar flux at 1 AU, W/m^2 — reference: dynamics/solarpressure.rs:35
SOLAR_FLUX_W_M2 = 1367.0


class GM:
    """Gravitational parameters, km^3/s^2 (DE440)."""

    SUN = 132_712_440_041.279419
    MERCURY = 22_031.868551
    VENUS = 324_858.592
    EARTH = 398_600.435507
    MOON = 4_902.800118
    EARTH_MOON_BARYCENTER = EARTH + MOON
    MARS_SYSTEM = 42_828.375816
    JUPITER_SYSTEM = 126_712_764.1
    SATURN_SYSTEM = 37_940_584.8418
    URANUS_SYSTEM = 5_794_556.4
    NEPTUNE_SYSTEM = 6_836_527.10058
    PLUTO_SYSTEM = 975.5

    # GMAT's Earth GM, used by the reference's validation tests only
    # (reference: nyx-core/src/lib.rs:83).
    GMAT_EARTH = 398_600.4415


class MeanRadius:
    """Mean equatorial radii, km."""

    SUN = 695_700.0
    MERCURY = 2_439.7
    VENUS = 6_051.8
    EARTH = 6_378.1363  # GMAT / JGM-3 reference radius
    MOON = 1_737.4
    MARS = 3_396.19
    JUPITER = 71_492.0
    SATURN = 60_268.0
    URANUS = 25_559.0
    NEPTUNE = 24_764.0


# Earth flattening (WGS-72 value used by GMAT ground models)
EARTH_FLATTENING = 1.0 / 298.257223563
EARTH_SEMI_MAJOR_KM = 6378.137  # WGS-84, used for geodetic conversions

# NAIF integer IDs
class NAIF:
    SSB = 0
    MERCURY_BARYCENTER = 1
    VENUS_BARYCENTER = 2
    EARTH_MOON_BARYCENTER = 3
    MARS_BARYCENTER = 4
    JUPITER_BARYCENTER = 5
    SATURN_BARYCENTER = 6
    URANUS_BARYCENTER = 7
    NEPTUNE_BARYCENTER = 8
    PLUTO_BARYCENTER = 9
    SUN = 10
    MOON = 301
    EARTH = 399
    MERCURY = 199
    VENUS = 299
    MARS = 499
    JUPITER = 599
    SATURN = 699
    URANUS = 799
    NEPTUNE = 899


GM_BY_NAIF = {
    NAIF.SUN: GM.SUN,
    NAIF.MERCURY_BARYCENTER: GM.MERCURY,
    NAIF.MERCURY: GM.MERCURY,
    NAIF.VENUS_BARYCENTER: GM.VENUS,
    NAIF.VENUS: GM.VENUS,
    NAIF.EARTH_MOON_BARYCENTER: GM.EARTH_MOON_BARYCENTER,
    NAIF.EARTH: GM.EARTH,
    NAIF.MOON: GM.MOON,
    NAIF.MARS_BARYCENTER: GM.MARS_SYSTEM,
    NAIF.MARS: GM.MARS_SYSTEM,
    NAIF.JUPITER_BARYCENTER: GM.JUPITER_SYSTEM,
    NAIF.JUPITER: GM.JUPITER_SYSTEM,
    NAIF.SATURN_BARYCENTER: GM.SATURN_SYSTEM,
    NAIF.SATURN: GM.SATURN_SYSTEM,
    NAIF.URANUS_BARYCENTER: GM.URANUS_SYSTEM,
    NAIF.URANUS: GM.URANUS_SYSTEM,
    NAIF.NEPTUNE_BARYCENTER: GM.NEPTUNE_SYSTEM,
    NAIF.NEPTUNE: GM.NEPTUNE_SYSTEM,
    NAIF.PLUTO_BARYCENTER: GM.PLUTO_SYSTEM,
}

RADIUS_BY_NAIF = {
    NAIF.SUN: MeanRadius.SUN,
    NAIF.EARTH: MeanRadius.EARTH,
    NAIF.MOON: MeanRadius.MOON,
    NAIF.MERCURY: MeanRadius.MERCURY,
    NAIF.VENUS: MeanRadius.VENUS,
    NAIF.MARS: MeanRadius.MARS,
    NAIF.JUPITER: MeanRadius.JUPITER,
    NAIF.SATURN: MeanRadius.SATURN,
    NAIF.URANUS: MeanRadius.URANUS,
    NAIF.NEPTUNE: MeanRadius.NEPTUNE,
}
