"""Built-in analytic planetary/lunar ephemeris (host-side, numpy).

The reference loads DE440s through ANISE; this framework parses real SPK
kernels too (see daf.py), but ships a self-contained analytic fallback so
the full stack runs without binary kernels:

* Planets + Earth-Moon barycenter: JPL's "Approximate Positions of the
  Planets" mean Keplerian elements (Standish), valid 1800-2050 AD,
  ~arcminute accuracy — ample for third-body perturbations.
* Moon: truncated ELP-2000 style series (principal terms), geocentric,
  ~0.01 deg / <~200 km accuracy.

All outputs are J2000 equatorial (EME2000) positions in km. Velocities are
obtained downstream by differentiating fitted Chebyshev polynomials, exactly
as SPK type 2 segments do.

Copied unchanged from nyx_tpu/ephem/analytic.py (host-only, no JAX).
"""

from __future__ import annotations

import numpy as np

from ..constants import AU_KM, GM, NAIF

_D2R = np.pi / 180.0
# J2000 mean obliquity of the ecliptic
_OBLIQUITY_DEG = 23.439291111
_COSE = np.cos(_OBLIQUITY_DEG * _D2R)
_SINE = np.sin(_OBLIQUITY_DEG * _D2R)

# Mass ratio factor: Earth position = EMB - f * (Moon geocentric)
_EARTH_FROM_EMB = GM.MOON / (GM.EARTH + GM.MOON)

# JPL approximate mean elements (a AU, e, I deg, L deg, long.peri deg, RAAN deg)
# and per-Julian-century rates, J2000 ecliptic, valid 1800-2050.
_ELEMENTS = {
    NAIF.MERCURY_BARYCENTER: (
        [0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593],
        [0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081],
    ),
    NAIF.VENUS_BARYCENTER: (
        [0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255],
        [0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418],
    ),
    NAIF.EARTH_MOON_BARYCENTER: (
        [1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0],
        [0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0],
    ),
    NAIF.MARS_BARYCENTER: (
        [1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891],
        [0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343],
    ),
    NAIF.JUPITER_BARYCENTER: (
        [5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909],
        [-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106],
    ),
    NAIF.SATURN_BARYCENTER: (
        [9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448],
        [-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794],
    ),
    NAIF.URANUS_BARYCENTER: (
        [19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503],
        [-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589],
    ),
    NAIF.NEPTUNE_BARYCENTER: (
        [30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574],
        [0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664],
    ),
}


def _ecl_to_eq(v_ecl: np.ndarray) -> np.ndarray:
    """Rotate ecliptic-J2000 vectors to equatorial J2000 (rot about X by -eps)."""
    x, y, z = v_ecl[..., 0], v_ecl[..., 1], v_ecl[..., 2]
    return np.stack(
        [x, _COSE * y - _SINE * z, _SINE * y + _COSE * z], axis=-1
    )


def _kepler(ma_rad, ecc, iters=12):
    ea = ma_rad + ecc * np.sin(ma_rad)
    for _ in range(iters):
        ea = ea - (ea - ecc * np.sin(ea) - ma_rad) / (1 - ecc * np.cos(ea))
    return ea


def heliocentric_planet(body: int, t_tdb_s) -> np.ndarray:
    """Heliocentric position of a planet barycenter / EMB, EME2000 km."""
    el0, rate = _ELEMENTS[body]
    T = np.asarray(t_tdb_s, dtype=np.float64) / (86_400.0 * 36_525.0)
    a = (el0[0] + rate[0] * T) * AU_KM
    e = el0[1] + rate[1] * T
    inc = (el0[2] + rate[2] * T) * _D2R
    L = np.mod(el0[3] + rate[3] * T, 360.0) * _D2R
    lp = (el0[4] + rate[4] * T) * _D2R
    raan = (el0[5] + rate[5] * T) * _D2R
    aop = lp - raan
    ma = np.mod(L - lp, 2 * np.pi)
    ea = _kepler(ma, e)
    xp = a * (np.cos(ea) - e)
    yp = a * np.sqrt(1 - e * e) * np.sin(ea)
    cw, sw = np.cos(aop), np.sin(aop)
    cO, sO = np.cos(raan), np.sin(raan)
    ci, si = np.cos(inc), np.sin(inc)
    x = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    y = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return _ecl_to_eq(np.stack([x, y, z], axis=-1))


# --- Moon: truncated ELP-2000 principal terms ----------------------------
# Fundamental arguments (deg, deg/century powers), Meeus-style.
def _fundamental_args(T):
    Lp = 218.3164477 + 481267.88123421 * T - 0.0015786 * T**2 + T**3 / 538841.0
    D = 297.8501921 + 445267.1114034 * T - 0.0018819 * T**2 + T**3 / 545868.0
    M = 357.5291092 + 35999.0502909 * T - 0.0001536 * T**2
    Mp = 134.9633964 + 477198.8675055 * T + 0.0087414 * T**2 + T**3 / 69699.0
    F = 93.2720950 + 483202.0175233 * T - 0.0036539 * T**2
    return Lp, D, M, Mp, F


# Principal periodic terms: (d, m, mp, f, sum_l [1e-6 deg], sum_r [1e-3 km])
_LUNAR_LR = [
    (0, 0, 1, 0, 6288774, -20905355),
    (2, 0, -1, 0, 1274027, -3699111),
    (2, 0, 0, 0, 658314, -2955968),
    (0, 0, 2, 0, 213618, -569925),
    (0, 1, 0, 0, -185116, 48888),
    (0, 0, 0, 2, -114332, -3149),
    (2, 0, -2, 0, 58793, 246158),
    (2, -1, -1, 0, 57066, -152138),
    (2, 0, 1, 0, 53322, -170733),
    (2, -1, 0, 0, 45758, -204586),
    (0, 1, -1, 0, -40923, -129620),
    (1, 0, 0, 0, -34720, 108743),
    (0, 1, 1, 0, -30383, 104755),
    (2, 0, 0, -2, 15327, 10321),
    (0, 0, 1, 2, -12528, 0),
    (0, 0, 1, -2, 10980, 79661),
    (4, 0, -1, 0, 10675, -34782),
    (0, 0, 3, 0, 10034, -23210),
    (4, 0, -2, 0, 8548, -21636),
    (2, 1, -1, 0, -7888, 24208),
    (2, 1, 0, 0, -6766, 30824),
    (1, 0, -1, 0, -5163, -8379),
    (1, 1, 0, 0, 4987, -16675),
    (2, -1, 1, 0, 4036, -12831),
    (2, 0, 2, 0, 3994, -10445),
    (4, 0, 0, 0, 3861, -11650),
    (2, 0, -3, 0, 3665, 14403),
    (0, 1, -2, 0, -2689, -7003),
    (2, 0, -1, 2, -2602, 0),
    (2, -1, -2, 0, 2390, 10056),
    (1, 0, 1, 0, -2348, 6322),
    (2, -2, 0, 0, 2236, -9884),
]

# (d, m, mp, f, sum_b [1e-6 deg])
_LUNAR_B = [
    (0, 0, 0, 1, 5128122),
    (0, 0, 1, 1, 280602),
    (0, 0, 1, -1, 277693),
    (2, 0, 0, -1, 173237),
    (2, 0, -1, 1, 55413),
    (2, 0, -1, -1, 46271),
    (2, 0, 0, 1, 32573),
    (0, 0, 2, 1, 17198),
    (2, 0, 1, -1, 9266),
    (0, 0, 2, -1, 8822),
    (2, -1, 0, -1, 8216),
    (2, 0, -2, -1, 4324),
    (2, 0, 1, 1, 4200),
    (2, 1, 0, -1, -3359),
    (2, -1, -1, 1, 2463),
    (2, -1, 0, 1, 2211),
    (2, -1, -1, -1, 2065),
    (0, 1, -1, -1, -1870),
    (4, 0, -1, -1, 1828),
    (0, 1, 0, 1, -1794),
]


def moon_geocentric(t_tdb_s) -> np.ndarray:
    """Geocentric Moon position, EME2000 equatorial, km."""
    T = np.asarray(t_tdb_s, dtype=np.float64) / (86_400.0 * 36_525.0)
    Lp, D, M, Mp, F = _fundamental_args(T)
    E = 1 - 0.002516 * T - 0.0000074 * T**2

    sum_l = np.zeros_like(T)
    sum_r = np.zeros_like(T)
    for d, m, mp, f, sl, sr in _LUNAR_LR:
        arg = (d * D + m * M + mp * Mp + f * F) * _D2R
        ef = E ** abs(m)
        sum_l = sum_l + sl * ef * np.sin(arg)
        sum_r = sum_r + sr * ef * np.cos(arg)
    sum_b = np.zeros_like(T)
    for d, m, mp, f, sb in _LUNAR_B:
        arg = (d * D + m * M + mp * Mp + f * F) * _D2R
        sum_b = sum_b + sb * (E ** abs(m)) * np.sin(arg)
    # venus/jupiter/flattening correction terms on latitude/longitude
    A1 = (119.75 + 131.849 * T) * _D2R
    A2 = (53.09 + 479264.290 * T) * _D2R
    A3 = (313.45 + 481266.484 * T) * _D2R
    sum_l = sum_l + 3958 * np.sin(A1) + 1962 * np.sin((Lp - F) * _D2R) + 318 * np.sin(A2)
    sum_b = (
        sum_b
        - 2235 * np.sin(Lp * _D2R)
        + 382 * np.sin(A3)
        + 175 * np.sin(A1 - F * _D2R)
        + 175 * np.sin(A1 + F * _D2R)
        + 127 * np.sin((Lp - Mp) * _D2R)
        - 115 * np.sin((Lp + Mp) * _D2R)
    )

    lon = (Lp + sum_l / 1e6) * _D2R  # ecliptic of date
    lat = (sum_b / 1e6) * _D2R
    dist = 385_000.56 + sum_r / 1e3

    # ecliptic-of-date -> ecliptic J2000: precess longitude by general precession
    # p ~ 1.396971 deg/century (sufficient at our series' accuracy level)
    lon = lon - (1.396971 * T + 0.0003086 * T**2) * _D2R

    cl, sl_ = np.cos(lon), np.sin(lon)
    cb, sb_ = np.cos(lat), np.sin(lat)
    ecl = np.stack([dist * cb * cl, dist * cb * sl_, dist * sb_], axis=-1)
    return _ecl_to_eq(ecl)


def heliocentric(body: int, t_tdb_s) -> np.ndarray:
    """Heliocentric EME2000 position of any supported body, km."""
    if body in _ELEMENTS:
        return heliocentric_planet(body, t_tdb_s)
    if body == NAIF.SUN:
        t = np.asarray(t_tdb_s, dtype=np.float64)
        return np.zeros(t.shape + (3,))
    if body == NAIF.EARTH:
        emb = heliocentric_planet(NAIF.EARTH_MOON_BARYCENTER, t_tdb_s)
        return emb - _EARTH_FROM_EMB * moon_geocentric(t_tdb_s)
    if body == NAIF.MOON:
        return heliocentric(NAIF.EARTH, t_tdb_s) + moon_geocentric(t_tdb_s)
    raise KeyError(f"analytic ephemeris does not model body {body}")


def state_between(target: int, center: int, t_tdb_s) -> np.ndarray:
    """Position of `target` relative to `center`, EME2000 km."""
    if target == NAIF.MOON and center == NAIF.EARTH:
        return moon_geocentric(t_tdb_s)
    if target == NAIF.EARTH and center == NAIF.MOON:
        return -moon_geocentric(t_tdb_s)
    return heliocentric(target, t_tdb_s) - heliocentric(center, t_tdb_s)
