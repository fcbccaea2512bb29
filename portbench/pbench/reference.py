"""The plain reference of a LEO Monte Carlo deployment, in plain PyTorch.

It imports nothing of the program under test. From the configuration file
and the seed alone it works out again what the program's window produces:

- the dispersed initial states: the osculating elements' Jacobian by
  autograd, the Cartesian covariance pinv(J) diag(sigma^2) pinv(J)^T, its
  square root U sqrt(s) and the seeded stream of standard normals that both
  sides define (`torch.randn((n, 9))` from a CPU generator);
- the final states after the arc: two-body, the spherical-harmonic field in
  spherical coordinates (fully normalized Legendre functions and their
  derivative by the column recursion), the IAU Earth rotation, the Sun from
  the mean planetary elements with the Earth-Moon offset, a conical shadow
  from the apparent disks' overlap, cannonball SRP and exponential drag,
  integrated by Gragg-Bulirsch-Stoer extrapolation on a fixed grid.

Every lane of one call shares the time grid, so the time, the rotation and
the Sun's position are host scalars in float64 at every evaluation; the
state and every force run at `dtype` (float64 for the reference, float32
for the control). The gravity file is read here, from its text.
"""

from __future__ import annotations

import datetime as _dt
import gzip
import math
import re
from pathlib import Path

import numpy as np
import torch

_D2R = math.pi / 180.0
_FLOAT = re.compile(r"[-+]?\d+\.\d+(?:[eEdD][-+]?\d+)?")


# --------------------------------------------------------------- gravity file
def read_cof(path: Path, degree: int, order: int):
    """(C, S [degree+1, order+1] fully normalized, mu km^3/s^2, radius km)
    of a GMAT .cof file (POTFIELD header in m^3/s^2 and m; RECOEF rows
    n, m, C and, for m > 0, S)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    C = np.zeros((degree + 1, order + 1))
    S = np.zeros((degree + 1, order + 1))
    mu = radius = None
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("POTFIELD"):
                tok = line.split()
                mu, radius = float(tok[4]) / 1e9, float(tok[5]) / 1e3
            elif line.startswith("RECOEF"):
                n, m = int(line[6:11]), int(line[11:14])
                vals = [float(v.replace("D", "e").replace("d", "e")) for v in _FLOAT.findall(line[14:])]
                if n <= degree and m <= order:
                    C[n, m] = vals[0]
                    S[n, m] = vals[1] if len(vals) > 1 else 0.0
    if mu is None:
        raise ValueError(f"{path}: no POTFIELD header")
    return C, S, mu, radius


class Field:
    """The non-central part (degrees 2..N) of a spherical-harmonic field in
    the body-fixed frame, evaluated in spherical coordinates: the potential
    U = mu/r sum_n (R/r)^n sum_m Pbar_nm(sin phi) (C cos m lam + S sin m lam)
    and its gradient from dU/dr, dU/d(sin phi) and dU/d lam."""

    def __init__(self, C, S, mu, radius, dtype, device):
        N, M = C.shape[0] - 1, C.shape[1] - 1
        self.N, self.M, self.mu, self.radius = N, M, mu, radius
        C, S = C.copy(), S.copy()
        C[:2, :] = 0.0
        S[:2, :] = 0.0
        kw = dict(dtype=dtype, device=device)
        self.C = torch.as_tensor(C, **kw)
        self.S = torch.as_tensor(S, **kw)
        m = np.arange(M + 1, dtype=np.float64)
        a = np.zeros((N + 1, M + 1))
        b = np.zeros((N + 1, M + 1))
        for n in range(1, N + 1):
            mm = m[m < n]
            a[n, : len(mm)] = np.sqrt((2 * n - 1) * (2 * n + 1) / ((n - mm) * (n + mm)))
            if n >= 2:
                b[n, : len(mm)] = np.sqrt((2 * n + 1) * (n + mm - 1) * (n - mm - 1)
                                          / ((n - mm) * (n + mm) * (2 * n - 3)))
        # sectoral factors: Pbar_mm = d_m u Pbar_{m-1,m-1}
        d = np.array([1.0, math.sqrt(3.0)] + [math.sqrt((2 * k + 1) / (2 * k)) for k in range(2, M + 1)])
        self.a = torch.as_tensor(a, **kw)[:, None, :]  # [N+1, 1, M+1]
        self.b = torch.as_tensor(b, **kw)[:, None, :]
        self.cumd = torch.as_tensor(np.cumprod(d[: M + 1]), **kw)
        self.onehot = torch.as_tensor(np.eye(N + 1, M + 1), **kw)[:, None, :]  # [N+1, 1, M+1]
        self.m = torch.as_tensor(m, **kw)
        self.n = torch.arange(N + 1, **kw)

    def accel(self, r):
        """[L, 3] km body-fixed -> [L, 3] km/s^2."""
        x, y, z = r[:, 0], r[:, 1], r[:, 2]
        rho2 = x * x + y * y
        rmag = torch.sqrt(rho2 + z * z)
        t = (z / rmag)[:, None]
        u = (torch.sqrt(rho2) / rmag)[:, None]
        # the sectorals and their t-derivatives (du/dt = -t/u), each placed
        # in its own degree's row: row n holds Pbar_nn at column n
        pmm = self.cumd * u ** self.m  # [L, M+1]
        dpmm = pmm * self.m * (-t / (u * u))
        diag, ddiag = self.onehot * pmm, self.onehot * dpmm  # [N+1, L, M+1]
        at = self.a * t  # [N+1, L, M+1]
        p_prev = dp_prev = torch.zeros_like(pmm)
        p, dp = diag[0], ddiag[0]
        rows, drows = [p], [dp]
        # column recursion Pbar_nm = a_nm t Pbar_{n-1,m} - b_nm Pbar_{n-2,m}
        # (m < n), differentiated in t alongside
        for n in range(1, self.N + 1):
            pn = at[n] * p - self.b[n] * p_prev + diag[n]
            dpn = self.a[n] * p + at[n] * dp - self.b[n] * dp_prev + ddiag[n]
            p_prev, dp_prev, p, dp = p, dp, pn, dpn
            rows.append(p)
            drows.append(dp)
        P = torch.stack(rows, 1)  # [L, N+1, M+1]
        dP = torch.stack(drows, 1)
        lam = torch.atan2(y, x)[:, None] * self.m  # [L, M+1]
        cml, sml = torch.cos(lam)[:, None, :], torch.sin(lam)[:, None, :]
        cs = self.C * cml + self.S * sml
        sc = self.m * (self.S * cml - self.C * sml)
        rn = (self.radius / rmag)[:, None] ** self.n  # [L, N+1]
        k = self.mu / rmag
        dU_dr = -(k / rmag) * torch.sum(rn * (self.n + 1) * torch.sum(P * cs, -1), -1)
        dU_dt = k * torch.sum(rn * torch.sum(dP * cs, -1), -1)
        dU_dl = k * torch.sum(rn * torch.sum(P * sc, -1), -1)
        rhat = r / rmag[:, None]
        zhat = torch.zeros_like(r)
        zhat[:, 2] = 1.0
        grad_t = (zhat - t * rhat) / rmag[:, None]
        grad_l = torch.stack([-y, x, torch.zeros_like(x)], -1) / rho2[:, None]
        return dU_dr[:, None] * rhat + dU_dt[:, None] * grad_t + dU_dl[:, None] * grad_l


# --------------------------------------------------------------- time, frames
def tdb_seconds(epoch_utc: str, tai_minus_utc_s: float) -> float:
    """TDB seconds past J2000 (2000-01-01T12:00:00 TT) of a UTC instant:
    UTC + leap seconds = TAI, + 32.184 s = TT, + the USNO periodic term."""
    t = _dt.datetime.fromisoformat(epoch_utc)
    j2000 = _dt.datetime(2000, 1, 1, 12, 0, 0)
    tt = (t - j2000).total_seconds() + tai_minus_utc_s + 32.184
    g = 6.239996 + 0.0172019699 * tt / 86_400.0
    return tt + 0.001657 * math.sin(g + 0.01671 * math.sin(g))


def _r1(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _r3(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def body_fixed_dcm(rot: dict, t_tdb: float) -> np.ndarray:
    """J2000 -> body-fixed rotation R3(W) R1(90 - delta) R3(90 + alpha) of
    the IAU model (pole right ascension and declination linear in Julian
    centuries, prime meridian linear in days)."""
    d = t_tdb / 86_400.0
    T = d / 36_525.0
    alpha = rot["alpha0_deg"] + rot["alpha_deg_per_century"] * T
    delta = rot["delta0_deg"] + rot["delta_deg_per_century"] * T
    # whole turns a day taken out before the rate multiplies the day count
    w = rot["w0_deg"] + (rot["w_deg_per_day"] - 360.0) * d + 360.0 * math.fmod(d, 1.0)
    return _r3(w * _D2R) @ _r1((90.0 - delta) * _D2R) @ _r3((90.0 + alpha) * _D2R)


# ------------------------------------------------------------ Sun ephemeris
# Principal terms of the Moon's longitude and distance (Meeus, Astronomical
# Algorithms, ch. 47): (D, M, M', F, longitude 1e-6 deg, distance 1e-3 km).
_MOON_LR = ((0, 0, 1, 0, 6288774, -20905355), (2, 0, -1, 0, 1274027, -3699111),
            (2, 0, 0, 0, 658314, -2955968), (0, 0, 2, 0, 213618, -569925),
            (0, 1, 0, 0, -185116, 48888), (0, 0, 0, 2, -114332, -3149))
_MOON_B = ((0, 0, 0, 1, 5128122), (0, 0, 1, 1, 280602), (0, 0, 1, -1, 277693),
           (2, 0, 0, -1, 173237))


def _ecl_to_eq(v, obliquity_deg):
    e = obliquity_deg * _D2R
    return np.array([v[0], math.cos(e) * v[1] - math.sin(e) * v[2],
                     math.sin(e) * v[1] + math.cos(e) * v[2]])


def _moon_geocentric(T, obliquity_deg):
    """Geocentric Moon, J2000 equatorial km, from the principal terms."""
    Lp = 218.3164477 + 481267.88123421 * T
    D = 297.8501921 + 445267.1114034 * T
    M = 357.5291092 + 35999.0502909 * T
    Mp = 134.9633964 + 477198.8675055 * T
    F = 93.2720950 + 483202.0175233 * T
    E = 1 - 0.002516 * T
    lon = lat = 0.0
    dist = 385_000.56
    for d, m, mp, f, sl, sr in _MOON_LR:
        arg = (d * D + m * M + mp * Mp + f * F) * _D2R
        lon += sl * E ** abs(m) * math.sin(arg) / 1e6
        dist += sr * E ** abs(m) * math.cos(arg) / 1e3
    for d, m, mp, f, sb in _MOON_B:
        lat += sb * math.sin((d * D + m * M + mp * Mp + f * F) * _D2R) / 1e6
    lon = (Lp + lon - 1.396971 * T) * _D2R  # of date -> J2000 ecliptic
    lat *= _D2R
    ecl = dist * np.array([math.cos(lat) * math.cos(lon), math.cos(lat) * math.sin(lon), math.sin(lat)])
    return _ecl_to_eq(ecl, obliquity_deg)


def sun_from_earth(sun: dict, t_tdb: float) -> np.ndarray:
    """Sun about the Earth, J2000 equatorial km: minus the Earth's
    heliocentric position, the Earth-Moon barycenter's from its mean
    elements (a AU, e, I, L, long. of perihelion, node; per Julian century)
    less the Moon's share of the barycentric offset."""
    T = t_tdb / (86_400.0 * 36_525.0)
    el = [x0 + x1 * T for x0, x1 in zip(sun["emb_elements"], sun["emb_rates_per_century"])]
    a, e = el[0] * sun["au_km"], el[1]
    inc, L, lp, node = (x * _D2R for x in el[2:])
    w = lp - node
    M = math.fmod(L - lp, 2 * math.pi)
    E = M
    for _ in range(30):
        E -= (E - e * math.sin(E) - M) / (1 - e * math.cos(E))
    xp, yp = a * (math.cos(E) - e), a * math.sqrt(1 - e * e) * math.sin(E)
    orb = _r3(-node) @ _r1(-inc) @ _r3(-w) @ np.array([xp, yp, 0.0])
    emb = _ecl_to_eq(orb, sun["obliquity_deg"])
    earth = emb - sun["moon_mass_fraction"] * _moon_geocentric(T, sun["obliquity_deg"])
    return -earth


# ------------------------------------------------------------ force models
def illumination(r, r_sun, sun_radius_km, occulter_radius_km):
    """1 - the occulted fraction of the Sun's apparent disk, the Earth the
    occulter at the origin: apparent radii asin(R/d), their centres theta
    apart; disjoint, nested (umbra or annulus) or overlapping (the lens of
    two circles over the Sun's disk)."""
    to_sun = r_sun - r
    d_sun = torch.linalg.vector_norm(to_sun, dim=-1)
    d_occ = torch.linalg.vector_norm(r, dim=-1)
    rs = torch.asin(sun_radius_km / d_sun)
    ro = torch.asin(occulter_radius_km / d_occ)
    cos_th = torch.sum(to_sun * -r, -1) / (d_sun * d_occ)
    th = torch.acos(torch.clamp(cos_th, -1.0, 1.0))
    disjoint = th >= rs + ro
    nested = th <= torch.abs(ro - rs)
    thp = torch.where(disjoint | nested, rs + ro, th).clamp(min=1e-12)
    c1 = torch.clamp((thp * thp + rs * rs - ro * ro) / (2 * thp * rs), -1.0, 1.0)
    c2 = torch.clamp((thp * thp + ro * ro - rs * rs) / (2 * thp * ro), -1.0, 1.0)
    k = (-thp + rs + ro) * (thp + rs - ro) * (thp - rs + ro) * (thp + rs + ro)
    lens = rs * rs * torch.acos(c1) + ro * ro * torch.acos(c2) - 0.5 * torch.sqrt(k.clamp(min=0.0))
    partial = torch.clamp(lens / (math.pi * rs * rs), 0.0, 1.0)
    inside = torch.where(ro >= rs, torch.ones_like(rs), (ro * ro) / (rs * rs))
    occulted = torch.where(disjoint, torch.zeros_like(rs), torch.where(nested, inside, partial))
    return 1.0 - occulted


class Dynamics:
    """The EOM of [L, 9] states (r, v, Cr, Cd, propellant) for one
    configuration, at `dtype` on `device`."""

    def __init__(self, cfg: dict, root: Path, dtype, device):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        f = cfg["field"]
        C, S, mu, radius = read_cof(root / f["file"], f["degree"], f["order"])
        self.field = Field(C, S, mu, radius, dtype, device)
        self.mu = cfg["central_gm_km3_s2"]
        self.t0_tdb = tdb_seconds(cfg["epoch_utc"], cfg["tai_minus_utc_s"])
        sc = cfg["spacecraft"]
        self.mass = sc["dry_mass_kg"] + sc["prop_mass_kg"]

    def __call__(self, t_rel: float, y):
        cfg, dt = self.cfg, self.dtype
        t = self.t0_tdb + t_rel
        r, v = y[:, 0:3], y[:, 3:6]
        cr, cd = y[:, 6:7], y[:, 7:8]
        rmag = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        a = -self.mu * r / rmag**3
        R = torch.as_tensor(body_fixed_dcm(cfg["body_rotation"], t), dtype=dt, device=self.device)
        a = a + self.field.accel(r @ R.T) @ R
        srp = cfg["srp"]
        r_sun = torch.as_tensor(sun_from_earth(cfg["sun"], t), dtype=dt, device=self.device)
        k = illumination(r, r_sun, srp["sun_radius_km"], srp["occulter_radius_km"])[:, None]
        away = r - r_sun
        d_sun = torch.linalg.vector_norm(away, dim=-1, keepdim=True)
        p = k * (srp["flux_w_m2"] / srp["speed_of_light_m_s"]) * (srp["au_km"] / d_sun) ** 2
        a = a + 1e-3 * cr * (cfg["spacecraft"]["srp_area_m2"] / self.mass) * p * away / d_sun
        drag = cfg["drag"]
        w = drag["omega_deg_per_day"] * _D2R / 86_400.0
        v_rel = v - torch.stack([-w * r[:, 1], w * r[:, 0], torch.zeros_like(r[:, 0])], -1)
        alt_m = (rmag - drag["body_radius_km"]) * 1e3
        rho = drag["rho0_kg_m3"] * torch.exp(-(alt_m - drag["r0_m"]) / drag["scale_height_m"])
        vmag = torch.linalg.vector_norm(v_rel, dim=-1, keepdim=True)
        a = a - 0.5e3 * rho * cd * (cfg["spacecraft"]["drag_area_m2"] / self.mass) * vmag * v_rel
        return torch.cat([v, a, torch.zeros_like(y[:, 6:9])], -1)

    def shadow_regime(self, t_rel: float, y):
        """Per lane 0 lit, 1 penumbra, 2 umbra."""
        srp = self.cfg["srp"]
        r_sun = torch.as_tensor(sun_from_earth(self.cfg["sun"], self.t0_tdb + t_rel),
                                dtype=self.dtype, device=self.device)
        k = illumination(y[:, 0:3], r_sun, srp["sun_radius_km"], srp["occulter_radius_km"])
        return torch.where(k >= 1.0, 0, torch.where(k <= 0.0, 2, 1))


# ---------------------------------------------------------------- integrator
def _gbs_step(f, t, y, H, seq):
    """One macro step of H: modified midpoint with n = seq[j] substeps,
    extrapolated to h = 0 in h^2 (Aitken-Neville)."""
    f0 = f(t, y)
    table = []
    for j, n in enumerate(seq):
        h = H / n
        z0, z1 = y, y + h * f0
        for m in range(1, n):
            z0, z1 = z1, z0 + (2 * h) * f(t + m * h, z1)
        row = [0.5 * (z0 + z1 + h * f(t + H, z1))]
        for i in range(1, j + 1):
            row.append(row[i - 1] + (row[i - 1] - table[i - 1]) / ((n / seq[j - i]) ** 2 - 1.0))
        table = row
    return table[-1]


def gbs(f, y0, duration_s: float, macro_step_s: float, columns: int, regime=None,
        refine: int = 1, refine_columns: int = 0):
    """Gragg-Bulirsch-Stoer on a fixed grid of macro steps (at most
    `macro_step_s`), n = 2, 4, ..., 2 columns substeps. Extrapolation
    assumes a smooth right-hand side: a macro step over which
    `regime(t, y)` (a per-lane integer, such as lit, penumbra or umbra) is
    not the same at both ends for every lane is done again as `refine`
    macro steps of `refine_columns` columns (0: `columns`), so the kink of a
    shadow boundary costs a step of H/refine and not of H."""
    steps = max(1, math.ceil(duration_s / macro_step_s - 1e-9))
    H = duration_s / steps
    seq = [2 * (j + 1) for j in range(columns)]
    y, t = y0, 0.0
    for _ in range(steps):
        y1 = _gbs_step(f, t, y, H, seq)
        if regime is not None and refine > 1:
            g0, g1 = regime(t, y), regime(t + H, y1)
            if bool(((g0 != g1) | (g0 == 1) | (g1 == 1)).any()):
                y1, h = y, H / refine
                for i in range(refine):
                    y1 = _gbs_step(f, t + i * h, y1, h, seq[: refine_columns or columns])
        y, t = y1, t + H
    return y


# ------------------------------------------------------------------- draws
def cartesian(mu, sma, ecc, inc, raan, aop, ta):
    """(r, v) from Keplerian elements (radians)."""
    p = sma * (1 - ecc * ecc)
    r_pf = p / (1 + ecc * math.cos(ta)) * np.array([math.cos(ta), math.sin(ta), 0.0])
    v_pf = math.sqrt(mu / p) * np.array([-math.sin(ta), ecc + math.cos(ta), 0.0])
    rot = _r3(-raan) @ _r1(-inc) @ _r3(-aop)
    return rot @ r_pf, rot @ v_pf


def _elements(y, mu):
    """sma (km), inc and raan (deg) of a 9-state tensor."""
    r, v = y[0:3], y[3:6]
    h = torch.linalg.cross(r, v)
    sma = 1.0 / (2.0 / torch.linalg.vector_norm(r) - torch.dot(v, v) / mu)
    inc = torch.acos(h[2] / torch.linalg.vector_norm(h)) / _D2R
    raan = torch.atan2(h[0], -h[1]) / _D2R
    return {"sma": sma, "inc": inc, "raan": raan}


def nominal_state(cfg: dict) -> np.ndarray:
    o, sc = cfg["orbit"], cfg["spacecraft"]
    r, v = cartesian(cfg["central_gm_km3_s2"], o["sma_km"], o["ecc"], o["inc_deg"] * _D2R,
                     o["raan_deg"] * _D2R, o["aop_deg"] * _D2R, o["ta_deg"] * _D2R)
    return np.concatenate([r, v, [sc["cr"], sc["cd"], sc["prop_mass_kg"]]])


def draw_square_root(cfg: dict):
    """(mean [9], S [9, 9]) with draws mean + z S^T: the dispersed
    parameters' covariance mapped to the state by the pseudo-inverse of
    their Jacobian, and its symmetric SVD's U sqrt(s)."""
    mu = cfg["central_gm_km3_s2"]
    nominal = nominal_state(cfg)
    names = [d[0] for d in cfg["dispersions"]]
    sig = np.array([d[1] for d in cfg["dispersions"]])
    jac = torch.autograd.functional.jacobian(
        lambda y: torch.stack([_elements(y, mu)[n] for n in names]),
        torch.tensor(nominal, dtype=torch.float64)).numpy()
    jinv = np.linalg.pinv(jac)
    cov = jinv @ np.diag(sig**2) @ jinv.T
    u, s, _ = np.linalg.svd(cov, hermitian=True)
    return nominal, u @ np.diag(np.sqrt(np.maximum(s, 0.0)))


def draws(cfg: dict, seeds, lanes_per_call: int, picks) -> np.ndarray:
    """Initial states [len(picks), 9] of the (call k, lane i) pairs in
    `picks`: row i of torch.randn((lanes_per_call, 9)) from a CPU generator
    seeded with seeds[k], through the square root."""
    mean, root = draw_square_root(cfg)
    out = np.zeros((len(picks), 9))
    by_call = {}
    for j, (k, i) in enumerate(picks):
        by_call.setdefault(k, []).append((j, i))
    for k, items in sorted(by_call.items()):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seeds[k])
        z = torch.randn((lanes_per_call, 9), generator=gen, dtype=torch.float64)
        rows = z[torch.tensor([i for _, i in items])].numpy()
        out[[j for j, _ in items]] = mean + rows @ root.T
    return out


def propagate(cfg: dict, root: Path, y0: np.ndarray, duration_s: float, *, dtype=torch.float64,
              device="cpu") -> np.ndarray:
    """Final [L, 9] states of `y0` after `duration_s`, at `dtype`."""
    dyn = Dynamics(cfg, root, dtype, device)
    ref = cfg["reference"]
    y = torch.as_tensor(y0, dtype=dtype, device=device)
    yf = gbs(dyn, y, duration_s, ref["macro_step_s"], ref["columns"], dyn.shadow_regime,
             ref["refine"], ref["refine_columns"])
    return yf.to(torch.float64).cpu().numpy()
