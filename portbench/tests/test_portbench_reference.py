"""The plain reference, piece by piece, against closed forms, an
independent evaluation and (in the tests only) the program's own values."""

import math

import numpy as np
import pytest
import torch
from scipy.special import lpmv

from pbench import reference as R
from pbench import spec

CFG = spec.resolve("leo21.mc_2m_1h").config
COF = spec.ROOT / "data" / "JGM3.cof.gz"


def _potential(C, S, mu, radius, r):
    """U of degrees 2..N by scipy's Legendre functions, normalized here."""
    x, y, z = r
    rm = math.sqrt(x * x + y * y + z * z)
    t, lam = z / rm, math.atan2(y, x)
    u = 0.0
    for n in range(2, C.shape[0]):
        for m in range(0, min(n, C.shape[1] - 1) + 1):
            norm = math.sqrt((2 - (m == 0)) * (2 * n + 1) * math.factorial(n - m) / math.factorial(n + m))
            p = (-1) ** m * lpmv(m, n, t) * norm  # scipy carries the Condon-Shortley phase
            u += (radius / rm) ** n * p * (C[n, m] * math.cos(m * lam) + S[n, m] * math.sin(m * lam))
    return mu / rm * u


def test_field_is_the_gradient_of_its_potential():
    C, S, mu, radius = R.read_cof(COF, 8, 8)
    field = R.Field(C, S, mu, radius, torch.float64, "cpu")
    r = np.array([4100.0, -3900.0, 4300.0])
    a = field.accel(torch.tensor(r)[None])[0].numpy()
    h = 1e-3
    g = [(_potential(C, S, mu, radius, r + h * e) - _potential(C, S, mu, radius, r - h * e)) / (2 * h)
         for e in np.eye(3)]
    assert np.allclose(a, g, rtol=1e-7, atol=1e-15)


def test_zonal_j2_closed_form():
    C, S, mu, radius = R.read_cof(COF, 2, 0)
    field = R.Field(C, S, mu, radius, torch.float64, "cpu")
    r = np.array([5000.0, 2000.0, 4500.0])
    a = field.accel(torch.tensor(r)[None])[0].numpy()
    j2 = -math.sqrt(5.0) * C[2, 0]
    rm = np.linalg.norm(r)
    k = -1.5 * j2 * mu * radius**2 / rm**5
    zz = 5 * r[2] ** 2 / rm**2
    expect = k * np.array([r[0] * (1 - zz), r[1] * (1 - zz), r[2] * (3 - zz)])
    assert np.allclose(a, expect, rtol=1e-12)


def test_gbs_two_body_matches_kepler():
    mu = CFG["central_gm_km3_s2"]
    r0, v0 = R.cartesian(mu, 7136.6, 0.0002, 0.9, 0.5, 1.1, 1.4)
    y0 = torch.tensor(np.concatenate([r0, v0]))[None]

    def f(t, y):
        r = y[:, :3]
        return torch.cat([y[:, 3:], -mu * r / torch.linalg.vector_norm(r, dim=-1, keepdim=True) ** 3], -1)

    T = 3600.0
    y = R.gbs(f, y0, T, 120.0, 5)[0].numpy()
    # Kepler: advance the mean anomaly from the same elements
    a_, e_ = 7136.6, 0.0002
    E0 = 2 * math.atan(math.sqrt((1 - e_) / (1 + e_)) * math.tan(1.4 / 2))
    M = E0 - e_ * math.sin(E0) + math.sqrt(mu / a_**3) * T
    E = M
    for _ in range(30):
        E -= (E - e_ * math.sin(E) - M) / (1 - e_ * math.cos(E))
    ta = 2 * math.atan2(math.sqrt(1 + e_) * math.sin(E / 2), math.sqrt(1 - e_) * math.cos(E / 2))
    r1, _ = R.cartesian(mu, a_, e_, 0.9, 0.5, 1.1, ta)
    assert np.linalg.norm(y[:3] - r1) < 1e-8


def test_illumination_lit_umbra_penumbra():
    sun = torch.tensor([1.496e8, 0.0, 0.0], dtype=torch.float64)
    r = torch.tensor([[7000.0, 0.0, 0.0], [-7000.0, 0.0, 0.0], [-7000.0, 6378.1363 + 0.3, 0.0]],
                     dtype=torch.float64)
    k = R.illumination(r, sun, 695_700.0, 6378.1363).numpy()
    assert k[0] == 1.0 and k[1] == 0.0 and 0.0 < k[2] < 1.0


def test_time_frame_sun_and_draws_agree_with_the_program():
    from nyx_tpu_torch import Epoch
    from nyx_tpu_torch.constants import NAIF
    from nyx_tpu_torch.cosmic.rotations import iau_earth_dcm
    from nyx_tpu_torch.ephem.almanac import Almanac
    from pbench import scene

    t = R.tdb_seconds(CFG["epoch_utc"], CFG["tai_minus_utc_s"])
    assert t == pytest.approx(Epoch.from_gregorian_utc(2021, 3, 4).to_tdb_seconds(), abs=1e-6)
    for dt in (0.0, 3600.0, 86_400.0):
        ours = R.body_fixed_dcm(CFG["body_rotation"], t + dt)
        theirs = iau_earth_dcm(torch.tensor(t + dt, dtype=torch.float64)).numpy()
        assert np.abs(ours - theirs).max() < 1e-12
        sun = R.sun_from_earth(CFG["sun"], t + dt)
        assert np.linalg.norm(sun - Almanac().position(NAIF.SUN, NAIF.EARTH, t + dt)) < 100.0
    s = scene.build(CFG, spec.ROOT, 1)
    mean, root = R.draw_square_root(CFG)
    assert np.allclose(root @ root.T, s.mc.random_state.covar, rtol=1e-9, atol=1e-18)
    assert np.allclose(mean[:6], s.template.to_vector()[:6], rtol=1e-14)
