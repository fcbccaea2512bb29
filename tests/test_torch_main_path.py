"""Main-path parity: the PyTorch port (nyx_tpu_torch) against nyx_tpu.

Module by module along the Monte Carlo path (time, orbit elements, the IAU
Earth rotation, the conical shadow, the Chebyshev Sun table, SRP, drag, the
EOM, the dispersion covariance), then the whole slice: the same numpy
initial states through both packages' `MonteCarlo.run_until_epoch`. Inputs
come from numpy seeds; JAX runs on the CPU in float64.

Tolerances: 1e-12 relative where both packages compute in float64 (the same
formulas; only the order of a few sums differs). Where the reference itself
computes in float32 the bound is stated at the test.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nyx_tpu as R
from nyx_tpu import time as r_time
from nyx_tpu.constants import NAIF
from nyx_tpu.cosmic import eclipse as r_eclipse
from nyx_tpu.cosmic import orbit as r_orbit
from nyx_tpu.cosmic import rotations as r_rot
from nyx_tpu.dynamics import Drag as RDrag
from nyx_tpu.dynamics import Harmonics as RHarmonics
from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
from nyx_tpu.dynamics import SolarPressure as RSolarPressure
from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
from nyx_tpu.ephem.almanac import Almanac as RAlmanac
from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
from nyx_tpu.mc import MonteCarlo as RMonteCarlo
from nyx_tpu.mc import MvnSpacecraft as RMvnSpacecraft
from nyx_tpu.mc import StateDispersion as RStateDispersion
from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
from nyx_tpu.propagators import Propagator as RPropagator

import nyx_tpu_torch as P
from nyx_tpu_torch import time as p_time
from nyx_tpu_torch.cosmic import eclipse, orbit, rotations
from nyx_tpu_torch.dynamics import (
    Drag,
    Harmonics,
    OrbitalDynamics,
    SolarPressure,
    SpacecraftDynamics,
)
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.interop import ephem_table_from_numpy, states_from_numpy
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator, integrator

ROOT = Path(__file__).parents[1]
JGM3 = ROOT / "data/JGM3.cof.gz"
F64_REL = 1e-12


def _rel(a, b):
    """Max over lanes of |a - b| / |b|, norms over the last axis; a lane
    where b is zero must match exactly."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    num, den = np.linalg.norm(a - b, axis=-1), np.linalg.norm(b, axis=-1)
    assert (num[den == 0] == 0).all()
    return float((num[den > 0] / den[den > 0]).max())


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _j(x, dtype=jnp.float64):
    return jnp.asarray(np.asarray(x), dtype)


def _spacecraft(M):
    epoch = M.Epoch.from_gregorian_utc(2021, 3, 4)
    o = M.Orbit.keplerian(7136.6, 2e-4, 51.6, 30.0, 65.0, 80.0, epoch, M.Frames.EME2000)
    return epoch, M.Spacecraft.new(o, 100.0, 0.0, 2.0, 2.0, 1.8, 2.2)


def _dynamics(degree, precision):
    """(reference, port) SpacecraftDynamics: JGM3 harmonics + SRP + drag."""
    r_stor = RGravityFieldData.from_cof(JGM3, degree, degree, True, R.Frames.IAU_EARTH)
    ref = RSpacecraftDynamics(
        ROrbitalDynamics.from_model(
            RHarmonics.from_stor(r_stor, precision=precision), R.Frames.EME2000
        ),
        (RSolarPressure.default(), RDrag.earth_exp()),
    )
    stor = GravityFieldData.from_cof(JGM3, degree, degree, True, P.Frames.IAU_EARTH)
    port = SpacecraftDynamics(
        OrbitalDynamics.from_model(Harmonics.from_stor(stor, precision=precision), P.Frames.EME2000),
        (SolarPressure.default(), Drag.earth_exp()),
    )
    return ref, port


def _lanes(n, seed, spread=False):
    """[n, 9] LEO states dispersed around the Config 2 orbit; `spread`
    places them around the whole orbit (in sunlight and in shadow)."""
    _, sc = _spacecraft(R)
    rng = np.random.default_rng(seed)
    y = np.tile(sc.to_vector(), (n, 1))
    if spread:
        ta = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
        r, v = r_orbit.cartesian_from_keplerian(
            7136.6, 2e-4, np.radians(51.6), np.radians(30.0), np.radians(65.0), _j(ta),
            R.Frames.EME2000.mu,
        )
        y[:, 0:3], y[:, 3:6] = np.asarray(r), np.asarray(v)
    scale = np.array([2.0, 2.0, 2.0, 2e-3, 2e-3, 2e-3, 0.05, 0.05, 0.0])
    return y + rng.normal(size=(n, 9)) * scale


@pytest.mark.parametrize(
    "ymdhms", [(2021, 3, 4, 0, 0, 0.0), (2016, 12, 31, 23, 59, 59.5), (1999, 7, 1, 12, 30, 1.25)]
)
def test_epoch_to_tdb(ymdhms):
    """Epoch two-part TAI, the leap table and TDB: the same host arithmetic,
    and the tensor branch of tdb_minus_tt at f64."""
    e_ref = R.Epoch.from_gregorian_utc(*ymdhms)
    e = P.Epoch.from_gregorian_utc(*ymdhms)
    assert (e.tai_int, e.tai_frac) == (e_ref.tai_int, e_ref.tai_frac)
    assert e.to_tdb_seconds() == pytest.approx(e_ref.to_tdb_seconds(), rel=F64_REL)
    later = e + 86_400.5
    assert (later - e).to_seconds() == 86_400.5
    assert later.to_tdb_seconds() == pytest.approx((e_ref + 86_400.5).to_tdb_seconds(), rel=F64_REL)
    tt = e_ref.to_tt_seconds() + np.linspace(0.0, 3.0e7, 16)
    np.testing.assert_allclose(
        p_time.tdb_minus_tt(_t(tt)).numpy(), np.asarray(r_time.tdb_minus_tt(_j(tt))),
        rtol=F64_REL, atol=1e-18,
    )


def test_keplerian_cartesian_both_ways():
    """Batched Keplerian -> Cartesian -> Keplerian at f64."""
    rng = np.random.default_rng(1)
    n = 32
    el = dict(
        sma=rng.uniform(6800.0, 42000.0, n), ecc=rng.uniform(0.001, 0.7, n),
        inc=rng.uniform(0.1, 3.0, n), raan=rng.uniform(0.1, 6.1, n),
        aop=rng.uniform(0.1, 6.1, n), ta=rng.uniform(0.1, 6.1, n),
    )
    keys = ("sma", "ecc", "inc", "raan", "aop", "ta")
    mu = R.Frames.EME2000.mu
    r_ref, v_ref = r_orbit.cartesian_from_keplerian(*(_j(el[k]) for k in keys), mu)
    r, v = orbit.cartesian_from_keplerian(*(_t(el[k]) for k in keys), mu)
    assert _rel(r.numpy(), r_ref) < F64_REL and _rel(v.numpy(), v_ref) < F64_REL

    back_ref = r_orbit.keplerian_from_cartesian(r_ref, v_ref, mu)
    back = orbit.keplerian_from_cartesian(_t(r_ref), _t(v_ref), mu)
    for k in keys:
        np.testing.assert_allclose(back[k].numpy(), np.asarray(back_ref[k]), rtol=F64_REL, err_msg=k)
    np.testing.assert_allclose(back["sma"].numpy(), el["sma"], rtol=1e-9)

    _, sc_ref = _spacecraft(R)
    _, sc = _spacecraft(P)
    np.testing.assert_allclose(sc.to_vector(), sc_ref.to_vector(), rtol=F64_REL, atol=1e-12)


def test_iau_earth_rotations():
    """The f64 IAU Earth DCM, the split-precision (f32 rows, f64 pole) DCM,
    and the elementwise DCM products."""
    rng = np.random.default_rng(2)
    t = 6.68e8 + rng.uniform(-3e8, 3e8, 40)
    dcm_ref = np.asarray(r_rot.iau_earth_dcm(_j(t)))
    dcm = rotations.iau_earth_dcm(_t(t)).numpy()
    # DCM entries are O(1): absolute bound at f64 round-off of the angles
    np.testing.assert_allclose(dcm, dcm_ref, rtol=0, atol=F64_REL)

    d32_ref, pole_ref = r_rot.iau_earth_dcm32_pole(_j(t))
    d32, pole = rotations.iau_earth_dcm32_pole(_t(t))
    assert d32.dtype == torch.float32 and pole.dtype == torch.float64
    np.testing.assert_allclose(pole.numpy(), np.asarray(pole_ref), rtol=0, atol=F64_REL)
    # f32 trig of the same f64-reduced angle: a few f32 ulps of 1
    np.testing.assert_allclose(d32.numpy(), np.asarray(d32_ref), rtol=0, atol=1e-6)

    v = rng.normal(size=(40, 3)) * 7000.0
    assert _rel(rotations.apply_dcm(_t(dcm), _t(v)).numpy(),
                np.asarray(r_rot.apply_dcm(_j(dcm), _j(v)))) < F64_REL
    assert _rel(rotations.apply_dcm_t(_t(dcm), _t(v)).numpy(),
                np.asarray(r_rot.apply_dcm_t(_j(dcm), _j(v)))) < F64_REL


def _shadow_geometry(n):
    """Spacecraft positions sweeping through Earth's umbra and penumbra."""
    sun = np.array([1.2e8, -8.0e7, -3.5e7])
    s_hat = sun / np.linalg.norm(sun)
    perp = np.cross(s_hat, [0.0, 0.0, 1.0])
    perp /= np.linalg.norm(perp)
    edge = np.arcsin(6378.1363 / 7000.0)
    theta = np.linspace(edge - 0.02, edge + 0.02, n)
    r = 7000.0 * (np.cos(theta)[:, None] * -s_hat + np.sin(theta)[:, None] * perp)
    return sun[None] - r, -r


def test_illumination_factor():
    """Conical shadow through lit, penumbra and umbra lanes. Lit and umbra
    lanes agree exactly. The penumbra fraction is ill-conditioned in both
    packages: the lens area subtracts O(1) terms (the Earth's apparent
    radius is ~1 rad) to get O(1e-5) (the Sun's disk), losing about eight
    digits, so one-ulp differences in the norms and arccos move it by
    ~1e-9 at f64 (bound 1e-7 here), and at f32 leave nothing to compare:
    f32 lanes are held to each other only where the f64 fraction is 0 or 1
    with a margin."""
    to_sun, to_earth = _shadow_geometry(200)
    k_ref = np.asarray(r_eclipse.illumination_factor(_j(to_sun), [(_j(to_earth), 6378.1363)]))
    k = eclipse.illumination_factor(_t(to_sun), [(_t(to_earth), 6378.1363)]).numpy()
    pen = (k_ref > 0) & (k_ref < 1)
    assert (k_ref == 0).any() and (k_ref == 1).any() and pen.any()
    np.testing.assert_array_equal(k[~pen], k_ref[~pen])
    np.testing.assert_allclose(k[pen], k_ref[pen], rtol=0, atol=1e-7)

    k32_ref = np.asarray(r_eclipse.illumination_factor(
        _j(to_sun, jnp.float32), [(_j(to_earth, jnp.float32), 6378.1363)]))
    k32 = eclipse.illumination_factor(
        _t(to_sun, torch.float32), [(_t(to_earth, torch.float32), 6378.1363)]).numpy()
    assert k32.dtype == np.float32
    clear = ~np.convolve(pen, np.ones(21), mode="same").astype(bool)
    assert clear.sum() > 100
    np.testing.assert_array_equal(k32[clear], k32_ref[clear])
    np.testing.assert_array_equal(k32[clear], k_ref[clear])


@pytest.mark.parametrize("days", [0.0, 1.0, 40.0])
def test_ephem_table_position(days):
    """Almanac.build_table gives the reference's Chebyshev coefficients, and
    EphemTable.position agrees at f64 and, through the f32 record/tau path,
    at f32 (1e-6 relative: f32 Clenshaw rounding, ~1e-7 per term)."""
    epoch, _ = _spacecraft(R)
    start, end = epoch, epoch + days * 86_400.0
    bodies = [NAIF.SUN, NAIF.MOON]
    tab_ref = RAlmanac().build_table(bodies, NAIF.EARTH, start, end)
    tab = Almanac().build_table(bodies, NAIF.EARTH, P.Epoch(start.tai_int, start.tai_frac),
                                P.Epoch(end.tai_int, end.tai_frac), device="cpu")
    np.testing.assert_array_equal(tab.coeffs.numpy(), np.asarray(tab_ref.coeffs))
    injected = ephem_table_from_numpy(float(tab_ref.t0), float(tab_ref.intlen),
                                      np.asarray(tab_ref.coeffs), tab_ref.bodies, device="cpu")
    t = start.to_tdb_seconds() + np.random.default_rng(3).uniform(0, max(days, 0.1) * 86_400.0, 64)
    for idx in range(len(bodies)):
        p_ref = np.asarray(tab_ref.position(idx, _j(t)))
        assert _rel(tab.position(idx, _t(t)).numpy(), p_ref) < F64_REL
        assert _rel(injected.position(idx, _t(t)).numpy(), p_ref) < F64_REL
        p32_ref = np.asarray(tab_ref.position(idx, _j(t), dtype=jnp.float32))
        p32 = tab.position(idx, _t(t), dtype=torch.float32)
        assert p32.dtype == torch.float32
        assert _rel(p32.numpy(), p32_ref) < 1e-6


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_srp_and_drag(dtype):
    """SRP (Sun table + shadow) and drag per unit mass. At f32, where the
    EOM evaluates them, 1e-5 relative: f32 Sun position and shadow
    geometry, both within a few hundred f32 ulps."""
    ref_dyn, dyn = _dynamics(2, "f64")
    epoch, _ = _spacecraft(R)
    ctx_ref = ref_dyn.build_context(epoch, 7200.0, RAlmanac())
    ctx = dyn.build_context(P.Epoch(epoch.tai_int, epoch.tai_frac), 7200.0, Almanac(), device="cpu")
    y = _lanes(32, 4, spread=True)
    t = ctx_ref.epoch0_tdb + np.linspace(0.0, 7200.0, 32)
    jdt, tdt, tol = (
        (jnp.float64, torch.float64, F64_REL) if dtype == "f64" else (jnp.float32, torch.float32, 1e-5)
    )
    sc_ref = dict(cr=_j(y[:, 6], jdt), cd=_j(y[:, 7], jdt), srp_area_m2=2.0, drag_area_m2=2.0,
                  mass_kg=_j(100.0 + y[:, 8], jdt))
    sc = dict(cr=_t(y[:, 6], tdt), cd=_t(y[:, 7], tdt), srp_area_m2=2.0, drag_area_m2=2.0,
              mass_kg=_t(100.0 + y[:, 8], tdt))
    for fm_ref, fm in zip(ref_dyn.force_models, dyn.force_models):
        a_ref = np.asarray(fm_ref.force_per_mass(ctx_ref, _j(t), _j(y[:, :3], jdt),
                                                 _j(y[:, 3:6], jdt), sc_ref))
        a = fm.force_per_mass(ctx, _t(t), _t(y[:, :3], tdt), _t(y[:, 3:6], tdt), sc)
        assert a.dtype == tdt
        assert _rel(a.numpy(), a_ref) < tol, type(fm).__name__


@pytest.mark.parametrize("precision", ["f64", "split"])
def test_make_eom_and_finally(precision):
    """The EOM (two-body + 8x8 JGM3 + SRP + drag, forces at f32) and the Cr
    clamp. At f64 gravity the accelerations agree to 1e-12; at split
    precision the f32 part of the field (about 1e-3 of the acceleration,
    itself held to 2e-5 in test_torch_gravity) bounds them at 1e-7."""
    ref_dyn, dyn = _dynamics(8, precision)
    epoch, _ = _spacecraft(R)
    ctx_ref = ref_dyn.build_context(epoch, 7200.0, RAlmanac())
    ctx = dyn.build_context(P.Epoch(epoch.tai_int, epoch.tai_frac), 7200.0, Almanac(), device="cpu")
    p = dict(dry_mass_kg=100.0, srp_area_m2=2.0, drag_area_m2=2.0)
    y = _lanes(32, 5, spread=True)
    y[:4, 6] = [-0.5, 2.5, 1.0, 3.0]  # Cr outside [0, 2] for the clamp
    t = np.linspace(0.0, 7200.0, 32)
    d_ref = np.asarray(ref_dyn.make_eom()(_j(t), _j(y), ctx_ref, p))
    d = dyn.make_eom()(_t(t), _t(y), ctx, p).numpy()
    np.testing.assert_array_equal(d[:, 0:3], d_ref[:, 0:3])
    np.testing.assert_array_equal(d[:, 6:9], d_ref[:, 6:9])
    assert _rel(d[:, 3:6], d_ref[:, 3:6]) < (F64_REL if precision == "f64" else 1e-7)

    fin_ref = np.asarray(ref_dyn.make_finally()(_j(t), _j(y), ctx_ref, p))
    fin = dyn.make_finally()(_t(t), _t(y), ctx, p).numpy()
    np.testing.assert_array_equal(fin, fin_ref)


def test_dispersion_covariance():
    """MvnSpacecraft: the parameter Jacobian (torch.func.jacfwd) and the
    rotated covariance match the reference's (jax.jacfwd)."""
    _, sc_ref = _spacecraft(R)
    _, sc = _spacecraft(P)
    disp = [("sma", 0.5), ("inc", 0.01), ("raan", 0.01)]
    ref = RMvnSpacecraft(sc_ref, [RStateDispersion(*d) for d in disp])
    mvn = MvnSpacecraft(sc, [StateDispersion(*d) for d in disp])
    scale = np.abs(ref.covar).max()
    np.testing.assert_allclose(mvn.covar, ref.covar, rtol=0, atol=1e-9 * scale)
    gen = torch.Generator().manual_seed(0)
    draws = mvn.sample(4096, gen, device="cpu")
    assert draws.dtype == torch.float64 and draws.shape == (4096, 9)
    emp = np.cov(draws.numpy().T)
    assert abs(emp[0, 0] / mvn.covar[0, 0] - 1.0) < 0.1


def test_monte_carlo_slice_matches_reference():
    """The whole slice: B = 8 identical initial states through both
    packages' MonteCarlo.run_until_epoch (RK89 at 1e-9, 8x8 JGM3 split
    precision, SRP + drag, a 2-hour arc). Adaptive step sequences may
    differ by a step where an f32 rounding flips an accept; final positions
    stay within 1e-4 km."""
    ref_dyn, dyn = _dynamics(8, "split")
    epoch_ref, sc_ref = _spacecraft(R)
    epoch, sc = _spacecraft(P)
    y0 = _lanes(8, 6)
    ref = RMonteCarlo(RMvnSpacecraft(sc_ref, [RStateDispersion("sma", 0.5)]), seed=1)
    res_ref = ref.run_until_epoch(
        RPropagator.rk89(ref_dyn, RIntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9)),
        RAlmanac(), epoch_ref + 7200.0, 8, _y0=jnp.asarray(y0),
    )
    mc = MonteCarlo(MvnSpacecraft(sc, [StateDispersion("sma", 0.5)]), seed=1)
    res = mc.run_until_epoch(
        Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9)),
        Almanac(), epoch + 7200.0, 8, device="cpu", _y0=states_from_numpy(y0, device="cpu"),
    )
    assert res.n_runs == res_ref.n_runs == 8
    assert res.n_ok == res_ref.n_ok == 8
    d_km = np.linalg.norm(res.y_final[:, :3] - res_ref.y_final[:, :3], axis=1).max()
    assert d_km < 1e-4, d_km
    assert abs(np.mean(res.n_accepted) - np.mean(res_ref.n_accepted)) <= 2
    np.testing.assert_array_equal(res.y_initial, y0)


def test_integrator_lane_status():
    """Per-lane status: a zero-duration lane is DONE with no step, a lane
    whose state turns NaN is FAILED_NAN, the others land on the stop time."""
    def eom(t, y):
        out = torch.zeros_like(y)
        out[:, 0] = y[:, 1]
        out[:, 1] = -y[:, 0]
        out[2] = float("nan")
        return out

    y0 = torch.tensor([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    dur = torch.tensor([3.0, 0.0, 3.0], dtype=torch.float64)
    res = integrator.propagate(eom, y0, dur, IntegratorOptions.with_adaptive_step(1e-3, 1.0, 1e-10))
    assert res.status.tolist() == [integrator.DONE, integrator.DONE, integrator.FAILED_NAN]
    assert res.n_accepted[1] == 0 and res.t[0] == 3.0
    np.testing.assert_allclose(res.y[0].numpy(), [np.cos(3.0), -np.sin(3.0)], atol=1e-8)


def test_port_never_imports_jax():
    """Importing the port, all its modules included, pulls in neither JAX
    nor the JAX package."""
    code = (
        "import sys, nyx_tpu_torch, nyx_tpu_torch.mc, nyx_tpu_torch.dynamics, "
        "nyx_tpu_torch.interop, nyx_tpu_torch.ephem, nyx_tpu_torch.md; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nyx_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
