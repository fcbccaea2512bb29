"""Config 3 parity: covariance mapping and the Monte Carlo of
examples/02_jwst_covar_monte_carlo.py through the port against nyx_tpu,
with trajectory capture, the ensemble's queries and exports, and the Encke
deviation mode.

The slice: `SolarPressure.cislunar`; `MvnSpacecraft.new` and
`from_covariance`; `integrator.propagate(state_dtype=...)`;
`MonteCarlo.run_until_epoch` with `skip`, `max_lanes_per_call`,
`n_capture` and `capture_stride`, `resume_run_until_epoch` and
`run_until_nth_event`; `Results` whole (`every_value_of`,
`first_values_of`, `trajectory`, `locate_nth_event`, `truncated`,
`concatenate`, `to_parquet` in its three forms); `ScanKalmanOD.predict_for`
at ex02's scene; `mc/encke.py` and `MonteCarlo.run_until_epoch_encke`.

Inputs come from seeds and reach both packages unchanged: the port's draws
go to the reference as `_y0` (and, for its Encke mode, which takes no
`_y0`, through `generate_states` replaced on the reference's instance);
identical capture buffers go to both packages' `Results`. JAX runs on the
CPU in float64; the port runs on the CPU. Each tolerance is stated at its
test, and `-s` prints the measured gaps. Everything of the slice lives in
this one file because every test worker pays both the JAX and the torch
import.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import nyx_tpu as R
from nyx_tpu.constants import NAIF as RNAIF
from nyx_tpu.dynamics import Drag as RDrag
from nyx_tpu.dynamics import Harmonics as RHarmonics
from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
from nyx_tpu.dynamics import PointMasses as RPointMasses
from nyx_tpu.dynamics import SolarPressure as RSolarPressure
from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
from nyx_tpu.ephem.almanac import Almanac as RAlmanac
from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
from nyx_tpu.mc import MonteCarlo as RMonteCarlo
from nyx_tpu.mc import MvnSpacecraft as RMvnSpacecraft
from nyx_tpu.mc import Results as RResults
from nyx_tpu.mc import StateDispersion as RStateDispersion
from nyx_tpu.mc import encke as rencke
from nyx_tpu.md.events import Event as REvent
from nyx_tpu.md.trajectory import Trajectory as RTrajectory
from nyx_tpu.od import GroundStation as RGroundStation
from nyx_tpu.od import MeasurementType as RMeasurementType
from nyx_tpu.od import SpacecraftUncertainty as RSpacecraftUncertainty
from nyx_tpu.od.scan_filter import ScanKalmanOD as RScanKalmanOD
from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
from nyx_tpu.propagators import Propagator as RPropagator

import chip_smoke
import nyx_tpu_torch as P
from nyx_tpu_torch.constants import NAIF
from nyx_tpu_torch.dynamics import (
    Drag, Harmonics, OrbitalDynamics, SolarPressure, SpacecraftDynamics,
)
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.errors import MonteCarloError
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, Results, StateDispersion, encke
from nyx_tpu_torch.md.events import Event
from nyx_tpu_torch.od.scan_filter import filter_scan
from nyx_tpu_torch.propagators import IntegratorMethod, IntegratorOptions, Propagator
from nyx_tpu_torch.propagators import integrator

ROOT = Path(__file__).parents[1]
JGM3 = ROOT / "data" / "JGM3.cof.gz"
EX02_EPOCH = (2024, 6, 1, 0, 0, 0)
EX02_KEPLER = (180_000.0, 0.7, 28.0, 80.0, 90.0, 140.0)
# ex02 at a small size: lanes, arc (s), capture
EX02_B = 8
EX02_SECONDS = 86_400.0
EX02_SEED = 2024
LEO_EPOCH = (2021, 3, 4)
LEO_KEPLER = (7136.6, 2e-4, 51.6, 30.0, 65.0, 80.0)


def _rel(a, b) -> float:
    """max |a - b| over max |b| (0 when both are 0)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 else float(np.abs(a).max())


# ----------------------------------------------------------------- scenes
def _ref_ex02():
    """ex02's scene through the reference's names (the example's own
    lines 41-96)."""
    alm = RAlmanac()
    epoch = R.Epoch.from_gregorian_utc(*EX02_EPOCH)
    orbit = R.Orbit.keplerian(*EX02_KEPLER, epoch, R.Frames.EME2000)
    sc = R.Spacecraft.new(orbit, 6200.0, 0.0, srp_area_m2=100.0, cr=1.3, drag_area_m2=0.0, cd=0.0)
    dyn = RSpacecraftDynamics(
        ROrbitalDynamics.from_models([RPointMasses((RNAIF.SUN, RNAIF.MOON))], R.Frames.EME2000),
        (RSolarPressure.cislunar(),),
    )
    prop = RPropagator.rk89(dyn, RIntegratorOptions())
    est0 = RSpacecraftUncertainty(nominal=sc, frame="ric", x_km=0.5, y_km=0.3, z_km=1.5,
                                  vx_km_s=1e-4, vy_km_s=3e-4, vz_km_s=2e-4).to_estimate()
    scan = RScanKalmanOD(prop, [RGroundStation.dss65_madrid(10.0)],
                         types=(RMeasurementType.RANGE_KM, RMeasurementType.DOPPLER_KM_S),
                         almanac=alm)
    return dict(epoch=epoch, sc=sc, prop=prop, alm=alm, est0=est0, scan=scan,
                mvn=RMvnSpacecraft.from_covariance(sc, est0.covar))


def _leo(pkg, backend_kw):
    """Config 2's LEO scene (tests/test_monte_carlo.py:225-257) in one
    package: 21x21 JGM3 at split precision, SRP with an Earth shadow,
    exponential drag, RK89 at 1e-9; dispersions on sma and inc."""
    if pkg == "port":
        Ep, Fr, Or, Sc = P.Epoch, P.Frames, P.Orbit, P.Spacecraft
        G, H, OD, SD, SRP, DR = (GravityFieldData, Harmonics, OrbitalDynamics,
                                 SpacecraftDynamics, SolarPressure, Drag)
        Mvn, SDisp, Prop, Opts, Alm = (MvnSpacecraft, StateDispersion, Propagator,
                                       IntegratorOptions, Almanac)
    else:
        Ep, Fr, Or, Sc = R.Epoch, R.Frames, R.Orbit, R.Spacecraft
        G, H, OD, SD, SRP, DR = (RGravityFieldData, RHarmonics, ROrbitalDynamics,
                                 RSpacecraftDynamics, RSolarPressure, RDrag)
        Mvn, SDisp, Prop, Opts, Alm = (RMvnSpacecraft, RStateDispersion, RPropagator,
                                       RIntegratorOptions, RAlmanac)
    epoch = Ep.from_gregorian_utc(*LEO_EPOCH)
    orbit = Or.keplerian(*LEO_KEPLER, epoch, Fr.EME2000)
    sc = Sc.new(orbit, 100.0, 0.0, 2.0, 2.0, 1.8, 2.2)
    stor = G.from_cof(str(JGM3), 21, 21, True, Fr.IAU_EARTH)
    dyn = SD(OD.from_model(H.from_stor(stor, precision="split", **backend_kw), Fr.EME2000),
             (SRP.default(), DR.earth_exp()))
    prop = Prop.rk89(dyn, Opts.with_adaptive_step(0.1, 2700.0, 1e-9))
    mvn = Mvn(sc, [SDisp("sma", 0.5), SDisp("inc", 0.01)])
    return dict(epoch=epoch, sc=sc, dyn=dyn, prop=prop, mvn=mvn, alm=Alm())


@pytest.fixture(scope="module")
def ex02():
    return chip_smoke.ex02_scene(device="cpu")


@pytest.fixture(scope="module")
def rex02():
    return _ref_ex02()


@pytest.fixture(scope="module")
def ex02_runs(ex02, rex02):
    """ex02's Monte Carlo at B = 8 over one day with capture (64 nodes,
    every second step) in both packages on the port's draws, the port's
    witness at tolerance 0.99e-12, and both packages' Encke mode (ABM,
    dt 600 s, 64 nodes) on the same draws."""
    end = ex02.epoch + EX02_SECONDS
    mc = MonteCarlo(ex02.mvn, seed=EX02_SEED)
    port = mc.run_until_epoch(ex02.prop, ex02.almanac, end, EX02_B, n_capture=64, capture_stride=2,
                              device="cpu")
    y0 = port.y_initial
    witness = MonteCarlo(ex02.mvn, seed=EX02_SEED).run_until_epoch(
        Propagator.rk89(ex02.prop.dynamics, IntegratorOptions(tolerance=0.99e-12)), ex02.almanac,
        end, EX02_B, n_capture=64, capture_stride=2, device="cpu", _y0=y0)
    rend = rex02["epoch"] + EX02_SECONDS
    ref = RMonteCarlo(rex02["mvn"], seed=EX02_SEED).run_until_epoch(
        rex02["prop"], rex02["alm"], rend, EX02_B, n_capture=64, capture_stride=2, _y0=jnp.asarray(y0))
    enc = mc.run_until_epoch_encke(ex02.prop, ex02.almanac, end, EX02_B, integ="abm", dt_s=600.0,
                                   n_capture=64, device="cpu")
    rmc = RMonteCarlo(rex02["mvn"], seed=EX02_SEED)
    rmc.generate_states = lambda n, skip=0: jnp.asarray(y0[skip:skip + n])
    renc = rmc.run_until_epoch_encke(rex02["prop"], rex02["alm"], rend, EX02_B, integ="abm",
                                     dt_s=600.0, n_capture=64)
    return dict(port=port, witness=witness, ref=ref, enc=enc, renc=renc)


# ---------------------------------------------------------------- dynamics
def test_cislunar_srp_force_matches_reference():
    """SolarPressure.cislunar at float32 on 64 states: lit ones on the
    sunward side, and ones deep in the Earth's and in the Moon's umbra,
    where both packages give exactly 0. Relative 1e-6 of |a| (SRP runs at
    f32). Penumbral states are left out: the f32 penumbra fraction is a
    known reference-side finding (ROADMAP Queue 3), two implementations
    differing by up to 0.5 in k near the shadow's edge."""
    epoch = P.Epoch.from_gregorian_utc(*EX02_EPOCH)
    alm = Almanac()
    t_tdb = epoch.to_tdb_seconds() + 3600.0
    sun = alm.position(NAIF.SUN, NAIF.EARTH, t_tdb)
    moon = alm.position(NAIF.MOON, NAIF.EARTH, t_tdb)
    u_sun = sun / np.linalg.norm(sun)
    rng = np.random.default_rng(31)

    def lateral(n, scale):
        d = rng.normal(size=(n, 3))
        d -= (d @ u_sun)[:, None] * u_sun
        return d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0, scale, (n, 1))

    lit = rng.normal(size=(32, 3))
    lit /= np.linalg.norm(lit, axis=1, keepdims=True)
    lit = np.where((lit @ u_sun)[:, None] < 0.2, lit + u_sun, lit)
    lit = lit / np.linalg.norm(lit, axis=1, keepdims=True) * rng.uniform(2e4, 3e5, (32, 1))
    earth_umbra = -u_sun * rng.uniform(8e3, 1e5, (16, 1)) + lateral(16, 3000.0)
    moon_umbra = moon - u_sun * rng.uniform(2e3, 3e4, (16, 1)) + lateral(16, 500.0)
    r = np.concatenate([lit, earth_umbra, moon_umbra])
    v = rng.normal(0, 1.0, (64, 3))
    cr = rng.uniform(1.0, 1.8, 64)
    mass = rng.uniform(500.0, 6200.0, 64)
    f32 = np.float32

    dyn = SpacecraftDynamics(OrbitalDynamics.two_body(P.Frames.EME2000), (SolarPressure.cislunar(),))
    ctx = dyn.build_context(epoch, 7200.0, alm, device="cpu")
    tt = torch.full((64,), t_tdb, dtype=torch.float64)
    sc = dict(cr=torch.tensor(cr, dtype=torch.float32), srp_area_m2=100.0,
              mass_kg=torch.tensor(mass, dtype=torch.float32))
    a = SolarPressure.cislunar().force_per_mass(ctx, tt, torch.tensor(r.astype(f32)),
                                                torch.tensor(v.astype(f32)), sc).numpy()
    repoch = R.Epoch.from_gregorian_utc(*EX02_EPOCH)
    rdyn = RSpacecraftDynamics(ROrbitalDynamics.two_body(R.Frames.EME2000),
                               (RSolarPressure.cislunar(),))
    rctx = rdyn.build_context(repoch, 7200.0, RAlmanac())
    rsc = dict(cr=jnp.asarray(cr, jnp.float32), srp_area_m2=jnp.float32(100.0),
               mass_kg=jnp.asarray(mass, jnp.float32))
    ra = np.asarray(RSolarPressure.cislunar().force_per_mass(
        rctx, jnp.full((64,), t_tdb), jnp.asarray(r, jnp.float32), jnp.asarray(v, jnp.float32), rsc))
    assert SolarPressure.cislunar().shadow_bodies == (NAIF.EARTH, NAIF.MOON)
    mag = np.linalg.norm(ra, axis=1)
    gap = np.linalg.norm(a - ra, axis=1)
    print(f"\ncislunar SRP: lit |a| {mag[:32].min():.3e}-{mag[:32].max():.3e} km/s^2, max relative "
          f"gap {(gap[:32] / mag[:32]).max():.3e}; umbra |a| port {np.abs(a[32:]).max():.1e}, "
          f"reference {np.abs(ra[32:]).max():.1e}")
    assert (mag[:32] > 0).all()
    assert (gap[:32] <= 1e-6 * mag[:32]).all()
    assert np.abs(a[32:]).max() == 0.0 and np.abs(ra[32:]).max() == 0.0


def test_mvn_covariances_match_reference(ex02, rex02):
    """`from_covariance` (ex02's 9x9 estimate covariance, and a 6x6 padded
    to 9x9) and `new` (dispersions on sma or ecc and inc, with means,
    through the Jacobian, at the same nominal): covar, sqrt_covar and the
    mean shift within 1e-12 relative of the reference's. (A raan and inc
    pair is conditioned worse: the two Jacobians' 1e-16 differences reach
    4e-11 through the pseudo-inverse.)"""
    assert _rel(ex02.mvn.covar, rex02["mvn"].covar) < 1e-12
    assert _rel(ex02.mvn.sqrt_covar @ ex02.mvn.sqrt_covar.T, rex02["mvn"].covar) < 1e-12
    c6 = ex02.est0.covar[:6, :6]
    m6, r6 = MvnSpacecraft.from_covariance(ex02.sc, c6), RMvnSpacecraft.from_covariance(rex02["sc"], c6)
    assert m6.covar.shape == (9, 9) and np.all(m6.covar[6:] == 0.0) and np.all(m6.covar[:, 6:] == 0.0)
    assert _rel(m6.covar, r6.covar) < 1e-12
    assert _rel(m6.sqrt_covar, r6.sqrt_covar) < 1e-12
    # the same nominal in both (Orbit.keplerian's conversions differ by an ulp)
    rsc = rex02["sc"].set_vector(rex02["epoch"], ex02.sc.to_vector())
    for disp in ([("sma", 5.0), ("inc", 0.01)], [("ecc", 1e-3), ("inc", 0.01)]):
        mn = MvnSpacecraft.new(ex02.sc, [StateDispersion(p, s, 0.1 * s) for p, s in disp])
        rn = RMvnSpacecraft.new(rsc, [RStateDispersion(p, s, 0.1 * s) for p, s in disp])
        gaps = [_rel(mn.covar, rn.covar), _rel(mn.sqrt_covar @ mn.sqrt_covar.T, rn.covar),
                _rel(mn.mean_shift, rn.mean_shift)]
        print(f"\nMvnSpacecraft.new {disp}: covar gap {gaps[0]:.3e}, sqrt {gaps[1]:.3e}, mean "
              f"{gaps[2]:.3e}; radius {mn.radius_km} vs {rn.radius_km}")
        assert max(gaps) < 1e-12 and mn.radius_km == rn.radius_km


def test_mvn_draw_moments(ex02):
    """20,000 port draws of ex02's dispersion: the sample mean within 5
    sigma of its sampling error sqrt(C_ii / N) of the nominal, each
    sample covariance entry within 5 sigma of sqrt((C_ii C_jj + C_ij^2) / N)
    of covar; the zero-variance columns (Cr, Cd, mass) exactly nominal."""
    n = 20_000
    y = MonteCarlo(ex02.mvn, seed=3).generate_states(n, device="cpu").numpy()
    c = ex02.mvn.covar
    nominal = ex02.sc.to_vector()
    d = np.sqrt(np.diag(c))
    mean_z = np.abs(y.mean(0) - nominal)[:6] / (d[:6] / np.sqrt(n))
    s = np.cov(y.T, bias=True)
    sig = np.sqrt((np.outer(np.diag(c), np.diag(c)) + c**2) / n)
    cov_z = np.abs(s - c)[:6, :6] / sig[:6, :6]
    print(f"\ndraw moments: mean {mean_z.max():.2f} sigma, covariance {cov_z.max():.2f} sigma")
    assert mean_z.max() < 5.0 and cov_z.max() < 5.0
    assert np.all(y[:, 6:] == nominal[6:])


# ------------------------------------------------------- the Monte Carlo
def test_ex02_monte_carlo_with_capture_matches_reference(ex02_runs):
    """ex02's scene at B = 8 over one day, n_capture=64, capture_stride=2,
    identical initial states: sample 0 is y_initial in both packages; the
    node counts within 2; the finals within 1e-6 km where both packages
    take the same steps, else within 10x the witness (the port against
    itself at tolerance 0.99e-12), since at 1e-12 the float32 SRP steers
    the step (ROADMAP Queue 3, Config 1)."""
    port, ref, wit = ex02_runs["port"], ex02_runs["ref"], ex02_runs["witness"]
    assert port.n_ok == ref.n_ok == EX02_B
    np.testing.assert_array_equal(port.traj_y[:, 0, :], port.y_initial)
    np.testing.assert_array_equal(port.traj_t[:, 0], 0.0)
    np.testing.assert_array_equal(np.asarray(ref.traj_y)[:, 0, :], port.y_initial)
    gap = np.linalg.norm(port.y_final[:, :3] - np.asarray(ref.y_final)[:, :3], axis=1).max()
    wgap = np.linalg.norm(port.y_final[:, :3] - wit.y_final[:, :3], axis=1).max()
    same_steps = np.array_equal(port.n_accepted, np.asarray(ref.n_accepted))
    print(f"\nex02 B={EX02_B} 1 day: final position gap {gap:.3e} km, witness {wgap:.3e} km; "
          f"traj_len {port.traj_len.tolist()} vs {np.asarray(ref.traj_len).tolist()}; accepted "
          f"{port.n_accepted.tolist()} vs {np.asarray(ref.n_accepted).tolist()}")
    assert np.abs(port.traj_len - np.asarray(ref.traj_len)).max() <= 2
    assert gap < (1e-6 if same_steps else 10.0 * wgap)


def _shared_results(port, rex02, interp_j2=(1.08263e-3, 6378.1363)):
    """The port's ex02 capture given to both packages' Results (with J2
    end data, to exercise that branch of the interpolant)."""
    kw = dict(y_final=port.y_final, status=port.status, n_accepted=port.n_accepted,
              n_rejected=port.n_rejected, traj_t=port.traj_t, traj_y=port.traj_y,
              traj_len=port.traj_len, y_initial=port.y_initial, interp_j2=interp_j2[0],
              interp_re_km=interp_j2[1])
    mine = Results(epoch0=port.epoch0, end_epoch=port.end_epoch, template=port.template,
                   device="cpu", **kw)
    theirs = RResults(epoch0=rex02["epoch"], end_epoch=rex02["epoch"] + EX02_SECONDS,
                      template=rex02["sc"], **kw)
    return mine, theirs


def test_results_queries_match_reference(ex02_runs, rex02):
    """Both packages' Results on identical capture buffers: every_value_of
    (sma, height, x, with a failed run's value), first/last/final_values_of,
    trajectory(i), truncated, concatenate, locate_nth_event and
    event_state, within 1e-9 relative. Height needs the frame's radius:
    a query without it gives |r|, 6,378 km off."""
    mine, theirs = _shared_results(ex02_runs["port"], rex02)
    gaps = {}
    for p in ("sma", "height", "x"):
        t1, v1 = mine.every_value_of(p, 3600.0)
        t2, v2 = theirs.every_value_of(p, 3600.0)
        np.testing.assert_array_equal(t1, t2)
        gaps[f"every {p}"] = _rel(v1, v2)
    # a failed run's value (the reference's own raises here: it assigns
    # into the read-only numpy view of a JAX array, ROADMAP Queue 3)
    failed = dataclasses.replace(mine, status=mine.status.copy())
    failed.status[2] = integrator.FAILED_NAN
    _, vf = failed.every_value_of("x", 3600.0, value_if_run_failed=-1.0)
    assert np.all(vf[2] == -1.0) and np.array_equal(np.delete(vf, 2, 0), np.delete(v1, 2, 0))
    with pytest.raises(ValueError):
        dataclasses.replace(theirs, status=failed.status).every_value_of(
            "x", 3600.0, value_if_run_failed=-1.0)
    gaps["first sma"] = _rel(mine.first_values_of("sma"), theirs.first_values_of("sma"))
    gaps["final height"] = _rel(mine.final_values_of("height"), theirs.final_values_of("height"))
    gaps["last ecc"] = _rel(mine.last_values_of("ecc"), theirs.last_values_of("ecc"))
    tm, tr = mine.trajectory(3), theirs.trajectory(3)
    np.testing.assert_array_equal(tm.ts, tr.ts)
    gaps["trajectory"] = _rel(tm.interpolate(40_000.0)[:6], tr.interpolate(40_000.0)[:6])
    assert _rel(mine.final_state(1).to_vector(), theirs.final_state(1).to_vector()) < 1e-15
    for a, b in ((mine.truncated(5), theirs.truncated(5)),
                 (Results.concatenate([mine, mine.truncated(3)]),
                  RResults.concatenate([theirs, theirs.truncated(3)]))):
        assert a.n_runs == b.n_runs
        for k in ("y_final", "status", "traj_t", "traj_y", "traj_len", "y_initial"):
            np.testing.assert_array_equal(getattr(a, k), np.asarray(getattr(b, k)))
    ta = mine.first_values_of("ta")
    ev_p, ev_r = Event("ta", float(ta.max()) + 2.0), REvent("ta", float(ta.max()) + 2.0)
    mine.locate_nth_event(ev_p, 1)
    theirs.locate_nth_event(ev_r, 1)
    np.testing.assert_array_equal(mine.event_found, theirs.event_found)
    assert mine.event_found.all()
    gaps["event t"] = _rel(mine.event_t, theirs.event_t)
    gaps["event y"] = _rel(mine.event_y, theirs.event_y)
    gaps["event_state"] = _rel(mine.event_state(4).to_vector(), theirs.event_state(4).to_vector())
    mine.locate_nth_event(ev_p, 2)  # one crossing only in a day: not found, final kept
    assert not mine.event_found.any()
    np.testing.assert_array_equal(mine.event_y, mine.y_final)
    print("\nResults queries, relative gaps: " + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items()))
    assert max(gaps.values()) < 1e-9
    with pytest.raises(MonteCarloError):
        Results(mine.epoch0, mine.end_epoch, mine.template, mine.y_final, mine.status,
                mine.n_accepted, mine.n_rejected, device="cpu").every_value_of("sma", 60.0)


def test_results_parquet_forms_match_reference(ex02_runs, rex02, tmp_path):
    """The three to_parquet forms (finals; a 600 s grid; every node) read
    back equal to the reference's within 1e-9 relative, column by column,
    with the port's watermark."""
    mine, theirs = _shared_results(ex02_runs["port"], rex02)
    for name, kw in (("finals", {}), ("grid", dict(trajectories=True, step=600.0)),
                     ("nodes", dict(trajectories=True, step="nodes"))):
        a = pq.read_table(mine.to_parquet(tmp_path / f"p_{name}.parquet", **kw))
        b = pq.read_table(theirs.to_parquet(tmp_path / f"r_{name}.parquet", **kw))
        assert a.column_names == b.column_names and a.num_rows == b.num_rows
        assert a.schema.metadata[b"Generator"] == b"nyx-tpu-torch"
        gap = max(_rel(a[c].to_numpy(), b[c].to_numpy()) for c in a.column_names)
        print(f"\nto_parquet {name}: {a.num_rows} rows, max relative gap {gap:.1e}")
        assert gap < 1e-9
    assert a.num_rows == int(np.sum(mine.traj_len))


def test_predict_for_ex02_day_matches_reference(ex02, rex02):
    """predict_for on ex02's scene over one day at 60 s (1,440 estimates;
    point masses and SRP, no Harmonics, so stage 2 takes the dynamics as
    they are; max_gap_s clips to max_step_s): every covariance within 1e-9
    relative of the reference's, the final one symmetric."""
    sol = ex02.scan.predict_for(ex02.est0, EX02_SECONDS, step=60.0)
    rsol = rex02["scan"].predict_for(rex02["est0"], EX02_SECONDS, step=60.0)
    assert len(sol.y_est) == len(rsol.y_est) == 1440
    assert ex02.scan.max_gap_s == ex02.prop.opts.max_step_s
    gap = _rel(sol.covar, np.asarray(rsol.covar))
    fgap = _rel(sol.final_covar(), np.asarray(rsol.final_covar()))
    ygap = np.abs(sol.y_est[:, :3] - np.asarray(rsol.y_est)[:, :3]).max()
    print(f"\npredict_for 1,440 rows: covariance gap {gap:.3e} (final {fgap:.3e}), nominal "
          f"{ygap:.3e} km, mapped sigmas {np.sqrt(np.diag(sol.final_covar())[:3])}")
    assert gap < 1e-9 and ygap < 1e-6
    pf = sol.final_covar()
    assert np.array_equal(pf, pf.T)


def test_time_updates_equal_the_masked_joseph_update():
    """The rows of a filter without measurements (predict_for) run the
    time updates alone; the full Joseph update of the same masked rows
    gives the same covariances within 1e-12 relative."""
    rng = np.random.default_rng(5)
    m, d = 40, 9
    phi = torch.tensor(np.eye(d) + 0.05 * rng.normal(size=(m, d, d)))
    a = rng.normal(size=(m, d, d))
    q = torch.tensor(1e-6 * a @ a.transpose(0, 2, 1))
    h = torch.tensor(rng.normal(size=(m, 2, d)))
    z = torch.zeros(m, 2, dtype=torch.float64)
    r = torch.full((m, 2), 1e30, dtype=torch.float64)
    b = rng.normal(size=(d, d))
    p0 = torch.tensor(b @ b.T + np.eye(d))
    avail = torch.zeros(m, 2, dtype=torch.bool)
    fast = filter_scan(phi, q, h, z, r, avail, p0, np.inf, False)
    avail_one = avail.clone()
    avail_one[-1, 0] = True  # one measured row (of no weight) takes the full path
    full = filter_scan(phi, q, h, z, r, avail_one, p0, np.inf, False)
    gap = _rel(fast[1][:-1], full[1][:-1])
    print(f"\ntime updates vs masked Joseph update: {gap:.3e}")
    assert gap < 1e-12
    assert not fast[0].any() and not fast[5].any() and not fast[4].any()


def test_state_dtype_float32_integration():
    """integrator.propagate(state_dtype=float32): the state, its captures
    and the RK combinations stay float32, time stays float64; a two-body
    orbit's float32 deviation-sized state integrates like the float64 one
    to float32 precision."""
    mu = 398_600.4415

    def eom(t, y):
        r = y[:, 0:3]
        rm = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        return torch.cat([y[:, 3:6], -mu * r / rm**3], dim=-1)

    y64 = torch.tensor([[7000.0, 0.0, 0.0, 0.0, 7.5, 1.0]], dtype=torch.float64)
    opts = IntegratorOptions.with_adaptive_step(1.0, 600.0, 1e-6)
    r64 = integrator.propagate(eom, y64, 3000.0, opts, IntegratorMethod.RK89, n_capture=16)
    r32 = integrator.propagate(eom, y64.to(torch.float32), 3000.0, opts, IntegratorMethod.RK89,
                               n_capture=16, state_dtype=torch.float32)
    assert r32.y.dtype == torch.float32 and r32.traj_y.dtype == torch.float32
    assert r32.t.dtype == torch.float64 and r32.traj_t.dtype == torch.float64
    assert int(r32.status[0]) == integrator.DONE and float(r32.t[0]) == 3000.0
    gap = float(torch.linalg.vector_norm(r32.y[0, :3].double() - r64.y[0, :3]))
    print(f"\nfloat32 state vs float64 over 3,000 s: {gap:.3e} km, "
          f"{int(r32.n_accepted[0])} vs {int(r64.n_accepted[0])} steps")
    assert gap < 5e-2
    with pytest.raises(ValueError):  # a float32 state needs state_dtype=float32
        integrator.propagate(eom, y64.to(torch.float32), 10.0, opts)


def test_resume_chunks_and_nth_event(ex02):
    """Port semantics of the reference's framework tests: a resumed run
    (skip) reproduces the tail of the full one bitwise; a chunked run
    (max_lanes_per_call) the plain one within 1e-12 km (on the CPU a batch
    of another width rounds a few operations' last bit differently: the
    vectorized loops and their scalar tails); run_until_nth_event finds
    each run's event where the capture's own interpolation puts it."""
    dyn = SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000))
    prop = Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))
    epoch = P.Epoch.from_gregorian_utc(*LEO_EPOCH)
    sc = P.Spacecraft.from_orbit(P.Orbit.keplerian(*LEO_KEPLER, epoch, P.Frames.EME2000))
    mvn = MvnSpacecraft(sc, [StateDispersion("sma", 0.5), StateDispersion("inc", 0.01)])
    end = epoch + 1800.0
    full = MonteCarlo(mvn, seed=13).run_until_epoch(prop, None, end, 32, device="cpu")
    tail = MonteCarlo(mvn, seed=13).resume_run_until_epoch(prop, None, end, 16, 16, device="cpu")
    np.testing.assert_array_equal(full.y_final[16:], tail.y_final)
    chunked = MonteCarlo(mvn, seed=13).run_until_epoch(prop, None, end, 32, max_lanes_per_call=12,
                                                       device="cpu")
    np.testing.assert_allclose(full.y_final, chunked.y_final, rtol=1e-14, atol=1e-12)
    np.testing.assert_array_equal(full.y_initial, chunked.y_initial)
    ev = Event("declination", 0.0)
    res = MonteCarlo(mvn, seed=13).run_until_nth_event(prop, None, 7200.0, ev, 1, 8, n_capture=256,
                                                       device="cpu")
    assert res.event_found.all()
    for i in (0, 5):
        y = res.event_state(i).to_vector()
        dec = np.degrees(np.arcsin(y[2] / np.linalg.norm(y[:3])))
        assert abs(dec) < 1e-6
        assert 0.0 < res.event_t[i] < 7200.0


# ------------------------------------------------------------------ Encke
@pytest.fixture(scope="module")
def leo():
    return _leo("port", {})


@pytest.fixture(scope="module")
def leo_full(leo):
    """The full-state reference runs of the Encke tests (seed 42, B = 8,
    10,000 s; seed 7, B = 4, with 256 nodes of capture)."""
    end = leo["epoch"] + 10_000.0
    full = MonteCarlo(leo["mvn"], seed=42).run_until_epoch(leo["prop"], leo["alm"], end, 8,
                                                           device="cpu")
    cap = MonteCarlo(leo["mvn"], seed=7).run_until_epoch(leo["prop"], leo["alm"], end, 4,
                                                         n_capture=256, device="cpu")
    return full, cap


@pytest.mark.parametrize("step_mode,integ", [("fixed", "rk"), ("fixed", "abm"), ("adaptive", "rk")])
def test_encke_deviation_mode(leo, leo_full, step_mode, integ):
    """tests/test_monte_carlo.py:225-279 through the port: Config 2's scene
    over 10,000 s at B = 8, the float32 Encke lanes against the port's
    full-state run on the same draws: within 2e-3 km, the ensemble's
    position sigmas within rtol 1e-3."""
    full, _ = leo_full
    spread = np.linalg.norm(full.y_final[:, :3] - full.y_final[:, :3].mean(0), axis=1).max()
    assert spread > 10.0
    enc = MonteCarlo(leo["mvn"], seed=42).run_until_epoch_encke(
        leo["prop"], leo["alm"], leo["epoch"] + 10_000.0, 8, step_mode=step_mode, integ=integ,
        device="cpu")
    assert enc.n_ok == 8
    err = np.linalg.norm(enc.y_final[:, :3] - full.y_final[:, :3], axis=1).max()
    print(f"\nencke[{step_mode}/{integ}] vs full state: {err * 1e3:.3f} m (spread {spread:.1f} km)")
    assert err < 2e-3
    np.testing.assert_allclose(np.std(enc.y_final[:, :3], axis=0),
                               np.std(full.y_final[:, :3], axis=0), rtol=1e-3)


def test_encke_trajectory_capture(leo, leo_full):
    """tests/test_monte_carlo.py:281-343 through the port: the fixed-step
    Encke capture (64 nodes, recombined with the f64 reference) against the
    full-state capture (256 nodes) on a 600 s grid: t = 0 is the initial
    state (1e-9 km full, 1e-6 km Encke), positions within 0.05 km, sma
    within 0.01 km, the first declination crossing within 0.5 s."""
    _, full = leo_full
    ts = np.arange(0.0, 10_000.0, 600.0)
    yf = full._interp_all(ts)
    np.testing.assert_allclose(yf[:, 0, :6], full.y_initial[:, :6], rtol=0, atol=1e-9)
    ev = Event("declination", 0.0)
    full.locate_nth_event(ev, 1)
    _, sma_f = full.every_value_of("sma", 600.0)
    for integ in ("rk", "abm"):
        enc = MonteCarlo(leo["mvn"], seed=7).run_until_epoch_encke(
            leo["prop"], leo["alm"], leo["epoch"] + 10_000.0, 4, integ=integ, n_capture=64,
            device="cpu")
        assert enc.has_trajectories
        ye = enc._interp_all(ts)
        np.testing.assert_allclose(ye[:, 0, :6], enc.y_initial[:, :6], rtol=0, atol=1e-6)
        d = np.linalg.norm(yf[..., :3] - ye[..., :3], axis=-1).max()
        _, sma_e = enc.every_value_of("sma", 600.0)
        enc.locate_nth_event(ev, 1)
        dt_ev = np.abs(enc.event_t - full.event_t).max()
        print(f"\nencke[{integ}] capture: positions {d * 1e3:.2f} m, sma "
              f"{np.abs(sma_f - sma_e).max() * 1e3:.2f} m, event {dt_ev:.3f} s")
        assert d < 0.05 and np.abs(sma_f - sma_e).max() < 0.01
        assert enc.event_found.all() and dt_ev < 0.5


def test_encke_eccentric_orbit_auto_dt():
    """tests/test_monte_carlo.py:363-395 through the port: on a two-body
    e = 0.72 orbit over three revolutions the automatic ABM step (from the
    periapsis rate, C = 0.16 / (1 + e)) holds the Encke lanes within
    0.05 km of the full-state run, while the ensemble spreads > 50 km."""
    epoch = P.Epoch.from_gregorian_utc(2020, 1, 1, 0, 0, 0)
    orbit = P.Orbit.keplerian(26_562.0, 0.72, 63.4, 50.0, 270.0, 10.0, epoch, P.Frames.EME2000)
    sc = P.Spacecraft.from_orbit(orbit)
    mvn = MvnSpacecraft(sc, [StateDispersion("sma", 1.0), StateDispersion("inc", 0.01)])
    dyn = SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000))
    prop = Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))
    end = epoch + 3.0 * orbit.period_s
    full = MonteCarlo(mvn, seed=6).run_until_epoch(prop, None, end, 8, device="cpu")
    enc = MonteCarlo(mvn, seed=6).run_until_epoch_encke(prop, None, end, 8, integ="abm", device="cpu")
    assert enc.n_ok == 8
    err = np.linalg.norm(enc.y_final[:, :3] - full.y_final[:, :3], axis=1).max()
    spread = np.linalg.norm(full.y_final[:, :3] - full.y_final[:, :3].mean(0), axis=1).max()
    print(f"\nencke e=0.72 auto dt (abm): {err * 1e3:.2f} m, spread {spread:.1f} km")
    assert spread > 50.0 and err < 0.05


def test_encke_ex02_matches_reference(ex02_runs):
    """ex02's Encke mode (ABM, dt 600 s, 64 nodes) on the port's draws in
    both packages over one day: the port's finals within 2e-3 km of the
    reference's Encke finals and of the port's full-state run, the stds
    within rtol 1e-3; printed beside the reference's own Encke-vs-full
    gap. At e = 0.7, dt 600 s is C ~ 0.03 of the periapsis rate."""
    enc, renc, port, ref = (ex02_runs[k] for k in ("enc", "renc", "port", "ref"))
    assert enc.n_ok == EX02_B
    cross = np.linalg.norm(enc.y_final[:, :3] - np.asarray(renc.y_final)[:, :3], axis=1).max()
    own = np.linalg.norm(enc.y_final[:, :3] - port.y_final[:, :3], axis=1).max()
    ref_own = np.linalg.norm(np.asarray(renc.y_final)[:, :3] - np.asarray(ref.y_final)[:, :3],
                             axis=1).max()
    cap = np.abs(enc.traj_y - np.asarray(renc.traj_y)).max()
    print(f"\nex02 encke (abm, 600 s): port vs reference encke {cross:.3e} km; encke vs full "
          f"state: port {own:.3e} km, reference {ref_own:.3e} km; capture {enc.traj_y.shape} "
          f"gap {cap:.3e} km")
    assert cross < 2e-3 and own < 2e-3
    np.testing.assert_array_equal(enc.traj_t, np.asarray(renc.traj_t))
    assert cap < 2e-3
    np.testing.assert_allclose(np.std(enc.y_final[:, :3], axis=0),
                               np.std(port.y_final[:, :3], axis=0), rtol=1e-3)


def test_perturbation_fn_matches_reference():
    """The float32 perturbation stack of Config 2's Encke lanes (the split
    21x21 field with J2+J3 re-added at f32, SRP, drag): the port's against
    the reference's on 64 LEO states at one epoch, within 2e-5 relative
    (the reference's own bound between two f32 evaluations of the
    recursion, tests/test_dynamics.py:399,415)."""
    port, ref = _leo("port", {}), _leo("ref", {})
    rng = np.random.default_rng(11)
    r = rng.normal(size=(64, 3))
    r = r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(6_700.0, 7_500.0, (64, 1))
    v = rng.normal(0.0, 4.0, (64, 3))
    t_rel = 1234.5
    ctx = port["dyn"].build_context(port["epoch"], 3600.0, port["alm"], device="cpu")
    sc = dict(cr=torch.full((64,), 1.8, dtype=torch.float32),
              cd=torch.full((64,), 2.2, dtype=torch.float32), srp_area_m2=2.0, drag_area_m2=2.0,
              mass_kg=torch.full((64,), 100.0, dtype=torch.float32))
    a = encke.make_perturbation_fn(port["dyn"])(
        ctx, ctx.epoch0_tdb + torch.tensor(t_rel, dtype=torch.float64),
        torch.tensor(r, dtype=torch.float32), torch.tensor(v, dtype=torch.float32), sc).numpy()
    rctx = ref["dyn"].build_context(ref["epoch"], 3600.0, ref["alm"])
    rsc = dict(cr=jnp.full((64,), 1.8, jnp.float32), cd=jnp.full((64,), 2.2, jnp.float32),
               srp_area_m2=jnp.float32(2.0), drag_area_m2=jnp.float32(2.0),
               mass_kg=jnp.full((64,), 100.0, jnp.float32))
    ra = np.asarray(rencke.make_perturbation_fn(ref["dyn"])(
        rctx, rctx.epoch0_tdb + t_rel, jnp.asarray(r, jnp.float32), jnp.asarray(v, jnp.float32), rsc))
    assert a.dtype == np.float32
    rel = (np.linalg.norm(a - ra, axis=1) / np.linalg.norm(ra, axis=1)).max()
    print(f"\nf32 perturbation stack, 64 LEO states: max relative gap {rel:.3e}")
    assert rel < 2e-5


def test_encke_tables_match_reference():
    """The reference table's pieces on identical inputs: `_quintic`,
    `_lagrange6_p32` (float32) and `_adams_coefficients`."""
    rng = np.random.default_rng(2)
    k = 40
    tab = dict(stride_s=60.0, r=rng.normal(size=(k, 3)) * 7000.0, v=rng.normal(size=(k, 3)),
               a=rng.normal(size=(k, 3)) * 1e-3, p32=(rng.normal(size=(k, 3)) * 1e-5).astype(np.float32))
    mine = encke.EnckeReference(**{n: x if n == "stride_s" else torch.tensor(x) for n, x in tab.items()})
    theirs = rencke.EnckeReference(**{n: jnp.asarray(x) for n, x in tab.items()})
    t = rng.uniform(0.0, 60.0 * (k - 1), 50)
    rq, vq = encke._quintic(mine, torch.tensor(t))
    rr, vr = rencke._quintic(theirs, jnp.asarray(t))
    assert _rel(rq.numpy(), rr) < 1e-14 and _rel(vq.numpy(), vr) < 1e-14
    assert _rel(encke._lagrange6_p32(mine, torch.tensor(t)).numpy(),
                rencke._lagrange6_p32(theirs, jnp.asarray(t))) < 1e-6
    for kk in (4, 8):
        for x, y in zip(encke._adams_coefficients(kk), rencke._adams_coefficients(kk)):
            np.testing.assert_array_equal(x, y)


def test_interpolate_many_matches_reference(ex02_runs, rex02):
    """`Trajectory.interpolate_many` (the Encke reference table's
    resampling; `interpolate` and the trajectory queries go through it)
    against the reference's `Trajectory.interpolate` one time at a time,
    on identical nodes: within 1e-12 relative, and each time exactly what
    the port's single-time call gives."""
    port = ex02_runs["port"]
    k = int(port.traj_len[0])
    traj = port.trajectory(0)
    rtraj = RTrajectory.from_capture(rex02["epoch"], port.traj_t[0, :k], port.traj_y[0, :k],
                                     rex02["sc"])
    ts = np.linspace(traj.ts[0], traj.ts[-1], 97)
    many = traj.interpolate_many(ts)
    gap = _rel(many, np.stack([rtraj.interpolate(t) for t in ts]))
    print(f"\ninterpolate_many vs the reference's interpolate: {gap:.3e}")
    assert gap < 1e-12
    np.testing.assert_array_equal(many[40], traj.interpolate(float(ts[40])))
