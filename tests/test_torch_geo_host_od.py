"""ex03's remainder and the OD host loop: the PyTorch port against nyx_tpu.

Kepler's equation for e >= 0.8 (the port reduces the mean anomaly; the
reference does not), the `Spacecraft` constructors, the eclipse queries
(`EclipseState`, `ShadowModel`) on ex03's drift orbit and the reference's
MEO case, the per-measurement host loop (`KalmanODProcess`: CKF, EKF with
SNC and the sigma gate, scalar updates, two-way, interlink and GNSS
devices, `predict_for`), its solution (smoother, statistics, filters,
parquet), batch least squares, ground-point PNT and TDM files. The host
loops run on the reference's arcs, carried over as numpy
(`nyx_tpu_torch.interop`), over their first ARC_S; JAX runs on the CPU in
float64. The port's host loop is also held to its own scan filter, on the
reference's LEO arc and on a small ex06 (the rehearsal of chip_smoke.py's
phase 6k).

The tests marked `cuda` need only the port. A machine with a card but no
JAX runs them alone with

    python -m pytest --noconftest -m cuda tests/test_torch_geo_host_od.py
"""

import math

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

try:
    import jax.numpy as jnp
    import nyx_tpu as R
    from nyx_tpu.constants import NAIF as RNAIF
    from nyx_tpu.cosmic.eclipse import ShadowModel as RShadowModel
    from nyx_tpu.cosmic.orbit import mean_to_ecc_anomaly as r_mean_to_ecc_anomaly
    from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
    from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
    from nyx_tpu.ephem.almanac import Almanac as RAlmanac
    from nyx_tpu.ephem.daf import SPK as RSPK
    from nyx_tpu.od import BatchLeastSquares as RBatchLeastSquares
    from nyx_tpu.od import GroundAsset as RGroundAsset
    from nyx_tpu.od import GroundPntProcess as RGroundPntProcess
    from nyx_tpu.od import GroundPntSim as RGroundPntSim
    from nyx_tpu.od import GroundStation as RGroundStation
    from nyx_tpu.od import InterlinkTxSpacecraft as RInterlinkTxSpacecraft
    from nyx_tpu.od import KalmanODProcess as RKalmanODProcess
    from nyx_tpu.od import KfEstimate as RKfEstimate
    from nyx_tpu.od import PositionDevice as RPositionDevice
    from nyx_tpu.od import ProcessNoise as RProcessNoise
    from nyx_tpu.od import SpacecraftUncertainty as RSpacecraftUncertainty
    from nyx_tpu.od import TrackingArcSim as RTrackingArcSim
    from nyx_tpu.od import TrackingDataArc as RTrackingDataArc
    from nyx_tpu.od import TrkConfig as RTrkConfig
    from nyx_tpu.od.kalman import KalmanFilter as RKalmanFilter
    from nyx_tpu.od.noise import StochasticNoise as RStochasticNoise
    from nyx_tpu.od.noise import WhiteNoise as RWhiteNoise
    from nyx_tpu.od.process import SpacecraftKalmanScalarOD as RSpacecraftKalmanScalarOD
    from nyx_tpu.od.simulator import Scheduler as RScheduler
    from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
    from nyx_tpu.propagators import Propagator as RPropagator
except ModuleNotFoundError:  # no JAX: only the port-only `cuda` tests can run
    R = None

import chip_smoke
import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.constants import NAIF
from nyx_tpu_torch.cosmic.eclipse import EclipseState, ShadowModel
from nyx_tpu_torch.cosmic.orbit import mean_to_ecc_anomaly
from nyx_tpu_torch.dynamics import OrbitalDynamics, SpacecraftDynamics
from nyx_tpu_torch.od import (
    BatchLeastSquares,
    GroundAsset,
    GroundPntProcess,
    GroundPntSim,
    GroundStation,
    InterlinkTxSpacecraft,
    KalmanFilter,
    KalmanODProcess,
    KalmanVariant,
    KfEstimate,
    MeasurementType,
    ODSolution,
    PositionDevice,
    ProcessNoise,
    ScanKalmanOD,
    Scheduler,
    SpacecraftKalmanScalarOD,
    StochasticNoise,
    TrackingArcSim,
    TrackingDataArc,
    TrkConfig,
    WhiteNoise,
)
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

needs_jax = pytest.mark.skipif(R is None, reason="needs JAX and nyx_tpu, the reference")

TYPES = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
# The host loops' arcs: the first ARC_S of the reference's one-day arcs.
ARC_S = 1800.0
# The host loop against the reference: estimates (km, km/s) and covariances.
POS_KM, VEL_KM_S, COV_ABS = 1e-6, 1e-9, 1e-10
# The residual statistics against the reference's, relative (each NIS and
# each filter-smoother ratio, absolute). The two packages' propagated
# nominals part by ~1e-8 km, so the prefits do, and the ratios (prefit
# over a 2 m sigma) by ~1e-5 of themselves.
STATS_REL = 1e-4


def _pkg(M):
    return R if M == "R" else P


def _white_only(gs, M):
    sn, wn = (RStochasticNoise, RWhiteNoise) if M == "R" else (StochasticNoise, WhiteNoise)
    gs.stochastic_noises = {TYPES[0]: sn(wn(2.0e-3)), TYPES[1]: sn(wn(3.0e-6))}
    return gs


def _stations(M, names=("dss65_madrid", "dss34_canberra", "dss13_goldstone"), t_int=None):
    gs_cls = RGroundStation if M == "R" else GroundStation
    out = []
    for n in names:
        gs = getattr(gs_cls, n)(10.0)
        gs.integration_time_s = t_int
        out.append(_white_only(gs, M))
    return out


def _port_arc(arc):
    return interop.tracking_arc_from_numpy(arc.trackers, arc.types, arc.epochs_tai_s, arc.tracker_idx,
                                           arc.values)


def _port_traj(traj, frame=None):
    return interop.trajectory_from_numpy(traj.epoch0.to_tai_seconds(), traj.ts, np.asarray(traj.ys),
                                         frame or P.Frames.EME2000)


def _port_estimate(est):
    return interop.kf_estimate_from_numpy(np.asarray(est.nominal.to_vector()), est.covar,
                                          est.epoch.to_tai_seconds())


def _two_body(M):
    if M == "R":
        return RPropagator.rk89(RSpacecraftDynamics.new(ROrbitalDynamics.two_body(R.Frames.EME2000)),
                                RIntegratorOptions())
    return Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000)),
                           IntegratorOptions())


def _dispersed(truth_sc, rng, pos=0.15, vel=5e-6):
    """tests/test_od.py:84's dispersed estimate, in the reference."""
    est = RSpacecraftUncertainty(nominal=truth_sc, frame="ric", x_km=pos, y_km=pos, z_km=pos,
                                 vx_km_s=vel, vy_km_s=vel, vz_km_s=vel).to_estimate()
    draw = rng.multivariate_normal(np.zeros(9), est.covar)
    nominal = truth_sc.set_vector(truth_sc.epoch, truth_sc.to_vector() + draw)
    return RKfEstimate.from_covar(nominal, est.covar)


def _assert_same_solution(sol, ref, pos=POS_KM, vel=VEL_KM_S, cov=COV_ABS, cov_rel=0.0):
    """Every estimate's state and covariance (within cov plus cov_rel of
    the covariance's largest entry), the counts and the residuals'
    rejections as the reference's; returns the largest gaps."""
    assert (sol.accepted, sol.rejected) == (ref.accepted, ref.rejected)
    assert len(sol.estimates) == len(ref.estimates)
    assert [r is None for r in sol.residuals] == [r is None for r in ref.residuals]
    assert [r.rejected for r in sol.residuals if r] == [r.rejected for r in ref.residuals if r]
    y = np.stack([e.state().to_vector() for e in sol.estimates])
    y_r = np.stack([np.asarray(e.state().to_vector()) for e in ref.estimates])
    d_pos = float(np.abs(y[:, :3] - y_r[:, :3]).max())
    d_vel = float(np.abs(y[:, 3:6] - y_r[:, 3:6]).max())
    d_cov = float(max(np.abs(e.covar - np.asarray(r.covar)).max() - cov_rel * np.abs(np.asarray(r.covar)).max()
                      for e, r in zip(sol.estimates, ref.estimates)))
    assert d_pos < pos and d_vel < vel and d_cov < cov, (d_pos, d_vel, d_cov)
    return d_pos, d_vel, d_cov


# ---------------------------------------------------------------- Kepler
@needs_jax
def test_kepler_matches_reference_where_it_converges():
    """Where the reference converges (M in [0, 2 pi]) the port's eccentric
    anomaly is the reference's within 1e-12 rad, e from 0 to 0.99."""
    rng = np.random.default_rng(1)
    ecc = rng.uniform(0.0, 0.99, 5000)
    ma = rng.uniform(0.0, 2.0 * math.pi, 5000)
    e_p = mean_to_ecc_anomaly(torch.tensor(ma), torch.tensor(ecc)).numpy()
    e_r = np.asarray(r_mean_to_ecc_anomaly(jnp.asarray(ma), jnp.asarray(ecc)))
    assert np.abs(e_p - e_r).max() < 1e-12


def test_kepler_residual_over_the_probe():
    """ROADMAP's probe, 20,000 elliptic cases with e in [0, 0.99) and M in
    [-10, 10] rad: every Kepler residual |E - e sin E - M| under 1e-10 (the
    reference leaves 471 unsolved, each with e > 0.8 and M outside
    [0, 2 pi])."""
    rng = np.random.default_rng(0)
    ecc = torch.tensor(rng.uniform(0.0, 0.99, 20_000))
    ma = torch.tensor(rng.uniform(-10.0, 10.0, 20_000))
    ea = mean_to_ecc_anomaly(ma, ecc)
    assert float((ea - ecc * torch.sin(ea) - ma).abs().max()) < 1e-10


def test_kepler_at_epoch_reaches_apoapsis():
    """a = 40,000 km, e = 0.85 from periapsis, 2.5 periods on: apoapsis,
    r = a (1 + e) = 74,000 km within 1e-6 km (the port gave 6,295.4 km
    before the repair, the reference gives 25,494.6 km)."""
    epoch = P.Epoch.from_gregorian_utc(2020, 1, 1)
    orbit = P.Orbit.keplerian(40_000.0, 0.85, 30.0, 10.0, 20.0, 0.0, epoch, P.Frames.EME2000)
    later = orbit.at_epoch(epoch + 2.5 * orbit.period_s)
    assert abs(float(np.linalg.norm(later.r_km)) - 74_000.0) < 1e-6


# ---------------------------------------------------------------- Spacecraft
@needs_jax
def test_spacecraft_constructors_match_reference():
    """from_srp_defaults, from_drag_defaults and with_drag give the
    reference's masses, areas, coefficients and state vector."""
    built = {}
    for M in ("R", "P"):
        pkg = _pkg(M)
        epoch = pkg.Epoch.from_gregorian_utc(2024, 3, 1)
        orbit = pkg.Orbit.keplerian(42_164.0, 1e-4, 0.05, 90.0, 10.0, 0.0, epoch, pkg.Frames.EME2000)
        built[M] = [pkg.Spacecraft.from_srp_defaults(orbit, 2000.0, 16.0),
                    pkg.Spacecraft.from_drag_defaults(orbit, 500.0, 4.0),
                    pkg.Spacecraft.from_srp_defaults(orbit, 2000.0, 16.0).with_drag(12.0, 2.1)]
    for sc, ref in zip(built["P"], built["R"]):
        for f in ("dry_mass_kg", "prop_mass_kg", "srp_area_m2", "cr", "drag_area_m2", "cd"):
            assert getattr(sc, f) == getattr(ref, f), f
        np.testing.assert_array_equal(sc.to_vector(), np.asarray(ref.to_vector()))


# ---------------------------------------------------------------- eclipses
def _eclipse_case(case):
    """(reference trajectory, the port's copy of it, almanacs): ex03's drift
    orbit (42,164 km, 0.05 deg, 2024-03-01, in eclipse season) or the
    reference's MEO (tests/test_od.py:1082), over a two-body day."""
    if case == "ex03-drift":
        epoch = R.Epoch.from_gregorian_utc(2024, 3, 1)
        orbit = R.Orbit.keplerian(42_164.0, 1e-4, 0.05, 90.0, 10.0, 0.0, epoch, R.Frames.EME2000)
    else:
        epoch = R.Epoch.from_gregorian_utc(2020, 1, 1)
        orbit = R.Orbit.keplerian(22_000.0, 0.01, 30.0, 80.0, 40.0, 0.0, epoch, R.Frames.EME2000)
    _, traj = _two_body("R").with_state(R.Spacecraft.from_orbit(orbit)).for_duration_with_traj(86_400.0)
    return traj, _port_traj(traj)


@needs_jax
@pytest.mark.parametrize("case,step", [("ex03-drift", 300.0), ("meo", 120.0)])
def test_shadow_model_matches_reference(case, step):
    """ShadowModel((EARTH,)).percentages over the day within 1e-9 of the
    reference's, the same samples in eclipse, and find_eclipse_events'
    epochs within 1e-3 s and kinds equal (examples/03_geo_analysis.py:
    214-228; tests/test_od.py:1082); compute and EclipseState at the
    deepest sample and at a lit one."""
    traj_r, traj = _eclipse_case(case)
    alm_r = RAlmanac()
    model, model_r = ShadowModel((NAIF.EARTH,)), RShadowModel((RNAIF.EARTH,), alm_r)
    ts, pct = model.percentages(traj, step_s=step, device="cpu")
    ts_r, pct_r = model_r.percentages(traj_r, step_s=step)
    np.testing.assert_array_equal(ts, ts_r)
    assert np.abs(pct - np.asarray(pct_r)).max() < 1e-9
    assert pct.min() == 0.0
    ev = model.find_eclipse_events(traj, step_s=step, device="cpu")
    ev_r = model_r.find_eclipse_events(traj_r, step_s=step)
    assert [k for _, k in ev] == [k for _, k in ev_r]
    d_s = max([abs((a - R_to_P(b)).to_seconds()) for (a, _), (b, _) in zip(ev, ev_r)] or [0.0])
    print(f"{case}: eclipse share {np.mean(pct > 1e-6):.4f}, {len(ev)} events, {d_s:.2e} s apart")
    assert d_s < 1e-3
    if case == "ex03-drift":
        assert len(ev) >= 2 and pct.max() > 0.99
    for i in (int(np.argmax(pct)), int(np.argmin(pct))):
        sc = traj.template.set_vector(traj.epoch0 + float(ts[i]), traj.interpolate(ts[i])[:9])
        sc_r = traj_r.template.set_vector(traj_r.epoch0 + float(ts[i]), traj_r.interpolate(ts[i])[:9])
        st, st_r = model.compute(sc.orbit), model_r.compute(sc_r.orbit)
        assert abs(st.percentage - st_r.percentage) < 1e-9
        assert (st.is_umbra, st.is_penumbra, st.is_visible) == (st_r.is_umbra, st_r.is_penumbra, st_r.is_visible)
        assert str(st) == str(st_r)
    assert str(EclipseState(1.0)) == "Umbra" and str(EclipseState(0.0)) == "Visibilis"
    assert str(EclipseState(0.25)) == "Penumbra 25.00%"
    assert ShadowModel.cislunar().shadow_bodies == (NAIF.EARTH, NAIF.MOON)


def R_to_P(epoch_r):
    return P.Epoch.from_tai_seconds_j2000(epoch_r.to_tai_seconds())


# ---------------------------------------------------------------- host loop
@pytest.fixture(scope="module")
def leo():
    """tests/test_od.py:48-80's scene: the 22,000 km two-body truth, DSS-65,
    DSS-34 and DSS-13 at 10 deg with white noise, every 60 s; the truth and
    the arc over their first ARC_S."""
    epoch = R.Epoch.from_gregorian_utc(2020, 1, 1)
    orbit = R.Orbit.keplerian(22_000.0, 0.01, 30.0, 80.0, 40.0, 0.0, epoch, R.Frames.EME2000)
    truth = R.Spacecraft.from_orbit(orbit)
    _, traj = _two_body("R").with_state(truth).for_duration_with_traj(ARC_S)
    st_r = _stations("R")
    cfg = RTrkConfig(sampling_s=60.0, scheduler=RScheduler(min_samples=5))
    arc = RTrackingArcSim.with_seed(st_r, traj, {g.name: cfg for g in st_r}, seed=0).generate_measurements()
    return dict(epoch=epoch, truth=truth, traj=traj, arc=arc, st_r=st_r, st=_stations("P"),
                prop_r=_two_body("R"), prop=_two_body("P"), cfg=cfg, cache={})


def _host_case(leo, case):
    """(port solution, reference solution, port est0) of a host-loop case
    on the LEO arc, each case run once."""
    if case in leo["cache"]:
        return leo["cache"][case]
    arc, st_r, st = leo["arc"], leo["st_r"], leo["st"]
    kw = dict(variant=KalmanVariant.DeviationTracking, resid_rejection_sigmas=None)
    seed, pos, vel = 42, 0.15, 5e-6
    ref_cls, port_cls = RKalmanODProcess, KalmanODProcess
    if case == "ekf-gate":  # tests/test_od.py:227
        kw = dict(variant=KalmanVariant.ReferenceUpdate, resid_rejection_sigmas=4.0)
        seed, pos, vel = 11, 0.5, 5e-4
    elif case == "ekf-snc":  # :247
        seed = 13
        kw = dict(variant=KalmanVariant.ReferenceUpdate, resid_rejection_sigmas=None)
    elif case == "scalar":  # :1477
        seed = 13
        kw = dict(variant=KalmanVariant.ReferenceUpdate, resid_rejection_sigmas=None)
        ref_cls, port_cls = RSpacecraftKalmanScalarOD, SpacecraftKalmanScalarOD
    est0_r = _dispersed(leo["truth"], np.random.default_rng(seed), pos, vel)
    snc_r = snc = ()
    if case == "ekf-snc":
        snc_r = (RProcessNoise.from_diag([1e-18] * 3, disable_time_s=3600.0),)
        snc = (ProcessNoise.from_diag([1e-18] * 3, disable_time_s=3600.0),)
    ref = ref_cls(leo["prop_r"], process_noise=snc_r, **kw).process_arc(est0_r, arc, st_r)
    est0 = _port_estimate(est0_r)
    sol = port_cls(leo["prop"], process_noise=snc, device="cpu", **kw).process_arc(est0, _port_arc(arc), st)
    leo["cache"][case] = (sol, ref, est0)
    return leo["cache"][case]


def _truth_err(leo, est):
    truth = np.asarray(leo["traj"].at(R.Epoch.from_tai_seconds_j2000(est.epoch.to_tai_seconds())).to_vector())
    return float(np.linalg.norm(est.state().to_vector()[:3] - truth[:3]))


# The large-dispersion EKF's covariances against the reference's, beyond
# COV_ABS, relative to the covariance's largest entry: its first update
# (0.5 km, 0.5 m/s of initial sigma against 2 m and 3 mm/s of noise) is
# ill-conditioned, and over the arc's hour one station observes it, so the
# z variance stays ~0.5 km^2, where the two packages' roundings of that
# update differ by 1e-8 of it (measured: 5.3e-9 km^2 of 0.53 km^2).
EKF_GATE_COV_REL = 2e-8


@needs_jax
@pytest.mark.parametrize("case", ["ckf", "ekf-gate", "ekf-snc", "scalar"])
def test_host_loop_matches_reference(leo, case):
    """The CKF (tests/test_od.py:112), the EKF from a 0.5 km, 0.5 m/s
    dispersion with a 4-sigma gate (:227), the EKF with SNC (:247) and the
    scalar-update engine (:1477) on the reference's arc: every estimate
    within 1e-6 km and 1e-9 km/s of the reference's, every covariance
    within 1e-10, the same accepted and rejected counts and rejections,
    prefits within 1e-6 (km, km/s), the same residual statistics (NIS
    verdict, percentages within 3 sigma), and the reference's own checks
    of each case."""
    sol, ref, est0 = _host_case(leo, case)
    gaps = _assert_same_solution(sol, ref, cov_rel=EKF_GATE_COV_REL if case == "ekf-gate" else 0.0)
    pre = np.concatenate([r.prefit for r in sol.residuals if r])
    pre_r = np.concatenate([np.asarray(r.prefit) for r in ref.residuals if r])
    assert np.abs(pre - pre_r).max() < POS_KM
    nis, nis_r = sol.nis_test(), ref.nis_test()
    assert nis["verdict"] == nis_r["verdict"] and nis["consistent"] == nis_r["consistent"]
    assert nis["mean_nis"] == pytest.approx(nis_r["mean_nis"], rel=STATS_REL)
    assert sol.nis_consistency() == ref.nis_consistency()
    assert sol.percent_within_sigmas(3.0) == ref.percent_within_sigmas(3.0)
    assert sol.residual_rms(TYPES[0]) == pytest.approx(ref.residual_rms(TYPES[0]), rel=STATS_REL)
    assert sol.postfit_rms(TYPES[0]) == pytest.approx(ref.postfit_rms(TYPES[0]), rel=STATS_REL)
    assert sol.ks_normality() == pytest.approx(ref.ks_normality(), rel=STATS_REL)
    np.testing.assert_allclose(sol.nis(), ref.nis(), rtol=0, atol=STATS_REL)
    err0, err = _truth_err(leo, est0), _truth_err(leo, sol.final_estimate)
    print(f"host loop {case}: {len(leo['arc'])} rows, {sol.accepted} accepted, {sol.rejected} rejected; "
          f"gaps {gaps[0]:.2e} km, {gaps[1]:.2e} km/s, covariance {gaps[2]:.2e}; truth {err0 * 1e3:.1f} -> "
          f"{err * 1e3:.2f} m")
    assert err < err0
    if case == "scalar":
        assert len(sol.drop_time_updates()) == 2 * len(leo["arc"])


@needs_jax
def test_smoother_matches_reference(leo):
    """The RTS smoother of the CKF (tests/test_od.py:139, :162): smoothed
    states within 1e-6 km and covariances within 1e-10 of the reference's,
    the filter-smoother ratios within 1e-4 of theirs (STATS_REL), gains
    recorded on every update (each within 1e-6 of its largest entry of the
    reference's) and scrubbed by the smoother, and the postfits recomputed
    at the smoothed states on the CPU within 1e-6 of the reference's."""
    sol, ref, _ = _host_case(leo, "ckf")
    msr_gains = [g for r, g in zip(sol.residuals, sol.gains) if r is not None]
    assert len(msr_gains) == len(leo["arc"]) and all(g.shape == (9, 2) for g in msr_gains)
    assert sol.gains[0] is None
    g_r = [np.asarray(g) for r, g in zip(ref.residuals, ref.gains) if r is not None]
    assert max(np.abs(g - gr).max() / np.abs(gr).max() for g, gr in zip(msr_gains, g_r)) < 1e-6
    sm = sol.smooth(devices=leo["st"], device="cpu")
    sm_r = ref.smooth(devices=leo["st_r"])
    _assert_same_solution(sm, sm_r)
    assert all(g is None for g in sm.gains)
    fs = [f for f in sm.filter_smoother_ratios if f is not None]
    fs_r = [np.asarray(f) for f in sm_r.filter_smoother_ratios if f is not None]
    assert len(fs) == len(fs_r) == len(sol) - 1
    both = np.isfinite(np.stack(fs)) & np.isfinite(np.stack(fs_r))
    np.testing.assert_array_equal(np.isfinite(np.stack(fs)), np.isfinite(np.stack(fs_r)))
    assert np.abs(np.stack(fs)[both] - np.stack(fs_r)[both]).max() < STATS_REL
    post = np.concatenate([r.postfit for r in sm.residuals if r])
    post_r = np.concatenate([np.asarray(r.postfit) for r in sm_r.residuals if r])
    assert np.abs(post - post_r).max() < POS_KM


@needs_jax
def test_solution_filters_and_parquet_match_reference(leo, tmp_path):
    """ODSolution's record filters (tests/test_od.py:1507) give the
    reference's record counts, `merge` keeps the epochs sorted, `at` finds
    an estimate; NEES against the truth and `to_traj` the reference's
    (STATS_REL, 1e-6 km); the parquet export reads back (:1246: states within 1e-9
    km, covariances within 1e-15, the gain columns, the smoother's ratios)
    and holds the reference's own export's columns and values (each
    within STATS_REL of its column's scale); `to_ephemeris` writes the BSP
    segment the reference's does, its final state within 10 POS_KM."""
    sol, ref, _ = _host_case(leo, "ckf")
    name = leo["st"][0].name
    for sub, sub_r in ((sol.drop_time_updates(), ref.drop_time_updates()),
                       (sol.filter_by_msr_type(TYPES[0]), ref.filter_by_msr_type(TYPES[0])),
                       (sol.filter_by_tracker(name), ref.filter_by_tracker(name)),
                       (sol.exclude_tracker(name), ref.exclude_tracker(name))):
        assert (len(sub), sub.accepted, sub.rejected) == (len(sub_r), sub_r.accepted, sub_r.rejected)
    parts, parts_r = sol.split(), ref.split()
    assert [len(p) for p in parts] == [len(p) for p in parts_r]
    merged = parts[0].merge(parts[1]) if len(parts) > 1 else parts[0]
    ts = [e.epoch.to_tai_seconds() for e in merged.estimates]
    assert ts == sorted(ts)
    hit = sol.at(sol.estimates[5].epoch)
    assert hit is not None and hit[0] is sol.estimates[5]
    # NEES against the truth at every estimate, and the estimated trajectory
    traj_p = _port_traj(leo["traj"])
    nees = sol.nees([traj_p.at(e.epoch) for e in sol.estimates])
    nees_r = ref.nees([leo["traj"].at(e.epoch) for e in ref.estimates])
    np.testing.assert_allclose(nees, nees_r, rtol=STATS_REL)
    est_traj, est_traj_r = sol.to_traj(), ref.to_traj()
    np.testing.assert_array_equal(est_traj.ts, np.asarray(est_traj_r.ts))
    assert np.abs(est_traj.ys[:, :3] - np.asarray(est_traj_r.ys)[:, :3]).max() < POS_KM

    path, path_r = tmp_path / "sol.parquet", tmp_path / "sol_ref.parquet"
    sol.to_parquet(path)
    ref.to_parquet(path_r)
    back = ODSolution.from_parquet(path, sol.estimates[0].nominal)
    assert len(back) == len(sol)
    np.testing.assert_allclose(back.final_estimate.state().to_vector(),
                               sol.final_estimate.state().to_vector(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(back.final_estimate.covar, sol.final_estimate.covar, rtol=0, atol=1e-15)
    t, t_r = pq.read_table(str(path)), pq.read_table(str(path_r))
    assert t.column_names == t_r.column_names and "gain_pos_norm" in t.column_names
    for c in t.column_names:
        a, b = np.asarray(t[c], dtype=np.float64), np.asarray(t_r[c], dtype=np.float64)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        scale = np.abs(b[~np.isnan(b)]).max(initial=0.0)
        assert np.abs(a[~np.isnan(a)] - b[~np.isnan(b)]).max(initial=0.0) <= STATS_REL * scale, c
    sm = sol.smooth()
    sm.to_parquet(tmp_path / "smoothed.parquet")
    back2 = ODSolution.from_parquet(tmp_path / "smoothed.parquet", sol.estimates[0].nominal)
    orig = [f for f in sm.filter_smoother_ratios if f is not None]
    got = [f for f in back2.filter_smoother_ratios if f is not None]
    assert len(orig) == len(got)
    bsp, bsp_r = sol.to_ephemeris(tmp_path / "sol.bsp"), ref.to_ephemeris(tmp_path / "sol_ref.bsp")
    seg, seg_r = P.ephem.SPK(bsp).segments[0], RSPK(bsp_r).segments[0]
    assert (seg.target, seg.center, seg.data_type) == (seg_r.target, seg_r.center, seg_r.data_type) == \
        (-10_000, NAIF.EARTH, 3)
    assert abs(seg.t_start - seg_r.t_start) < 1e-6 and abs(seg.t_stop - seg_r.t_stop) < 1e-6
    r_bsp = P.ephem.Almanac([bsp]).state(-10_000, NAIF.EARTH, sol.final_estimate.epoch)[0]
    r_bsp_r = RAlmanac([bsp_r]).state(-10_000, NAIF.EARTH, ref.final_estimate.epoch)[0]
    # the degree-11 fit carries the trajectories' POS_KM gap (4.8e-6 km measured)
    assert np.abs(r_bsp - np.asarray(r_bsp_r)).max() < 10 * POS_KM


@needs_jax
def test_host_loop_matches_scan_filter(leo):
    """The port's host CKF against its own scan filter on the same arc
    (the reference's tests/test_od.py:412): final positions within 1e-3 km,
    covariances within 1e-10, every row accepted."""
    sol, _, est0 = _host_case(leo, "ckf")
    scan = ScanKalmanOD(leo["prop"], leo["st"], types=TYPES, variant="ckf", device="cpu")
    res = scan.process_arc(est0, _port_arc(leo["arc"]))
    d_pos = float(np.linalg.norm(sol.final_estimate.state().to_vector()[:3] - res.final_state()[:3]))
    d_cov = float(np.abs(res.final_covar() - sol.final_estimate.covar).max())
    print(f"host vs scan CKF: {d_pos:.2e} km, covariance {d_cov:.2e}")
    assert d_pos < 1e-3 and d_cov < 1e-10 and res.accepted == len(leo["arc"])


@needs_jax
def test_predict_for_matches_reference_and_scan(leo):
    """predict_for over 1 h at 300 s (tests/test_od.py:365): 13 estimates,
    the covariance grows, every estimate's state and covariance the
    reference's (1e-6 km, 1e-10); and the port's scan predict_for the host
    loop's (:378: rtol 1e-7 and atol 1e-12 on the covariance, rtol 1e-8
    on the state)."""
    truth = leo["truth"]
    est_r = RKfEstimate.from_diag(truth, [1e-2] * 3 + [1e-8] * 3 + [0.0] * 3)
    ref = RKalmanODProcess(leo["prop_r"]).predict_for(est_r, 3600.0, step=300.0)
    est = _port_estimate(est_r)
    sol = KalmanODProcess(leo["prop"], device="cpu").predict_for(est, 3600.0, step=300.0)
    assert len(sol) == 13 and sol.final_estimate.predicted
    _assert_same_solution(sol, ref)
    assert np.trace(sol.final_estimate.covar[:3, :3]) > np.trace(est.covar[:3, :3])
    scan = ScanKalmanOD(leo["prop"], leo["st"], types=TYPES, device="cpu").predict_for(est, 3600.0, step=300.0)
    np.testing.assert_allclose(scan.final_covar(), sol.final_estimate.covar, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(scan.final_state()[:6], sol.final_estimate.nominal.to_vector()[:6], rtol=1e-8)
    until = KalmanODProcess(leo["prop"], device="cpu").predict_until(est, est.epoch + 600.0, step=300.0)
    assert len(until) == 3


@needs_jax
def test_snc_q_matrix_decay_and_scan_rows():
    """ProcessNoise.q_matrix and the filter's SNC (tests/test_od.py:268):
    the reference's Q at each elapsed time and frame within 1e-12 of its
    largest entry; decay through KalmanFilter._snc_q; and the host form
    equal to the scan filter's device rows (ScanKalmanOD._snc_q) within
    1e-14 of the largest entry, for inertial, RIC and VNC noise."""
    epoch = P.Epoch.from_gregorian_utc(2020, 1, 1)
    sc = P.Spacecraft.from_orbit(P.Orbit.keplerian(8000.0, 0.01, 30.0, 0.0, 0.0, 0.0, epoch, P.Frames.EME2000))
    sc_r = R.Spacecraft.from_orbit(R.Orbit.keplerian(8000.0, 0.01, 30.0, 0.0, 0.0, 0.0,
                                                     R.Epoch.from_gregorian_utc(2020, 1, 1), R.Frames.EME2000))
    for frame in (None, "ric", "vnc"):
        snc = ProcessNoise.from_diag([1e-12, 2e-12, 3e-12], disable_time_s=1e9)
        snc_r = RProcessNoise.from_diag([1e-12, 2e-12, 3e-12], disable_time_s=1e9)
        snc.local_frame = snc_r.local_frame = frame
        snc.decay_tau_s = snc_r.decay_tau_s = np.array([100.0, 100.0, 100.0])
        for dt, el in ((10.0, 0.0), (10.0, 100.0), (60.0, 500.0), (0.0, 0.0)):
            q, q_r = snc.q_matrix(dt, sc, el), np.asarray(snc_r.q_matrix(dt, sc_r, el))
            assert np.abs(q - q_r).max() <= 1e-12 * np.abs(q_r).max()
        est = KfEstimate.from_diag(sc, [1e-2] * 3 + [1e-8] * 3 + [0.0] * 3)
        kf = KalmanFilter(est, process_noise=(snc,), device="cpu")
        q_first = kf._snc_q(epoch.to_tai_seconds(), 10.0, sc)
        q_later = kf._snc_q(epoch.to_tai_seconds() + 500.0, 10.0, sc)
        assert q_later[3, 3] < q_first[3, 3] * 0.05
        # the scan filter's rows at gaps of 10 and 60 s, 0 and 500 s after
        # its first row, and the host form at the same elapsed times
        scan = ScanKalmanOD(Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000))),
                            [GroundStation.dss65_madrid()], types=TYPES, process_noise=(snc,), device="cpu")
        t0 = epoch.to_tai_seconds()
        dts, els = np.array([10.0, 60.0, 10.0]), np.array([0.0, 500.0, 50.0])
        y = np.tile(sc.to_vector(), (3, 1))
        rows = scan._snc_q(torch.tensor(dts), torch.tensor(y), torch.tensor(t0 + els), t0).numpy()
        host = np.stack([snc.q_matrix(d, sc, e) for d, e in zip(dts, els)])
        assert np.abs(rows - host).max() <= 1e-14 * np.abs(host).max()
    kf_r = RKalmanFilter(RKfEstimate.from_diag(sc_r, [1e-2] * 3 + [1e-8] * 3 + [0.0] * 3), process_noise=(snc_r,))
    kf_r._snc_q(epoch.to_tai_seconds(), 10.0, sc_r)
    q, q_r = (f._snc_q(epoch.to_tai_seconds() + 500.0, 10.0, x) for f, x in ((kf, sc), (kf_r, sc_r)))
    assert np.abs(q - np.asarray(q_r)).max() <= 1e-12 * np.abs(q).max()


@needs_jax
def test_two_way_host_loop_matches_reference(leo):
    """Two-way ranging (tests/test_od.py:621): DSS-65 and DSS-34 with 60 s
    integration, every 120 s, the EKF; the port's host loop on the
    reference's arc gives its estimates (1e-6 km, 1e-9 km/s), covariances
    (1e-10) and counts."""
    st_r, st = (_stations(M, ("dss65_madrid", "dss34_canberra"), 60.0) for M in ("R", "P"))
    cfg = RTrkConfig(sampling_s=120.0, scheduler=RScheduler(min_samples=5))
    arc = RTrackingArcSim.with_seed(st_r, leo["traj"], {g.name: cfg for g in st_r}, seed=21).generate_measurements()
    assert len(arc) >= 10
    est0_r = _dispersed(leo["truth"], np.random.default_rng(17))
    kw = dict(variant=KalmanVariant.ReferenceUpdate, resid_rejection_sigmas=None)
    ref = RKalmanODProcess(leo["prop_r"], **kw).process_arc(est0_r, arc, st_r)
    sol = KalmanODProcess(leo["prop"], device="cpu", **kw).process_arc(_port_estimate(est0_r), _port_arc(arc), st)
    gaps = _assert_same_solution(sol, ref)
    print(f"two-way host loop: {len(arc)} rows, gaps {gaps}")


@needs_jax
def test_interlink_and_gnss_host_loop_match_reference(leo):
    """The interlink transmitter (tests/test_od.py:1002; the TX's two-body
    trajectory carried over, its Hermite table rebuilt by the port) and
    the GNSS position device (:1038, every 300 s) through the host loop:
    the reference's estimates, covariances and counts."""
    epoch = leo["epoch"]
    tx_orbit = R.Orbit.keplerian(26_560.0, 0.02, 55.0, 120.0, 10.0, 30.0, epoch, R.Frames.EME2000)
    _, tx_traj = leo["prop_r"].with_state(R.Spacecraft.from_orbit(tx_orbit)).for_duration_with_traj(ARC_S)
    tx_r = RInterlinkTxSpacecraft(tx_traj, name="TX1", occulting_radius_km=6378.0)
    tx = InterlinkTxSpacecraft(_port_traj(tx_traj), name="TX1", occulting_radius_km=6378.0)
    for d, M in ((tx_r, "R"), (tx, "P")):
        _white_only(d, M)
    gnss_r, gnss = RPositionDevice(name="gnss", sigma_km=1e-3), PositionDevice(name="gnss", sigma_km=1e-3)
    kw = dict(variant=KalmanVariant.ReferenceUpdate, resid_rejection_sigmas=None)
    for dev_r, dev, sampling, seed, est_seed in ((tx_r, tx, 120.0, 31, 33), (gnss_r, gnss, 300.0, 41, 43)):
        cfg = RTrkConfig(sampling_s=sampling, scheduler=RScheduler(min_samples=2))
        arc = RTrackingArcSim.with_seed([dev_r], leo["traj"], {dev_r.name: cfg}, seed=seed).generate_measurements()
        assert len(arc) >= 5
        # the port's simulator gives the same arc on the carried-over truth
        arc_p = TrackingArcSim.with_seed([dev], _port_traj(leo["traj"]), {dev.name: TrkConfig(
            sampling_s=sampling, scheduler=Scheduler(min_samples=2))}, seed=seed, device="cpu").generate_measurements()
        np.testing.assert_allclose(arc_p.values, arc.values, rtol=0, atol=1e-9)
        est0_r = _dispersed(leo["truth"], np.random.default_rng(est_seed))
        ref = RKalmanODProcess(leo["prop_r"], **kw).process_arc(est0_r, arc, [dev_r])
        sol = KalmanODProcess(leo["prop"], device="cpu", **kw).process_arc(_port_estimate(est0_r),
                                                                          _port_arc(arc), [dev])
        gaps = _assert_same_solution(sol, ref)
        print(f"{dev.name}: {len(arc)} rows, gaps {gaps}")


# Batch least squares on the reference's perfect stations (tests/test_od.py:
# 293) over the first 6 h, every 30 min: each iteration propagates through
# every row, and Madrid's and Canberra's whole passes condition the normal
# equations (the reference's 3 h, Madrid's pass and Canberra's first
# rows, leaves the two packages' solutions 1e-4 km apart, in a valley of
# the cost 1e-4 km wide); then Levenberg-Marquardt's first iterate.
BLSE_S, BLSE_STEP_S, BLSE_LM_ITERATIONS = 21_600.0, 1800.0, 1


@needs_jax
def test_blse_matches_reference(leo):
    """Batch least squares from a km-level offset with perfect stations
    (tests/test_od.py:293): the normal equations converge in the
    reference's iterations, to its estimate within 1e-6 km and 1e-9 km/s
    and its covariance within 1e-6 of its largest entry, and within 1e-4
    km of the truth; Levenberg-Marquardt's first BLSE_LM_ITERATIONS
    iterates are the reference's (same bounds)."""
    truth = leo["truth"]
    perfect_r = [g.perfect() for g in _stations("R")]
    perfect = [g.perfect() for g in _stations("P")]
    _, traj = leo["prop_r"].with_state(truth).for_duration_with_traj(BLSE_S)
    arc = RTrackingArcSim.with_seed(perfect_r, traj, {g.name: leo["cfg"] for g in perfect_r},
                                    seed=1).generate_measurements().downsample(BLSE_STEP_S)
    vec = np.asarray(truth.to_vector())
    vec[:3] += np.array([1.2, -0.9, 1.1])
    vec[3:6] += np.array([0.5e-3, -0.7e-3, 0.3e-3])
    guess_r = truth.set_vector(truth.epoch, vec)
    guess = interop.spacecraft_from_numpy(vec, truth.epoch.to_tai_seconds())
    for solver, iters in (("normal_eq", 10), ("lm", BLSE_LM_ITERATIONS)):
        ref = RBatchLeastSquares(leo["prop_r"], solver=solver, max_iterations=iters,
                                 tolerance_pos_km=1e-6).estimate(guess_r, arc, perfect_r)
        sol = BatchLeastSquares(leo["prop"], solver=solver, max_iterations=iters, tolerance_pos_km=1e-6,
                                device="cpu").estimate(guess, _port_arc(arc), perfect)
        assert (sol.converged, sol.num_iterations) == (ref.converged, ref.num_iterations), (str(sol), str(ref))
        d = np.abs(sol.estimated_state.to_vector() - np.asarray(ref.estimated_state.to_vector()))
        cov_r = np.asarray(ref.covariance)
        assert d[:3].max() < 1e-6 and d[3:6].max() < 1e-9
        assert np.abs(sol.covariance - cov_r).max() < 1e-6 * np.abs(cov_r).max()
        err = np.linalg.norm(sol.estimated_state.to_vector()[:3] - np.asarray(truth.to_vector())[:3])
        print(f"BLSE {solver}: {len(arc)} rows, {sol}; {d[:3].max():.2e} km from the reference, "
              f"{err * 1e3:.4f} m from the truth")
        if solver == "normal_eq":
            assert sol.converged and err < 1e-4


@needs_jax
def test_ground_pnt_matches_reference():
    """The ground asset's geodetic round trip (tests/test_od.py:1166) and
    the ground-point filter (:1175): two stations tracking a rover by
    range and angles over 1 h; the port's simulation equals the
    reference's (1e-9), its estimate the reference's within 1e-9 km and
    covariance within 1e-12, and the rover within 5 m of the truth."""
    epoch_r = R.Epoch.from_gregorian_utc(2020, 1, 1)
    epoch = P.Epoch.from_gregorian_utc(2020, 1, 1)
    a, a_r = GroundAsset("asset", 12.3456, -45.678, 1.234, epoch), RGroundAsset("asset", 12.3456, -45.678, 1.234, epoch_r)
    np.testing.assert_allclose(a.to_vector(), np.asarray(a_r.to_vector()), rtol=0, atol=1e-9)
    b = GroundAsset.from_vector("asset", a.to_vector(), epoch)
    for f in ("latitude_deg", "longitude_deg", "height_km"):
        assert abs(getattr(b, f) - getattr(a, f)) < 1e-9

    types = (MeasurementType.RANGE_KM, MeasurementType.AZIMUTH_DEG, MeasurementType.ELEVATION_DEG)

    def stations(M):
        gs_cls, sn, wn = ((RGroundStation, RStochasticNoise, RWhiteNoise) if M == "R"
                          else (GroundStation, StochasticNoise, WhiteNoise))
        out = [gs_cls.dss13_goldstone(-90.0), gs_cls("Apple Valley", 34.6, 242.8, 0.9, elevation_mask_deg=-90.0)]
        for gs in out:
            gs.measurement_types = types
            gs.stochastic_noises = {types[0]: sn(wn(2.0e-3)), types[1]: sn(wn(1e-3)), types[2]: sn(wn(1e-3))}
        return out

    st_r, st = stations("R"), stations("P")
    truth_r, truth = RGroundAsset("rover", 35.0, 243.4, 1.0, epoch_r), GroundAsset("rover", 35.0, 243.4, 1.0, epoch)
    arc_r = RGroundPntSim(st_r, truth_r, sampling_s=60.0, seed=3).generate_measurements(3600.0)
    arc = GroundPntSim(st, truth, sampling_s=60.0, seed=3, device="cpu").generate_measurements(3600.0)
    assert len(arc) == len(arc_r) > 50
    np.testing.assert_allclose(arc.values, arc_r.values, rtol=0, atol=1e-9)
    p0 = np.diag([1e-2] * 3 + [1e-10] * 3) ** 2
    est_r, cov_r, res_r = RGroundPntProcess(st_r).process_arc(
        RGroundAsset("rover", 35.001, 243.401, 1.05, epoch_r), p0, arc_r)
    est, cov, res = GroundPntProcess(st, device="cpu").process_arc(
        GroundAsset("rover", 35.001, 243.401, 1.05, epoch), p0, arc)
    assert len(res) == len(res_r) and [r.rejected for r in res] == [r.rejected for r in res_r]
    assert np.abs(est.to_vector() - np.asarray(est_r.to_vector())).max() < 1e-9
    assert np.abs(cov - cov_r).max() < 1e-12
    assert np.linalg.norm(est.to_vector()[:3] - truth.to_vector()[:3]) < 0.005
    assert str(est).startswith("GroundAsset(rover")


@needs_jax
def test_tdm_round_trip_matches_reference(leo, tmp_path):
    """The TDM write and read (tests/test_od.py:848), one-way and two-way:
    each package reads the other's file, every value within 1e-12 of
    itself (the file keeps 13 significant digits) and every epoch within
    1e-5 s of the arc's, the trackers as written."""
    arc_r = leo["arc"]
    arc = _port_arc(arc_r)
    for two_way in (False, True):
        p, p_r = tmp_path / f"port_{two_way}.tdm", tmp_path / f"ref_{two_way}.tdm"
        arc.to_tdm(p, spacecraft_name="TESTSC", two_way=two_way)
        arc_r.to_tdm(p_r, spacecraft_name="TESTSC", two_way=two_way)
        for back in (TrackingDataArc.from_tdm(p), TrackingDataArc.from_tdm(p_r), RTrackingDataArc.from_tdm(p)):
            assert len(back) == len(arc) and set(back.unique_aliases()) == set(arc.unique_aliases())
            assert np.abs(np.asarray(back.epochs_tai_s) - arc.epochs_tai_s).max() < 1e-5
            order = [list(back.types).index(t) for t in arc.types]
            assert np.nanmax(np.abs(np.asarray(back.values)[:, order] - arc.values)
                             / np.abs(arc.values)) < 1e-12


def _freq_tdm(path, turnaround=True):
    lines = ["CCSDS_TDM_VERS = 2.0", "META_START", "\tTIME_SYSTEM = UTC", "\tPARTICIPANT_1 = DSS-65",
             "\tPARTICIPANT_2 = SC", "\tMODE = SEQUENTIAL", "\tPATH = 1,2,1"]
    if turnaround:
        lines += ["\tTURNAROUND_NUMERATOR = 880", "\tTURNAROUND_DENOMINATOR = 749"]
    lines += ["META_STOP", "DATA_START", "\tTRANSMIT_FREQ = 2020-01-01T00:00:00 7.2e9",
              "\tRECEIVE_FREQ = 2020-01-01T00:00:00 8459717471.0",
              "\tRECEIVE_FREQ = 2020-01-01T00:01:00 8459717400.0", "DATA_STOP"]
    path.write_text("\n".join(lines) + "\n")


@needs_jax
def test_frequency_tdm_matches_reference(tmp_path):
    """Frequency observables turned into Doppler through the turnaround
    ratio (tests/test_od.py:971), exactly as the reference, and dropped
    with a warning without it (:986)."""
    p = tmp_path / "freq.tdm"
    _freq_tdm(p)
    arc, arc_r = TrackingDataArc.from_tdm(p), RTrackingDataArc.from_tdm(p)
    assert arc.types == (MeasurementType.DOPPLER_KM_S,) and len(arc) == 2
    np.testing.assert_array_equal(arc.values, np.asarray(arc_r.values))
    ratio, f_t, c = 880.0 / 749.0, 7.2e9, 299_792.458
    for i, f_r in enumerate((8459717471.0, 8459717400.0)):
        assert abs(arc.values[i, 0] - (f_t * ratio - f_r) * c / (2.0 * f_t * ratio)) < 1e-12
    q = tmp_path / "nofreq.tdm"
    _freq_tdm(q, turnaround=False)
    with pytest.warns(UserWarning, match="TURNAROUND"):
        assert len(TrackingDataArc.from_tdm(q)) == 0


# ---------------------------------------------------------------- ex06 (6k)
@pytest.fixture(scope="module")
def small_ex06(tmp_path_factory):
    """A small ex06 (chip_smoke.ex06_scene at degree 8, split precision, on
    the CPU): the truth over the first EX06_HOST_S, the noisy arc over it,
    and the scan EKF (stm_jvp_degree 8, as the card runs it)."""
    d = tmp_path_factory.mktemp("ex06_host")
    scene = chip_smoke.ex06_scene(chip_smoke.ex06_moon_field(8), "split", yaml_dir=d, device="cpu")
    _, traj = scene.propagator("auto").with_state(scene.orbiter, scene.almanac, device="cpu") \
        .for_duration_with_traj(chip_smoke.EX06_CKF_S + 60.0)
    st = scene.stations(scene.epoch, scene.epoch + chip_smoke.EX06_CKF_S + 60.0)
    arc = TrackingArcSim.with_seed(st, traj, scene.configs, seed=123, device="cpu").generate_measurements()
    head = chip_smoke._head(arc, chip_smoke.EX06_CKF_S)
    scan = scene.od(st).process_arc(scene.est0, head)
    return dict(scene=scene, traj=traj, st=st, head=head, scan=scan)


def test_small_ex06_host_loop_matches_scan_ekf(small_ex06):
    """Phase 6k's rehearsal: ex06's host loop (EKF, SNC, 3-sigma gate, as
    examples/06_lunar_od.py:235-245) over the arc's first 30 min, against
    the scan EKF on the same rows: the same accepted and rejected counts
    and a final estimate within 1e-3 km (the reference's own bound between
    its two filters, tests/test_od.py:435); smooth, nis_test and
    postfit_rms run on the result."""
    sc, head = small_ex06["scene"], small_ex06["head"]
    host = chip_smoke.ex06_host_od(sc, device="cpu").process_arc(sc.est0, head,
                                                                                   small_ex06["st"])
    scan = small_ex06["scan"]
    d_km = float(np.linalg.norm(host.final_estimate.state().to_vector()[:3] - scan.final_state()[:3]))
    rej = int(np.sum(scan.rejected))
    sm = host.smooth(devices=small_ex06["st"], device="cpu")
    print(f"small ex06 host loop: {len(head)} rows, {host.accepted}/{host.rejected} (scan "
          f"{len(head) - rej}/{rej}); {d_km:.3e} km from the scan EKF; postfit RMS "
          f"{host.postfit_rms(TYPES[0]) * 1e3:.3f} m; {host.nis_test()['verdict']}")
    assert (host.accepted, host.rejected) == (len(head) - rej, rej)
    assert d_km < 1e-3
    assert len(sm) == len(host) and np.isfinite(host.postfit_rms(TYPES[0]))
    assert host.nis_test()["verdict"] in ("consistent", "over-confident", "under-confident")


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_kernel_matches_twin_on_new_phase_fields():
    """The Pines kernel against its twin on the card on the two new
    phases' fields at their B = 1 shapes: ex03's drift bench (21x21 JGM3
    split at GEO radii) and the host loop on ex06 (50x50 lunar split at its
    orbit's radii), the primal bit for bit and, under torch.func.jvp as
    the host loop's STM takes it, the kernel's primal with the twin's
    tangent equal to the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from nyx_tpu_torch.dynamics import Harmonics
    from nyx_tpu_torch.dynamics import gravity_pines as gp
    from nyx_tpu_torch.io.gravity import GravityFieldData

    drift = GravityFieldData.from_cof(chip_smoke.HERE / "data/JGM3.cof.gz", 21, 21, True, P.Frames.IAU_EARTH)
    cases = [(drift, chip_smoke.GEO_RADII_KM),
             (chip_smoke.ex06_moon_field(chip_smoke.EX06_DEGREE), chip_smoke.EX06_RADII_KM)]
    for stor, radii in cases:
        field, twin = Harmonics.from_stor(stor, "split"), Harmonics.from_stor(stor, "split", backend="torch")
        tab = field.packed_table(0, torch.float32, "cuda")
        kw = field.pines_args()
        for seed in range(4):
            r = torch.tensor(chip_smoke._body_fixed(1, seed, radii), dtype=torch.float32, device="cuda")
            assert torch.equal(gp.pines_accel_cuda(r, tab, 0, **kw), gp.pines_accel_torch(r, tab, 0, **kw))
        r = torch.tensor(chip_smoke._body_fixed(1, 9, radii), dtype=torch.float32, device="cuda")
        v = torch.ones_like(r)
        gp.pines_accel_cuda.launches = 0
        a_k, da_k = torch.func.jvp(field.accel_body_fixed, (r,), (v,))
        assert gp.pines_accel_cuda.launches == 1
        a_t, da_t = torch.func.jvp(twin.accel_body_fixed, (r,), (v,))
        assert torch.equal(a_k, a_t) and torch.equal(da_k, da_t)
