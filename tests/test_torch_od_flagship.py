"""Flagship-OD parity: the port's segmented EKF, two-way tracking, light
time, Gauss-Newton iterations and predict_for against nyx_tpu.

The scene is test_torch_od.py's 8x8 JGM3 split-precision LEO (sma 7500 km,
i 60 deg) over 4 h, RK89 adaptive at 1e-10, but tracked two-way: DSS-65
and DSS-13 with a 60 s integration time, DSS-13 also correcting for the
downlink light time, range and Doppler every 60 s. The filters start from
a dispersed state (one draw of the initial covariance from
`np.random.default_rng(7)`, as bench.py:417-421 does), with SNC, a 3-sigma
gate and `segment_rows=8`, so the EKF crosses several segment boundaries.
JAX runs on the CPU in float64; the reference's arc, estimate and
trajectory reach the port through `nyx_tpu_torch.interop`. The JAX
`ScanKalmanOD` runs are module-scoped: each compiles once.
"""

from pathlib import Path

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nyx_tpu as R
from nyx_tpu.dynamics import Harmonics as RHarmonics
from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
from nyx_tpu.od import GroundStation as RGroundStation
from nyx_tpu.od import ProcessNoise as RProcessNoise
from nyx_tpu.od import SpacecraftUncertainty as RSpacecraftUncertainty
from nyx_tpu.od import TrackingArcSim as RTrackingArcSim
from nyx_tpu.od import TrkConfig as RTrkConfig
from nyx_tpu.od.msr import TrackingDataArc as RTrackingDataArc
from nyx_tpu.od.noise import StochasticNoise as RStochasticNoise
from nyx_tpu.od.noise import WhiteNoise as RWhiteNoise
from nyx_tpu.od.scan_filter import ScanKalmanOD as RScanKalmanOD
from nyx_tpu.od.scan_filter import _station_obs as r_station_obs
from nyx_tpu.od.simulator import Scheduler as RScheduler
from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
from nyx_tpu.propagators import Propagator as RPropagator

import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.dynamics import Harmonics, OrbitalDynamics, SpacecraftDynamics
from nyx_tpu_torch.errors import ConfigError
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.od import (
    GroundStation,
    MeasurementType,
    ProcessNoise,
    ScanKalmanOD,
    Scheduler,
    SpacecraftUncertainty,
    StochasticNoise,
    TrackingArcSim,
    TrkConfig,
    WhiteNoise,
)
from nyx_tpu_torch.od.scan_filter import observe_rows
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator
from nyx_tpu_torch.time import Duration

JGM3 = Path(__file__).parents[1] / "data/JGM3.cof.gz"
ARC_S = 4 * 3600.0
T_INT = 60.0
TYPES = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
ALL_TYPES = TYPES + (MeasurementType.AZIMUTH_DEG, MeasurementType.ELEVATION_DEG)


def _propagator(M, precision="split"):
    stor = (RGravityFieldData if M is R else GravityFieldData).from_cof(
        JGM3, 8, 8, True, M.Frames.IAU_EARTH)
    field = (RHarmonics if M is R else Harmonics).from_stor(stor, precision=precision)
    od, sd = ((ROrbitalDynamics, RSpacecraftDynamics) if M is R
              else (OrbitalDynamics, SpacecraftDynamics))
    dyn = sd(od.from_model(field, M.Frames.EME2000), ())
    opts = (RIntegratorOptions if M is R else IntegratorOptions).with_adaptive_step(
        1.0, 2700.0, 1e-10)
    return (RPropagator if M is R else Propagator).rk89(dyn, opts)


def _truth(M):
    epoch = M.Epoch.from_gregorian_utc(2021, 3, 4)
    orbit = M.Orbit.keplerian(7500.0, 0.001, 60.0, 30.0, 65.0, 0.0, epoch, M.Frames.EME2000)
    return M.Spacecraft.from_orbit(orbit)


def _stations(M):
    gs, sn, wn = ((RGroundStation, RStochasticNoise, RWhiteNoise) if M is R
                  else (GroundStation, StochasticNoise, WhiteNoise))
    out = [gs.dss65_madrid(10.0), gs.dss13_goldstone(10.0)]
    for g in out:
        g.stochastic_noises = {TYPES[0]: sn(wn(2.0e-3)), TYPES[1]: sn(wn(3.0e-6))}
        g.integration_time_s = T_INT
    out[1].light_time_correction = True
    return out


def _trk(M, cadence_s=60.0):
    return (RTrkConfig if M is R else TrkConfig)(
        sampling_s=cadence_s, scheduler=(RScheduler if M is R else Scheduler)(min_samples=5))


def _dispersed_estimate(M, truth):
    est = (RSpacecraftUncertainty if M is R else SpacecraftUncertainty)(
        nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
        vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()
    draw = np.random.default_rng(7).multivariate_normal(np.zeros(9), est.covar)
    est.nominal = truth.set_vector(truth.epoch, truth.to_vector() + draw)
    return est


def _filter(M, variant, precision="split", **kw):
    cls = RScanKalmanOD if M is R else ScanKalmanOD
    pn = RProcessNoise if M is R else ProcessNoise
    if M is P:
        kw["device"] = "cpu"
    return cls(_propagator(M, precision), _stations(M), types=TYPES, variant=variant,
               process_noise=(pn.from_diag([1e-16] * 3, 3600.0),), resid_rejection_sigmas=3.0,
               stm_jvp_degree=4, segment_rows=8, **kw)


def _gaps(sol, sol_ref):
    """(largest estimate difference (km), largest relative difference of a
    position/velocity covariance diagonal, largest prefit or postfit
    difference)."""
    d_est = np.linalg.norm(sol.y_est - sol_ref.y_est, axis=1).max()
    diag, diag_ref = (np.diagonal(c, axis1=1, axis2=2)[:, :6] for c in (sol.covar, sol_ref.covar))
    d_cov = (np.abs(diag - diag_ref) / diag_ref).max()
    d_fit = max(np.abs(sol.prefit - sol_ref.prefit).max(),
                np.abs(sol.postfit - sol_ref.postfit).max())
    return d_est, d_cov, d_fit


def _col_rel(a, b, axis=0):
    """Largest difference relative to the scale of each column of b (the
    largest magnitude along `axis`)."""
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b).max(axis=axis) / np.abs(b).max(axis=axis)).max())


# Rows of the EKF parity arc whose range gets a 50 m (25-sigma) error,
# so that the gate rejects them.
OUTLIER_ROWS = [9, 20, 33]


@pytest.fixture(scope="module")
def ref_scene():
    """The reference's truth, two-way arc (and the same with outliers) and
    dispersed estimate."""
    truth = _truth(R)
    _, traj = _propagator(R).with_state(truth).for_duration_with_traj(ARC_S)
    stations = _stations(R)
    sim = RTrackingArcSim.with_seed(stations, traj, {g.name: _trk(R) for g in stations}, seed=0)
    arc = sim.generate_measurements()
    values = arc.values.copy()
    values[OUTLIER_ROWS, 0] += 0.05
    return dict(truth=truth, traj=traj, arc=arc, arc_outliers=dataclasses.replace(arc, values=values),
                est=_dispersed_estimate(R, truth))


@pytest.fixture(scope="module")
def port_inputs(ref_scene):
    est, traj = ref_scene["est"], ref_scene["traj"]
    arcs = {key: interop.tracking_arc_from_numpy(arc.trackers, arc.types, arc.epochs_tai_s,
                                                 arc.tracker_idx, arc.values)
            for key, arc in ((k, ref_scene[k]) for k in ("arc", "arc_outliers"))}
    return dict(
        **arcs,
        est=interop.kf_estimate_from_numpy(est.nominal.to_vector(), est.covar,
                                           est.epoch.to_tai_seconds()),
        traj=interop.trajectory_from_numpy(traj.epoch0.to_tai_seconds(), traj.ts, traj.ys),
    )


@pytest.fixture(scope="module")
def ref_ekf(ref_scene):
    """The reference's EKF on the scene, its dynamics with an f64 field
    (see test_ekf_matches_reference)."""
    return _filter(R, "ekf", "f64").process_arc(ref_scene["est"], ref_scene["arc_outliers"])


@pytest.fixture(scope="module")
def ref_ckf2(ref_scene):
    od = _filter(R, "ckf", iterations=2)
    return od, od.process_arc(ref_scene["est"], ref_scene["arc"])


def _rows(ref_scene, n=8, seed=11):
    """n rows of the scene: TDB epochs, the truth at t and at t - T_int,
    alternating stations, light time on odd rows, two-way on all but
    every fourth."""
    traj = ref_scene["traj"]
    t_rel = np.sort(np.random.default_rng(seed).uniform(600.0, ARC_S - 10.0, n))
    y_t = np.stack([traj.interpolate(t)[:6] for t in t_rel])
    y_tm = np.stack([traj.interpolate(t - T_INT)[:6] for t in t_rel])
    trk = np.arange(n) % 2
    lt = (np.arange(n) % 2).astype(np.float64)
    tint = np.where(np.arange(n) % 4 == 3, 0.0, T_INT)
    return traj.epoch0.to_tdb_seconds() + t_rel, y_t, y_tm, trk, lt, tint


def test_light_time_and_two_way_observables_match_reference(ref_scene):
    """(a) The light-time-corrected one-way observables
    (`GroundStation.measurement_fn`), the two-way ones (`two_way_fn`) and the
    filter's rows with their H (`observe_rows`: two-way, light time, one
    forward-mode batch) against the reference's `_one_way`, `two_way_fn`
    and `_station_obs(lt=1.0)` with `jax.jacfwd`, one row at a time and
    eager, all within 1e-12 relative to each column's scale (H: each
    type's largest partial). Range, Doppler, azimuth and elevation.
    Measured: values 3.5e-16, H 7.1e-16."""
    t_tdb, y_t, y_tm, trk, lt, tint = _rows(ref_scene)
    ref_st, st = _stations(R), _stations(P)
    f64 = dict(dtype=torch.float64)
    gaps = {}
    for k in (0, 1):
        sel = trk == k
        ref_one = np.stack([ref_st[k]._one_way(jnp.float64(t), jnp.asarray(y), ALL_TYPES)
                            for t, y in zip(t_tdb[sel], y_t[sel])])
        one = st[k].measurement_fn(ALL_TYPES)(torch.tensor(t_tdb[sel], **f64),
                                              torch.tensor(y_t[sel], **f64)).numpy()
        ref_h2 = ref_st[k].two_way_fn(ALL_TYPES)
        ref_two = np.stack([ref_h2(jnp.float64(t), jnp.asarray(y), jnp.asarray(ym))
                            for t, y, ym in zip(t_tdb[sel], y_t[sel], y_tm[sel])])
        two = st[k].two_way_fn(ALL_TYPES)(torch.tensor(t_tdb[sel], **f64),
                                          torch.tensor(y_t[sel], **f64),
                                          torch.tensor(y_tm[sel], **f64)).numpy()
        gaps[f"{st[k].name} one-way"] = _col_rel(one, ref_one)
        gaps[f"{st[k].name} two-way"] = _col_rel(two, ref_two)

    lat = np.array([g.latitude_deg for g in st])[trk]
    lon = np.array([g.longitude_deg for g in st])[trk]
    hgt = np.array([g.height_km for g in st])[trk]
    frame = R.Frames.IAU_EARTH

    def obs_and_jac(t, y, i):
        def f(rv):
            return r_station_obs(jnp.float64(t), rv, lat[i], lon[i], hgt[i], frame, ALL_TYPES,
                                 lt=lt[i])
        return np.asarray(f(jnp.asarray(y))), np.asarray(jax.jacfwd(f)(jnp.asarray(y)))

    ref_vals, ref_h = [], []
    for i in range(len(t_tdb)):
        v1, h1 = obs_and_jac(t_tdb[i], y_t[i], i)
        if tint[i] > 0.0:
            v0, h0 = obs_and_jac(t_tdb[i] - tint[i], y_tm[i], i)
            phi_back = np.eye(6)
            phi_back[0:3, 3:6] = -tint[i] * np.eye(3)
            v1, h1 = 0.5 * (v0 + v1), 0.5 * (h1 + h0 @ phi_back)
        ref_vals.append(v1)
        ref_h.append(h1)
    ref_vals, ref_h = np.stack(ref_vals), np.stack(ref_h)
    t = lambda x: torch.tensor(x, **f64)  # noqa: E731
    vals, h = observe_rows(t(t_tdb), t(y_t), t(y_tm), t(lat), t(lon), t(hgt), t(lt), t(tint),
                           P.Frames.IAU_EARTH, ALL_TYPES)
    assert h.shape == (len(t_tdb), len(ALL_TYPES), 9) and (h[:, :, 6:] == 0).all()
    gaps["rows"] = _col_rel(vals.numpy(), ref_vals)
    h_scale = np.abs(ref_h).max(axis=(0, 2))
    gaps["H"] = float((np.abs(h[:, :, :6].numpy() - ref_h).max(axis=(0, 2)) / h_scale).max())
    print({k: f"{v:.2e}" for k, v in gaps.items()})
    assert max(gaps.values()) < 1e-12, gaps


def test_two_way_simulator_matches_reference(ref_scene, port_inputs):
    """(b) TrackingArcSim with two-way, light-time stations, fed the
    reference's truth through interop: the same epochs, trackers and types
    (no row in the first T_int seconds), and values within 1e-9 of each
    column's scale (test_torch_od.py's simulator bound: the reference's
    geometry runs under jit, a few ulp off eager evaluation). Measured:
    4.6e-12 (range), 9.8e-12 (Doppler)."""
    stations = _stations(P)
    sim = TrackingArcSim.with_seed(stations, port_inputs["traj"],
                                   {g.name: _trk(P) for g in stations}, seed=0, device="cpu")
    arc, arc_ref = sim.generate_measurements(), ref_scene["arc"]
    assert len(arc) == len(arc_ref) > 30
    assert arc.trackers == arc_ref.trackers and arc.types == arc_ref.types
    np.testing.assert_array_equal(arc.epochs_tai_s, arc_ref.epochs_tai_s)
    np.testing.assert_array_equal(arc.tracker_idx, arc_ref.tracker_idx)
    assert arc.epochs_tai_s[0] >= ref_scene["traj"].epoch0.to_tai_seconds() + T_INT
    gaps = np.abs(arc.values - arc_ref.values).max(axis=0) / np.abs(arc_ref.values).max(axis=0)
    print(f"values, relative to each column's scale: {gaps}")
    assert (gaps < 1e-9).all(), gaps


@pytest.mark.parametrize("cadence_s, max_gap_s", [(60.0, None), (30.0, None), (60.0, 200.0)],
                         ids=["60s", "30s", "60s-max-gap-200s"])
def test_segment_boundaries_match_reference(cadence_s, max_gap_s, ref_scene, port_inputs):
    """(c) The EKF's segments against the reference's _ekf_setup: the same
    count, rows per segment, row times from the segment start, segment
    epochs and capture size. Boundaries shift wherever the next row is
    less than T_int away: after some fillers at a 60 s cadence, at most
    boundaries at 30 s, where rows are closer than T_int. A caller's
    max_gap_s (200 s) replaces the period rule (269 s here). Times agree
    within 1e-9 s and epochs within 1e-6 s, not bit for bit: max_gap_s,
    and so the filler times, come from the period of the carried initial
    state, whose sma the two packages round apart in the last bit.
    Measured: 8 segments of 61 rows, one shifted, at 60 s; 25 of 126, 18
    shifted, at 30 s."""
    if cadence_s == 60.0:
        arc = port_inputs["arc"]
    else:
        stations = _stations(P)
        arc = TrackingArcSim.with_seed(stations, port_inputs["traj"],
                                       {g.name: _trk(P, cadence_s) for g in stations}, seed=0,
                                       device="cpu").generate_measurements()
    arc_ref = RTrackingDataArc(epochs_tai_s=arc.epochs_tai_s, trackers=arc.trackers,
                               tracker_idx=arc.tracker_idx.astype(np.int32), types=arc.types,
                               values=arc.values)
    od_ref = _filter(R, "ekf", max_gap_s=max_gap_s)
    segs, real_ref, _ = od_ref._ekf_setup(ref_scene["est"], arc_ref)
    od = _filter(P, "ekf", max_gap_s=max_gap_s)
    t_np, _, _, _, real = od._layout(port_inputs["est"], arc)
    assert od.max_gap_s == pytest.approx(od_ref.max_gap_s, rel=1e-14)
    segments = od._segments(t_np)
    np.testing.assert_array_equal(real, real_ref)
    assert len(segments) == len(segs)
    sizes = [b1 - b0 for b0, b1, _, _ in segments]
    assert sizes == [seg[3] for seg in segs]
    for (b0, b1, t_prev, span), (args, epochs0, _, n_real) in zip(segments, segs):
        np.testing.assert_allclose(t_np[b0:b1] - t_prev, np.asarray(args[0])[:n_real],
                                   rtol=0, atol=1e-9)
        assert abs(span - float(np.asarray(args[0])[-1])) < 1e-9
        epoch = port_inputs["est"].epoch + t_prev
        np.testing.assert_allclose((epoch.to_tdb_seconds(), epoch.to_tai_seconds()),
                                   [float(e) for e in epochs0], rtol=0, atol=1e-6)
    assert od._k_cap(max(s[3] for s in segments)) == od_ref._last_k_cap
    shifted = sum(n < 8 for n in sizes[:-1])
    print(f"cadence {cadence_s} s, max_gap_s {od.max_gap_s:.3f}: {len(t_np)} rows, "
          f"{len(segments)} segments, "
          f"{shifted} boundaries shifted, sizes {sizes}")
    if cadence_s == 30.0:
        assert shifted > len(segments) // 2


@pytest.mark.parametrize("algebra", ["f64", "f32"])
def test_ekf_matches_reference(algebra, ref_ekf, port_inputs):
    """(d) The segmented EKF with two-way rows, light time, SNC, a 3-sigma
    gate (which rejects the three outliers) and a dispersed start, against the reference's f64 run (the same
    filter in exact arithmetic). f64 algebra: every row's estimate within
    1e-4 km, position/velocity covariance diagonals within 1e-6 relative,
    prefit and postfit within 1e-5, identical rejections (the bounds of
    test_torch_od.py's CKF test). f32 algebra (each segment scaled by its
    own diag(P0)): the bounds of
    test_scan_filter_f32_algebra_matches_reference, diagonals within 1e-4.

    Both filters' dynamics carry the 8x8 field at f64, which isolates the
    filter: with the split field the two nominals differ by the float32
    rounding of its recursion (the port's twin against the reference's
    XLA one), and on this arc a pass starts after a 40-minute gap with
    68 m prefits, where that puts 1.2 cm between the fits, the gap the
    one-pass CKF shows there too (2.1 cm). Measured: f64 algebra 5.2e-7 km,
    5.9e-10, fits 1.2e-7; f32 algebra 5.0e-7 km, 2.2e-5, fits 2.3e-7."""
    od = _filter(P, "ekf", "f64", filter_algebra=algebra)
    sol = od.process_arc(port_inputs["est"], port_inputs["arc_outliers"])
    assert sol.y_est.shape == ref_ekf.y_est.shape
    assert ref_ekf.rejected[OUTLIER_ROWS].all()
    d_est, d_cov, d_fit = _gaps(sol, ref_ekf)
    print(f"{algebra}: {od.stage_walls_s['segments']} segments, estimate {d_est:.3e} km, "
          f"covariance diagonal {d_cov:.3e}, fits {d_fit:.3e}, "
          f"{int(ref_ekf.rejected.sum())} rejections")
    np.testing.assert_array_equal(sol.rejected, ref_ekf.rejected)
    assert d_est < 1e-4 and d_fit < 1e-5, (d_est, d_fit)
    assert d_cov < (1e-6 if algebra == "f64" else 1e-4), d_cov


def test_ckf_iterations_match_reference(ref_ckf2, port_inputs):
    """(e) The CKF with iterations=2 (one Gauss-Newton relinearization,
    the first pass without the gate) against the reference's, at the bounds
    of (d) in f64 (the split field here: the correction removes most of
    the drift that makes the one-pass fits differ). Measured: 9.0e-6 km,
    7.5e-9, fits 6.7e-6."""
    sol = _filter(P, "ckf", iterations=2).process_arc(port_inputs["est"], port_inputs["arc"])
    sol_ref = ref_ckf2[1]
    d_est, d_cov, d_fit = _gaps(sol, sol_ref)
    print(f"iterations=2: estimate {d_est:.3e} km, covariance diagonal {d_cov:.3e}, "
          f"fits {d_fit:.3e}")
    np.testing.assert_array_equal(sol.rejected, sol_ref.rejected)
    assert d_est < 1e-4 and d_cov < 1e-6 and d_fit < 1e-5, (d_est, d_cov, d_fit)


def test_gn_dev0_matches_reference(ref_scene, ref_ckf2):
    """(e) _gn_dev0 on the reference's own first-pass aux (STMs, H, z, R,
    availability) within 1e-9 relative of the reference's correction."""
    od_ref = ref_ckf2[0]
    est = ref_scene["est"]
    prog, args, ctx, sc_params, epochs0, _ = od_ref._setup(est, ref_scene["arc"])
    y0, p0 = jnp.asarray(est.nominal.to_vector()), jnp.asarray(est.covar)
    _, _, _, aux = od_ref._run_stages(prog["stages"], args, y0, p0, ctx, sc_params, epochs0,
                                      rej_thresh=np.inf)
    dx_ref = od_ref._gn_dev0(aux, p0)
    dx = _filter(P, "ckf")._gn_dev0(aux, p0)
    rel = float(np.linalg.norm(dx - dx_ref) / np.linalg.norm(dx_ref))
    print(f"Gauss-Newton correction {dx_ref[:3]} km, relative difference {rel:.2e}")
    assert np.linalg.norm(dx_ref[:3]) > 1e-3
    assert rel < 1e-9, rel


def test_predict_for_matches_reference(ref_scene, port_inputs):
    """(f) predict_for over 2 h at a 300 s step (with SNC; the step is
    longer than max_gap_s, so fillers split it): every row's covariance
    within 1e-6 of the reference's, relative to sqrt(P_ii P_jj). Measured:
    3.8e-9."""
    sol_ref = _filter(R, "ckf").predict_for(ref_scene["est"], 7200.0, 300.0)
    sol = _filter(P, "ckf").predict_for(port_inputs["est"], Duration(7200.0), 300.0)
    assert sol.covar.shape == sol_ref.covar.shape == (24, 9, 9)
    d = np.sqrt(np.diagonal(sol_ref.covar, axis1=1, axis2=2)[:, :6])
    scale = d[:, :, None] * d[:, None, :]
    rel = float((np.abs(sol.covar[:, :6, :6] - sol_ref.covar[:, :6, :6]) / scale).max())
    print(f"predict_for: covariance {rel:.2e} relative, final position sigma "
          f"{np.sqrt(sol.covar[-1, 0, 0]):.4f} km")
    assert rel < 1e-6, rel


def test_flagship_path_recovers_truth_on_cpu():
    """(g) The flagship path through the port alone, on the CPU: truth with
    capture, two-way simulated tracking, then the segmented EKF with SNC
    and the 3-sigma gate from a dispersed start; the final estimate within
    10 m of the truth and inside its 3-sigma position bound. Measured: 40
    rows, 8 segments, 6.7 m against a 22.0 m bound."""
    truth = _truth(P)
    prop = _propagator(P)
    _, traj = prop.with_state(truth, device="cpu").for_duration_with_traj(ARC_S)
    stations = _stations(P)
    arc = TrackingArcSim.with_seed(stations, traj, {g.name: _trk(P) for g in stations}, seed=3,
                                   device="cpu").generate_measurements()
    od = _filter(P, "ekf")
    sol = od.process_arc(_dispersed_estimate(P, truth), arc)
    assert np.isfinite(sol.y_est).all() and sol.y_est.shape == (len(arc), 9)
    final = traj.at(P.Epoch.from_tai_seconds_j2000(sol.epochs_tai_s[-1])).to_vector()
    err = float(np.linalg.norm(sol.final_state()[:3] - final[:3]))
    sigma3 = 3 * float(np.sqrt(np.trace(sol.final_covar()[:3, :3])))
    print(f"{len(arc)} rows, {od.stage_walls_s['segments']} segments, "
          f"{int(sol.rejected.sum())} rejected, final error {err * 1e3:.3f} m, "
          f"3-sigma {sigma3 * 1e3:.3f} m")
    assert od.stage_walls_s["segments"] > 3
    assert err < 0.01 and err < sigma3, (err, sigma3)


def test_variant_must_be_ckf_or_ekf():
    with pytest.raises(ConfigError):
        ScanKalmanOD(_propagator(P), _stations(P), variant="ukf", device="cpu")
