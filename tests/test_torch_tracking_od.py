"""Tracking-side OD parity: the PyTorch port against nyx_tpu.

The link-budget noises, the tracking arc's set operations and parquet I/O,
the randomized estimate and the estimate's checks, the interlink device
(its Hermite table, crosslink values and line-of-sight gate), cross-body
stations (`with_target_frame`), the simulator's cadences, alignment, manual
strands, terrain masks and timestamp noise, station and tracking YAML, and
the two examples this slice brings to the port whole: ex05's crosslink OD
over its first 2 h (examples/05_caps_interlink_od.py) and a small ex06
(examples/06_lunar_od.py at degree 8 over 1 h: Earth stations tracking a
lunar orbiter). Inputs come from numpy seeds; JAX runs on the CPU in
float64. The reference's trajectories reach the port through
`nyx_tpu_torch.interop`.

The test marked `cuda` needs only the port. A machine with a card but no
JAX runs it alone with

    python -m pytest --noconftest -m cuda tests/test_torch_tracking_od.py
"""

from dataclasses import replace
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import nyx_tpu as R
    from nyx_tpu.constants import NAIF as RNAIF
    from nyx_tpu.dynamics import Harmonics as RHarmonics
    from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
    from nyx_tpu.dynamics import PointMasses as RPointMasses
    from nyx_tpu.dynamics import SolarPressure as RSolarPressure
    from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
    from nyx_tpu.ephem.almanac import Almanac as RAlmanac
    from nyx_tpu.io.config import load_ground_stations as r_load_ground_stations
    from nyx_tpu.io.config import load_trk_configs as r_load_trk_configs
    from nyx_tpu.od import GroundStation as RGroundStation
    from nyx_tpu.od import InterlinkTxSpacecraft as RInterlinkTxSpacecraft
    from nyx_tpu.od import ProcessNoise as RProcessNoise
    from nyx_tpu.od import SpacecraftUncertainty as RSpacecraftUncertainty
    from nyx_tpu.od import TerrainMask as RTerrainMask
    from nyx_tpu.od import TrackingArcSim as RTrackingArcSim
    from nyx_tpu.od import TrackingDataArc as RTrackingDataArc
    from nyx_tpu.od import TrkConfig as RTrkConfig
    from nyx_tpu.od import noise as rnoise
    from nyx_tpu.od.interlink import DeviceTrajectory as RDeviceTrajectory
    from nyx_tpu.od.scan_filter import ScanKalmanOD as RScanKalmanOD
    from nyx_tpu.od.scan_filter import ScanODResult as RScanODResult
    from nyx_tpu.od.simulator import Scheduler as RScheduler
    from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
    from nyx_tpu.propagators import Propagator as RPropagator
except ModuleNotFoundError:  # no JAX: only the port-only `cuda` test can run
    jax = None

import chip_smoke
import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.constants import NAIF
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.errors import ConfigError
from nyx_tpu_torch.io.config import load_trk_configs, save_ground_stations
from nyx_tpu_torch.od import (
    DeviceTrajectory,
    GroundStation,
    InterlinkTxSpacecraft,
    MeasurementType,
    ScanKalmanOD,
    ScanODResult,
    Scheduler,
    SpacecraftUncertainty,
    StochasticNoise,
    TerrainMask,
    TrackingArcSim,
    TrackingDataArc,
    TrkConfig,
    WhiteNoise,
)
from nyx_tpu_torch.od import noise as pnoise
from nyx_tpu_torch.od.scan_filter import interlink_rows
from nyx_tpu_torch.od.interlink import stack_tables
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator
from nyx_tpu_torch.time import Duration as PDuration

TYPES = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
LEO_S = 4 * 3600.0


def _col_rel(a, b, axis=0):
    """Largest difference relative to the scale of each column of b."""
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b).max(axis=axis) / np.abs(b).max(axis=axis)).max())


def _port_traj(traj, frame=None):
    return interop.trajectory_from_numpy(traj.epoch0.to_tai_seconds(), traj.ts, traj.ys,
                                         frame or P.Frames.EME2000)


def _assert_same_arc(arc, arc_ref, tol=1e-9):
    """The same epochs (to 1e-9 s), trackers and types, and values within
    `tol` of each column's scale."""
    assert len(arc) == len(arc_ref) > 0
    assert arc.trackers == arc_ref.trackers and arc.types == arc_ref.types
    np.testing.assert_allclose(arc.epochs_tai_s, arc_ref.epochs_tai_s, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(arc.tracker_idx, arc_ref.tracker_idx)
    gap = _col_rel(arc.values, arc_ref.values)
    assert gap < tol, gap
    return gap


# ---------------------------------------------------------------- noise
def test_link_budget_noise_matches_reference():
    """The reference's nasa_dsac case (tests/test_od.py:1224): a DSAC-grade
    clock keeps range noise under 0.11 m and Doppler under 0.2 mm/s at
    X-band; every link-budget sigma (ex05's SA-45 CSAC and the DSAC case,
    each chip rate, S/N0, carrier and C/N0) equals the reference's to
    1e-15 relative, as do the Pr/N0 white noise and the default angle and
    zero noises."""
    for allan in (1e-14, 3.8e-13, 1e-11):
        for chip in (pnoise.ChipRate.Lowest, pnoise.ChipRate.StandardT4B, pnoise.ChipRate.VeryHigh):
            for sn0 in ("Strong", "Average", "Poor"):
                a = StochasticNoise.from_hardware_range_km(allan, 60.0, chip, getattr(pnoise.SN0, sn0))
                b = rnoise.StochasticNoise.from_hardware_range_km(allan, 60.0, chip, getattr(rnoise.SN0, sn0))
                assert abs(a.white_noise.sigma - b.white_noise.sigma) <= 1e-15 * b.white_noise.sigma
        for carrier in ("SBand", "XBand", "KaBand"):
            for cn0 in ("Strong", "Average", "Poor"):
                a = StochasticNoise.from_hardware_doppler_km_s(
                    allan, 10.0, getattr(pnoise.CarrierFreq, carrier), getattr(pnoise.CN0, cn0))
                b = rnoise.StochasticNoise.from_hardware_doppler_km_s(
                    allan, 10.0, getattr(rnoise.CarrierFreq, carrier), getattr(rnoise.CN0, cn0))
                assert abs(a.white_noise.sigma - b.white_noise.sigma) <= 1e-15 * b.white_noise.sigma
    for allan in (1e-14, 3.8e-13):
        rng = StochasticNoise.from_hardware_range_km(allan, 60.0, pnoise.ChipRate.StandardT4B,
                                                    pnoise.SN0.Average)
        assert rng.white_noise.sigma * 1e3 < 1.1e-1
        dop = StochasticNoise.from_hardware_doppler_km_s(allan, 60.0, pnoise.CarrierFreq.XBand,
                                                        pnoise.CN0.Average)
        assert dop.white_noise.sigma * 1e3 < 2e-4
    assert WhiteNoise.from_pr_n0(1e5, 1e6).sigma == pytest.approx(
        rnoise.WhiteNoise.from_pr_n0(1e5, 1e6).sigma, rel=1e-15)
    assert pnoise.SN0.from_db_hz(50.0) == rnoise.SN0.from_db_hz(50.0) == pnoise.SN0.Average
    assert pnoise.CN0.from_db_hz(55.0) == pytest.approx(pnoise.CN0.Average, rel=1e-15)
    assert StochasticNoise.default_angle_deg().covariance() == rnoise.StochasticNoise.default_angle_deg().covariance()
    assert StochasticNoise.zero().covariance() == rnoise.StochasticNoise.zero().covariance() == 1e-32


# ---------------------------------------------------------------- the arc
def _random_arc(M):
    """Three trackers, range and Doppler with gaps (NaN), irregular epochs
    with one long gap, from a numpy seed: (trackers, types, epochs, idx,
    values) as numpy."""
    rng = np.random.default_rng(11)
    steps = rng.choice([30.0, 60.0, 60.0, 90.0], size=M)
    steps[M // 2] = 4000.0
    epochs = 7.0e8 + np.cumsum(steps)
    idx = rng.integers(0, 3, size=M)
    vals = np.column_stack([rng.uniform(4e3, 9e3, M), rng.uniform(-5.0, 5.0, M)])
    vals[rng.uniform(size=M) < 0.15, 0] = np.nan
    vals[rng.uniform(size=M) < 0.15, 1] = np.nan
    vals[np.all(np.isnan(vals), axis=1), 1] = 0.25
    return ("DSS-65", "DSS-34", "DSS-13"), TYPES, epochs, idx, vals


def _arcs(moduli=None):
    trk, types, ep, idx, vals = _random_arc(80)
    return (TrackingDataArc(trk, types, ep.copy(), idx.copy(), vals.copy(), moduli),
            RTrackingDataArc(trk, types, ep.copy(), idx.copy(), vals.copy(), moduli))


def _pe(M, tai_s):
    return (P.Epoch if M is P else R.Epoch).from_tai_seconds_j2000(float(tai_s))


ARC_OPS = {
    "filter_by_epoch": lambda a, M: a.filter_by_epoch(_pe(M, a.epochs_tai_s[5]), _pe(M, a.epochs_tai_s[40])),
    "exclude_by_epoch": lambda a, M: a.exclude_by_epoch(_pe(M, a.epochs_tai_s[5]), _pe(M, a.epochs_tai_s[40])),
    "filter_by_offset": lambda a, M: a.filter_by_offset(600.0, 3600.0),
    "filter_by_offset_duration": lambda a, M: a.filter_by_offset(
        (PDuration if M is P else R.Duration)(1200.0)),
    "filter_by_tracker": lambda a, M: a.filter_by_tracker(["DSS-65", "DSS-13"]),
    "reject_by_tracker": lambda a, M: a.reject_by_tracker(["DSS-34"]),
    "filter_by_type": lambda a, M: a.filter_by_type([MeasurementType.DOPPLER_KM_S]),
    "downsample": lambda a, M: a.downsample(150.0),
    "resid_vs_ref_check": lambda a, M: a.resid_vs_ref_check(),
}


@pytest.mark.parametrize("op", sorted(ARC_OPS))
def test_arc_set_operation_matches_reference(op):
    """Each set operation of TrackingDataArc gives the reference's arc
    exactly: the same epochs, tracker indices, values (NaN where absent),
    moduli and residual-versus-reference flag."""
    arc, arc_ref = _arcs({MeasurementType.RANGE_KM: 1e4})
    out, out_ref = ARC_OPS[op](arc, P), ARC_OPS[op](arc_ref, R)
    assert 0 < len(out) and (len(out) < len(arc) or op == "resid_vs_ref_check")
    for name in ("trackers", "types", "moduli", "force_reject"):
        assert getattr(out, name) == getattr(out_ref, name), name
    for name in ("epochs_tai_s", "tracker_idx", "values"):
        np.testing.assert_array_equal(getattr(out, name), getattr(out_ref, name))


def test_arc_queries_and_splits_match_reference():
    """split_by_gap (the 4,000 s gap), the start and end epochs, the
    unique types and aliases, measurement(i), iteration and str agree with
    the reference."""
    arc, arc_ref = _arcs()
    parts, parts_ref = arc.split_by_gap(1000.0), arc_ref.split_by_gap(1000.0)
    assert [len(p) for p in parts] == [len(p) for p in parts_ref] == [40, 40]
    for p, q in zip(parts, parts_ref):
        np.testing.assert_array_equal(p.epochs_tai_s, q.epochs_tai_s)
    assert arc.start_epoch.to_tai_seconds() == arc_ref.start_epoch.to_tai_seconds()
    assert arc.end_epoch.to_tai_seconds() == arc_ref.end_epoch.to_tai_seconds()
    one = arc.filter_by_tracker(["DSS-34"]).filter_by_type([MeasurementType.RANGE_KM])
    one_ref = arc_ref.filter_by_tracker(["DSS-34"]).filter_by_type([MeasurementType.RANGE_KM])
    assert one.unique_types() == one_ref.unique_types() == (MeasurementType.RANGE_KM,)
    assert one.unique_aliases() == one_ref.unique_aliases() == ("DSS-34",)
    for m, m_ref in zip(arc, arc_ref):
        assert m.tracker == m_ref.tracker and m.data == m_ref.data
        assert m.epoch.to_tai_seconds() == m_ref.epoch.to_tai_seconds()
    assert str(arc).startswith("TrackingDataArc: 80 measurements from 3 trackers")
    empty = arc.filter_by_offset(1e9)
    assert len(empty) == 0 and empty.start_epoch is None and empty.split_by_gap(1.0) == [empty]


def test_arc_parquet_round_trip_both_ways(tmp_path):
    """An arc written by the port reads back in the port and in the
    reference (and the other way round) with the same epochs, each row's
    tracker, values and moduli (the trackers are numbered in the order the
    file first names them)."""
    arc, arc_ref = _arcs({MeasurementType.RANGE_KM: 1e4})
    arc.to_parquet(tmp_path / "p.parquet")
    arc_ref.to_parquet(tmp_path / "r.parquet")
    for back in (TrackingDataArc.from_parquet(tmp_path / "p.parquet"),
                 RTrackingDataArc.from_parquet(tmp_path / "p.parquet"),
                 TrackingDataArc.from_parquet(tmp_path / "r.parquet")):
        assert back.types == arc.types and back.moduli == arc.moduli
        assert [back.trackers[i] for i in back.tracker_idx] == [arc.trackers[i] for i in arc.tracker_idx]
        np.testing.assert_array_equal(back.epochs_tai_s, arc.epochs_tai_s)
        np.testing.assert_array_equal(back.values, arc.values)


def test_result_parquet_and_accepted_match_reference(tmp_path):
    """ScanODResult.to_parquet writes the reference's columns with the same
    values, and `accepted` counts the rows the gate kept."""
    rng = np.random.default_rng(5)
    M = 12
    a = rng.normal(size=(M, 9, 9))
    fields = dict(epochs_tai_s=7e8 + 60.0 * np.arange(M), y_est=rng.normal(size=(M, 9)),
                  covar=a @ a.transpose(0, 2, 1), prefit=rng.normal(size=(M, 2)),
                  postfit=rng.normal(size=(M, 2)), ratio=rng.uniform(0, 4, M),
                  rejected=rng.uniform(size=M) < 0.3, types=TYPES)
    res, res_ref = ScanODResult(**fields), RScanODResult(**fields)
    assert res.accepted == res_ref.accepted == int((~fields["rejected"]).sum())
    tab = pq.read_table(res.to_parquet(tmp_path / "p.parquet"))
    tab_ref = pq.read_table(res_ref.to_parquet(tmp_path / "r.parquet"))
    assert tab.column_names == tab_ref.column_names
    for name in tab.column_names:
        np.testing.assert_array_equal(np.asarray(tab[name]), np.asarray(tab_ref[name]))


# ---------------------------------------------------------------- estimates
@pytest.mark.parametrize("frame", ["ric", "vnc", "inertial"])
def test_randomized_estimate_and_checks_match_reference(frame):
    """to_estimate_randomized draws the reference's dispersion to the bit
    (the same host numpy Cholesky and generator); within_sigma,
    deviation_within_sigma and within_3sigma agree; the Keplerian
    covariance (torch.func.jacfwd against jax.jacfwd) within 1e-9 relative
    to its largest entry, the RIC and VNC covariances within 1e-12
    relative."""
    epoch = P.Epoch.from_gregorian_utc(2024, 2, 29, 12)
    orbit = P.Orbit.keplerian(1887.4, 0.00212, 33.6, 45.0, 45.0, 10.0, epoch, P.Frames.MOON_J2000)
    sc = P.Spacecraft.new(orbit, 1018.0, 900.0, 10.53, 0.0, 0.96, 2.2)
    sc_ref = R.Spacecraft.new(R.Orbit.cartesian(*orbit.r_km, *orbit.v_km_s,
                                                R.Epoch.from_tai_seconds_j2000(epoch.to_tai_seconds()),
                                                R.Frames.MOON_J2000),
                              1018.0, 900.0, 10.53, 0.0, 0.96, 2.2)
    kw = dict(frame=frame, x_km=0.5, y_km=0.3, z_km=0.5, vx_km_s=5e-3, vy_km_s=5e-3, vz_km_s=2e-3, cr=0.1)
    est, disp = SpacecraftUncertainty(nominal=sc, **kw).to_estimate_randomized(np.random.default_rng(123))
    est_r, disp_r = RSpacecraftUncertainty(nominal=sc_ref, **kw).to_estimate_randomized(
        np.random.default_rng(123))
    np.testing.assert_array_equal(disp.to_vector(), disp_r.to_vector())
    np.testing.assert_array_equal(est.covar, est_r.covar)
    est, est_r = replace(est, nominal=disp), replace(est_r, nominal=disp_r)
    est.state_deviation[:] = est_r.state_deviation[:] = np.sqrt(np.diag(est.covar)) * 2.0
    for n in (1.0, 3.0):
        assert est.within_sigma(sc, n) == est_r.within_sigma(sc_ref, n)
        assert est.deviation_within_sigma(n) == est_r.deviation_within_sigma(n)
    assert est.within_3sigma() and not est.deviation_within_sigma(1.0)
    k, k_ref = est.keplerian_covar(), est_r.keplerian_covar()
    assert np.abs(k - k_ref).max() < 1e-9 * np.abs(k_ref).max()
    for lf in ("ric", "vnc"):
        c, c_ref = est.covar_in_frame(lf), est_r.covar_in_frame(lf)
        assert np.abs(c - c_ref).max() < 1e-12 * np.abs(c_ref).max()


# ---------------------------------------------------------------- scenes
@pytest.fixture(scope="module")
def leo():
    """A two-body LEO truth over 4 h from the reference, carried to the
    port."""
    epoch = R.Epoch.from_gregorian_utc(2021, 3, 4)
    orbit = R.Orbit.keplerian(7000.0, 0.001, 51.6, 30.0, 65.0, 0.0, epoch, R.Frames.EME2000)
    dyn = RSpacecraftDynamics.new(ROrbitalDynamics.two_body(R.Frames.EME2000))
    prop = RPropagator.rk89(dyn, RIntegratorOptions(max_step_s=60.0))
    _, traj = prop.with_state(R.Spacecraft.from_orbit(orbit)).for_duration_with_traj(LEO_S)
    # the reference's stations, shared by the simulator cases: each jits
    # its geometry once
    return dict(traj=traj, ptraj=_port_traj(traj), stations_ref=_stations(R))


def _stations(M, **kw):
    gs, sn, wn = ((RGroundStation, rnoise.StochasticNoise, rnoise.WhiteNoise) if M is R
                  else (GroundStation, StochasticNoise, WhiteNoise))
    out = [gs.dss65_madrid(10.0), gs.dss13_goldstone(10.0), gs.dss34_canberra(10.0)]
    for g in out:
        g.stochastic_noises = {TYPES[0]: sn(wn(2.0e-3)), TYPES[1]: sn(wn(3.0e-6))}
        for k, v in kw.items():
            setattr(g, k, v)
    return out


SIM_CASES = ["intermittent", "alignment", "manual_strands", "terrain_mask", "timestamp_noise",
             "greedy"]


def _sim_case(case, M, epoch0, st):
    """(stations, configs) of one simulator feature for package M, on the
    stations `st` (their terrain mask and timestamp noise reset first)."""
    S, T = (RScheduler, RTrkConfig) if M is R else (Scheduler, TrkConfig)
    for g in st:
        g.terrain_mask = g.timestamp_noise_s = None
    sched = S(min_samples=3)
    cfg = lambda sch: {g.name: T(sampling_s=30.0, scheduler=sch) for g in st}  # noqa: E731
    if case == "intermittent":
        return st, cfg(S.intermittent(600.0, 300.0, min_samples=3))
    if case == "alignment":
        return st, cfg(S(min_samples=3, sample_alignment_s=120.0))
    if case == "greedy":
        return st, cfg(S(handoff="greedy", min_samples=3))
    if case == "manual_strands":
        ep = (lambda s: epoch0 + s)
        return st, {st[0].name: T(sampling_s=60.0, strands=[(ep(600.0), ep(2400.0)), (ep(9000.0), ep(9600.0))]),
                    st[1].name: T(sampling_s=60.0, strands=[(ep(5000.0), ep(5400.0))]),
                    st[2].name: T(sampling_s=60.0, strands=[])}
    if case == "terrain_mask":
        mask = (RTerrainMask if M is R else TerrainMask)(np.array([0.0, 90.0, 200.0]),
                                                         np.array([12.0, 25.0, 15.0]))
        for g in st:
            g.terrain_mask = mask
        return st, cfg(sched)
    if case == "timestamp_noise":
        sn, wn = (rnoise.StochasticNoise, rnoise.WhiteNoise) if M is R else (StochasticNoise, WhiteNoise)
        for g in st:
            g.timestamp_noise_s = sn(wn(1e-3))
        return st, cfg(sched)
    raise KeyError(case)


@pytest.mark.parametrize("case", SIM_CASES)
def test_simulator_feature_matches_reference(case, leo):
    """TrackingArcSim with intermittent cadence (600 s on, 300 s off),
    strand alignment (120 s on a 30 s cadence), manual strands (gated
    measurement by measurement), an azimuth-dependent terrain mask,
    timestamp noise (1 ms white, drawn before the types' noise) and the
    greedy hand-off, fed the reference's truth: the same strands, epochs
    (1e-9 s), trackers, and values within 1e-9 of each column's scale, for
    one seed."""
    traj, ptraj = leo["traj"], leo["ptraj"]
    st, cfg = _sim_case(case, P, ptraj.epoch0, _stations(P))
    st_r, cfg_r = _sim_case(case, R, traj.epoch0, leo["stations_ref"])
    sim = TrackingArcSim.with_seed(st, ptraj, cfg, seed=3, device="cpu")
    sim_r = RTrackingArcSim.with_seed(st_r, traj, cfg_r, seed=3)
    strands, strands_r = sim.build_schedule(), sim_r.build_schedule()
    assert [(s.device, s.start_idx, s.end_idx) for s in strands] == \
        [(s.device, s.start_idx, s.end_idx) for s in strands_r]
    arc, arc_r = sim.generate_measurements(), sim_r.generate_measurements()
    gap = _assert_same_arc(arc, arc_r)
    print(f"{case}: {len(strands)} strands, {len(arc)} rows, values {gap:.2e}")
    if case == "timestamp_noise":
        assert np.abs((arc.epochs_tai_s - arc.epochs_tai_s[0]) % 30.0).max() > 1e-5
    if case == "intermittent":
        rel = arc.epochs_tai_s - ptraj.epoch0.to_tai_seconds()
        assert (rel % 900.0 < 600.0 + 1e-6).all()


# ---------------------------------------------------------------- YAML
def test_station_and_tracking_yaml_round_trip(tmp_path):
    """Stations saved by the port load in both packages (one, a list, and
    the named map; one in TOML too), and the reference's saved stations
    load in the port,
    with the same coordinates, frame, mask, types, two-way time, light time
    and noises; a tracking YAML written by the test (durations as strings,
    a manual strand) loads to the same configs in both."""
    st = _stations(P)
    st[1].integration_time_s = 60.0
    st[1].light_time_correction = True
    st[2].stochastic_noises[TYPES[0]] = StochasticNoise(
        WhiteNoise(1e-3), pnoise.GaussMarkov(tau_s=86400.0, process_noise=5e-3))
    save_ground_stations(st, tmp_path / "many.yaml")
    st[0].save(tmp_path / "one.yaml")
    RGroundStation.save(_stations(R)[2], tmp_path / "ref.yaml")

    def same(a, b):
        assert (a.name, a.latitude_deg, a.longitude_deg, a.height_km, a.elevation_mask_deg) == \
            (b.name, b.latitude_deg, b.longitude_deg, b.height_km, b.elevation_mask_deg)
        assert a.frame.center == b.frame.center and tuple(a.measurement_types) == tuple(b.measurement_types)
        assert (a.integration_time_s or 0.0) == (b.integration_time_s or 0.0)
        assert a.light_time_correction == b.light_time_correction
        for t in TYPES:
            assert a.stochastic_noises[t].covariance() == b.stochastic_noises[t].covariance()

    many, many_r = GroundStation.load_many(tmp_path / "many.yaml"), RGroundStation.load_many(tmp_path / "many.yaml")
    for a, b, c in zip(st, many, many_r):
        same(b, a)
        same(c, a)
    named = GroundStation.load_named(tmp_path / "many.yaml")
    assert list(named) == [g.name for g in st] and named[st[1].name].frame == P.Frames.IAU_EARTH
    same(GroundStation.load(tmp_path / "one.yaml"), RGroundStation.load(tmp_path / "one.yaml"))
    same(GroundStation.load(tmp_path / "ref.yaml"), _stations(R)[2])
    # TOML too, as a [[stations]] array of tables (the reference's layout)
    st[0].save(tmp_path / "one.toml")
    same(GroundStation.load(tmp_path / "one.toml"), r_load_ground_stations(tmp_path / "one.toml")[0])

    (tmp_path / "trk.yaml").write_text(
        "Madrid:\n  sampling: 1 min\n  scheduler:\n    handoff: Greedy\n    cadence: Continuous\n"
        "    min_samples: 5\n    sample_alignment: 10 s\n"
        "Goldstone:\n  sampling: 30 s\n  strands:\n    - start: 2021-03-04T00:10:00 UTC\n"
        "      end: 2021-03-04T01:00:00 UTC\n")
    cfg, cfg_r = load_trk_configs(tmp_path / "trk.yaml"), r_load_trk_configs(tmp_path / "trk.yaml")
    assert list(cfg) == list(cfg_r) == ["Madrid", "Goldstone"]
    for name in cfg:
        a, b = cfg[name], cfg_r[name]
        assert a.sampling_s == b.sampling_s
        assert (a.scheduler is None) == (b.scheduler is None)
        if a.scheduler is not None:
            assert (a.scheduler.handoff, a.scheduler.cadence, a.scheduler.min_samples,
                    a.scheduler.sample_alignment_s) == (b.scheduler.handoff, b.scheduler.cadence,
                                                        b.scheduler.min_samples, b.scheduler.sample_alignment_s)
        assert [(s.to_tai_seconds(), e.to_tai_seconds()) for s, e in a.strands or []] == \
            [(s.to_tai_seconds(), e.to_tai_seconds()) for s, e in b.strands or []]
    (tmp_path / "one_trk.yaml").write_text("sampling: 10 s\n")
    assert load_trk_configs(tmp_path / "one_trk.yaml")[""].sampling_s == 10.0


# ---------------------------------------------------------------- interlink
@pytest.fixture(scope="module")
def link(leo):
    """The LEO truth as a transmitter, and a receiver 400 km lower (the
    same states scaled), in both packages."""
    traj, ptraj = leo["traj"], leo["ptraj"]
    rng = np.random.default_rng(9)
    t = np.sort(rng.uniform(traj.ts[0], traj.ts[-1] - 1.0, 48))
    rx = np.stack([ptraj.interpolate(x)[:6] for x in t]) * np.r_[[0.94] * 3, [1.03] * 3]
    rx[:, :3] = np.roll(rx[:, :3], 1, axis=1)
    kw = dict(name="tx", occulting_radius_km=6378.1363)
    return dict(t_tdb=traj.epoch0.to_tdb_seconds() + t, rx=rx, tx=InterlinkTxSpacecraft(ptraj, **kw),
                tx_r=RInterlinkTxSpacecraft(traj, **kw))


def test_device_trajectory_state_at_matches_reference(leo):
    """DeviceTrajectory.from_trajectory resamples on the reference's 60 s
    grid (the same times; states within 1e-9 km: one batched interpolation
    against a loop of single ones), and state_at, batched, matches the
    reference's per-epoch lookup within 1e-9 km and 1e-12 km/s, including
    the clamped ends."""
    traj, ptraj = leo["traj"], leo["ptraj"]
    dt, dt_r = DeviceTrajectory.from_trajectory(ptraj), RDeviceTrajectory.from_trajectory(traj)
    np.testing.assert_array_equal(dt.ts, np.asarray(dt_r.ts))
    assert np.abs(dt.ys - np.asarray(dt_r.ys)).max() < 1e-9
    assert dt.center == NAIF.EARTH
    t = np.concatenate([np.random.default_rng(4).uniform(dt.ts[0], dt.ts[-1], 64), dt.ts[[0, 1, -1]]])
    got = dt.state_at(torch.tensor(t, dtype=torch.float64)).numpy()
    ref = np.stack([np.asarray(dt_r.state_at(jnp.float64(x))) for x in t])
    assert np.abs(got[:, :3] - ref[:, :3]).max() < 1e-9
    assert np.abs(got[:, 3:] - ref[:, 3:]).max() < 1e-12


def test_interlink_values_and_los_match_reference(link):
    """The crosslink range, Doppler and position values, one and two way,
    within 1e-9 of each column's scale of the reference's, the
    line-of-sight pseudo-elevations equal (some occulted by the Earth's
    sphere, some clear), batch_values and batch_azel on the CPU, and the
    measurement covariance."""
    tx, tx_r = link["tx"], link["tx_r"]
    t, rx = link["t_tdb"], link["rx"]
    types = TYPES + (MeasurementType.X_KM, MeasurementType.Z_KM)
    f64 = dict(dtype=torch.float64)
    tt, rr = torch.tensor(t, **f64), torch.tensor(rx, **f64)
    vals = tx._link_values(tt, rr, types).numpy()
    vals_r = np.stack([np.asarray(tx_r._link_values(jnp.float64(a), jnp.asarray(b), types)) for a, b in zip(t, rx)])
    assert _col_rel(vals, vals_r) < 1e-9
    los = tx._los_clear(tt, rr).numpy()
    los_r = np.array([float(tx_r._los_clear(jnp.float64(a), jnp.asarray(b))) for a, b in zip(t, rx)])
    np.testing.assert_array_equal(los, los_r)
    assert 0 < (los < 0).sum() < len(los)
    bv, bel = tx.batch_values(t, rx, device="cpu")
    bv_r, bel_r = tx_r.batch_values(t, rx)
    assert _col_rel(bv, bv_r) < 1e-9
    np.testing.assert_array_equal(bel, bel_r)
    np.testing.assert_array_equal(tx.batch_azel(t, rx, device="cpu")[1], bel_r)
    tx.integration_time_s = tx_r.integration_time_s = 10.0
    two = tx.two_way_fn()(tt, rr, rr * 0.999)
    two_r = np.stack([np.asarray(tx_r.two_way_fn()(jnp.float64(a), jnp.asarray(b), jnp.asarray(b * 0.999)))
                      for a, b in zip(t, rx)])
    assert _col_rel(two.numpy(), two_r) < 1e-9
    np.testing.assert_array_equal(tx.measurement_covar(), tx_r.measurement_covar())
    assert (tx.batch_azel(t, rx, device="cpu")[0] == 0).all()


def test_interlink_rows_match_reference_jacobian(link):
    """The filter's interlink observation stage (`interlink_rows`: the
    transmitter's table gathered by tracker index, its searchsorted outside
    the tangent) against the reference's `_interlink_obs` with jax.jacfwd:
    values and H (range and Doppler, one-way and two-way over 10 s, two
    devices of different table lengths) within 1e-12 of each column's
    scale."""
    from nyx_tpu.od.scan_filter import _interlink_obs

    tx, t, rx = link["tx"], link["t_tdb"], link["rx"]
    short = DeviceTrajectory(tx.dev_traj.ts[:200], tx.dev_traj.ys[:200], tx.dev_traj.center)
    ts_tab, ys_tab = stack_tables([tx.dev_traj, short], "cpu")
    m = len(t)
    trk = np.where(t < short.ts[-2] - 20.0, np.arange(m) % 2, 0)
    tint = np.where(np.arange(m) % 3 == 0, 10.0, 0.0)
    rx_tm = rx * 0.9999
    f64 = dict(dtype=torch.float64)
    vals, h = interlink_rows(torch.tensor(t, **f64), torch.tensor(rx, **f64), torch.tensor(rx_tm, **f64),
                             torch.tensor(trk), torch.tensor(tint, **f64), ts_tab, ys_tab, TYPES)
    ts_j, ys_j = jnp.asarray(ts_tab.numpy()), jnp.asarray(ys_tab.numpy())
    ref_v, ref_h = [], []
    for i in range(m):
        def f(rv, tq, k=trk[i]):
            return _interlink_obs(jnp.float64(tq), rv, ts_j[k], ys_j[k], TYPES)
        v1, h1 = np.asarray(f(jnp.asarray(rx[i]), t[i])), np.asarray(jax.jacfwd(f)(jnp.asarray(rx[i]), t[i]))
        if tint[i] > 0:
            v0 = np.asarray(f(jnp.asarray(rx_tm[i]), t[i] - tint[i]))
            h0 = np.asarray(jax.jacfwd(f)(jnp.asarray(rx_tm[i]), t[i] - tint[i]))
            back = np.eye(6)
            back[0:3, 3:6] = -tint[i] * np.eye(3)
            v1, h1 = 0.5 * (v0 + v1), 0.5 * (h1 + h0 @ back)
        ref_v.append(v1)
        ref_h.append(h1)
    ref_v, ref_h = np.stack(ref_v), np.stack(ref_h)
    assert _col_rel(vals.numpy(), ref_v) < 1e-12
    assert (h[:, :, 6:] == 0).all()
    assert float((np.abs(h[:, :, :6].numpy() - ref_h).max(axis=(0, 2)) / np.abs(ref_h).max(axis=(0, 2))).max()) < 1e-12


@pytest.mark.cuda
def test_interlink_rows_on_card_match_cpu():
    """The interlink observation stage (`interlink_rows`, one-way and
    two-way rows over two transmitter tables) on the card against the CPU:
    values and H within 1e-12 of each column's scale. The transmitter and
    the receiver are the port's own two-body LEO propagations (on the
    CPU), so the test needs no JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nyx_tpu_torch.dynamics import OrbitalDynamics, SpacecraftDynamics

    epoch = P.Epoch.from_gregorian_utc(2021, 3, 4)
    prop = Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000)),
                           IntegratorOptions(max_step_s=60.0))
    trajs = [prop.with_state(P.Spacecraft.from_orbit(P.Orbit.keplerian(
        sma, 0.001, inc, 30.0, 65.0, 0.0, epoch, P.Frames.EME2000)), device="cpu").for_duration_with_traj(7200.0)[1]
        for sma, inc in ((7000.0, 51.6), (7400.0, 20.0), (6800.0, 80.0))]
    tables = [DeviceTrajectory.from_trajectory(t) for t in trajs[:2]]
    rng = np.random.default_rng(9)
    t_rel = np.sort(rng.uniform(30.0, 7100.0, 40))
    rx = trajs[2].interpolate_many(t_rel)[:, :6]
    rx_tm = trajs[2].interpolate_many(t_rel - 10.0)[:, :6]
    trk = np.arange(len(t_rel)) % 2
    tint = np.where(np.arange(len(t_rel)) % 3 == 0, 10.0, 0.0)
    out = {}
    for dev in ("cpu", "cuda"):
        f64 = dict(dtype=torch.float64, device=dev)
        v, h = interlink_rows(torch.tensor(epoch.to_tdb_seconds() + t_rel, **f64), torch.tensor(rx, **f64),
                              torch.tensor(rx_tm, **f64), torch.tensor(trk, device=dev),
                              torch.tensor(tint, **f64), *stack_tables(tables, dev), TYPES)
        out[dev] = (v.cpu().numpy(), h.cpu().numpy().reshape(len(t_rel), -1))
    assert _col_rel(out["cuda"][0], out["cpu"][0]) < 1e-12
    h_cpu = out["cpu"][1]
    assert np.abs(out["cuda"][1] - h_cpu).max() < 1e-12 * np.abs(h_cpu).max()


# ---------------------------------------------------------------- cross-body
def test_with_target_frame_geometry():
    """A DSN station tracking a lunar orbiter through its centre-offset
    table (tests/test_od.py:1382-1408): the range is the Earth-Moon
    distance and agrees with the manual re-centring through the almanac
    within 1e-3 km; the values agree with the reference's offset station
    within 1e-9 of each column's scale, and its offset table equals the
    reference's within 1e-9 km."""
    alm, alm_r = Almanac(), RAlmanac()
    epoch = P.Epoch.from_gregorian_utc(2024, 2, 29, 12)
    epoch_r = R.Epoch.from_gregorian_utc(2024, 2, 29, 12)
    orbit = P.Orbit.keplerian(1887.4, 0.002, 33.6, 45.0, 45.0, 0.0, epoch, P.Frames.MOON_J2000)
    gs, gs_r = GroundStation.dss65_madrid(5.0), RGroundStation.dss65_madrid(5.0)
    gs_x = gs.with_target_frame(alm, NAIF.MOON, epoch, epoch + 3600.0)
    gs_xr = gs_r.with_target_frame(alm_r, RNAIF.MOON, epoch_r, epoch_r + 3600.0)
    off, off_r = gs_x.target_center_offset, gs_xr.target_center_offset
    np.testing.assert_array_equal(off.ts, np.asarray(off_r.ts))
    assert np.abs(off.ys - np.asarray(off_r.ys)).max() < 1e-9 and off.center == NAIF.MOON
    rv6 = np.concatenate([orbit.r_km, orbit.v_km_s])
    t = epoch.to_tdb_seconds() + np.array([0.0, 900.0, 1800.0, 3600.0])
    f64 = dict(dtype=torch.float64)
    rows = torch.tensor(np.repeat(rv6[None], len(t), 0), **f64)
    types = TYPES + (MeasurementType.AZIMUTH_DEG, MeasurementType.ELEVATION_DEG)
    vals = gs_x.measurement_fn(types)(torch.tensor(t, **f64), rows).numpy()
    assert (330_000 < vals[:, 0]).all() and (vals[:, 0] < 440_000).all()
    r_m = alm.position(NAIF.MOON, NAIF.EARTH, t)
    manual = gs.measurement_fn(types)(torch.tensor(t, **f64), torch.tensor(np.concatenate(
        [orbit.r_km + r_m, np.repeat(orbit.v_km_s[None], len(t), 0)], axis=1), **f64)).numpy()
    assert np.abs(vals[:, 0] - manual[:, 0]).max() < 1e-3
    ref = np.stack([np.asarray(gs_xr._one_way(jnp.float64(x), jnp.asarray(rv6), types)) for x in t])
    assert _col_rel(vals, ref) < 1e-9
    assert gs_x.elevation_of(float(t[1]), rv6, device="cpu") == pytest.approx(
        gs_xr.elevation_of(float(t[1]), rv6), abs=1e-9)


def test_device_families_and_centres_are_checked(leo):
    """ScanKalmanOD and TrackingArcSim accept interlink transmitters and
    offset stations; a station about another body without an offset table
    is still refused, as are mixed families and offsets on some stations
    only, with the reference's ConfigError wording."""
    from nyx_tpu_torch.dynamics import OrbitalDynamics, SpacecraftDynamics

    alm = Almanac()
    ptraj, traj = leo["ptraj"], leo["traj"]
    moon_traj = _port_traj(traj, P.Frames.MOON_J2000)
    prop = Propagator.rk89(SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.MOON_J2000)),
                           IntegratorOptions())
    st = _stations(P)
    end = ptraj.epoch0 + LEO_S
    offset = [g.with_target_frame(alm, NAIF.MOON, ptraj.epoch0, end) for g in st]
    TrackingArcSim.with_seed(offset, moon_traj, {}, seed=0, device="cpu")
    with pytest.raises(ConfigError, match="with_target_frame"):
        TrackingArcSim.with_seed(st, moon_traj, {}, seed=0, device="cpu")
    with pytest.raises(ConfigError, match="with_target_frame"):
        TrackingArcSim.with_seed(offset, ptraj, {}, seed=0, device="cpu")
    tx = InterlinkTxSpacecraft(moon_traj, name="tx")
    TrackingArcSim.with_seed([tx], moon_traj, {}, seed=0, device="cpu")
    ScanKalmanOD(prop, [tx], types=TYPES, device="cpu")
    ScanKalmanOD(prop, offset, types=TYPES, device="cpu")
    with pytest.raises(ConfigError, match="all ground stations or all interlink transmitters"):
        ScanKalmanOD(prop, [tx] + offset, types=TYPES, device="cpu")
    with pytest.raises(ConfigError, match="target frame offset, or none"):
        ScanKalmanOD(prop, offset[:1] + st[1:], types=TYPES, device="cpu")
    est = interop.kf_estimate_from_numpy(ptraj.ys[0, :9], np.eye(9), ptraj.epoch0.to_tai_seconds(),
                                         P.Frames.MOON_J2000)
    arc = TrackingDataArc((st[0].name,), TYPES, np.array([ptraj.epoch0.to_tai_seconds() + 60.0]),
                          np.zeros(1, dtype=np.int64), np.ones((1, 2)))
    with pytest.raises(ConfigError, match="with_target_frame"):
        ScanKalmanOD(prop, st, types=TYPES, device="cpu").process_arc(est, arc)


# ---------------------------------------------------------------- ex05
def _ex05_reference():
    """examples/05_caps_interlink_od.py:62-233 in the reference, with
    NYX_EX05_TX_HOURS = 2 (its own knob), the while loop (bitwise the
    example's fixed-trip scan while the budget suffices) and no AOT cache."""
    alm = RAlmanac()
    moon = R.Frames.MOON_J2000
    epoch = R.Epoch.from_gregorian_tai(2021, 5, 29, 19, 51, 16.852)
    nrho = R.Orbit.cartesian(166_473.631_302_239_7, -274_715.487_253_382_7, -211_233.210_176_686_7,
                             0.933_451_604_520_018_4, 0.436_775_046_841_900_9, -0.082_211_021_250_348_95,
                             epoch, R.Frames.EME2000)
    dyn = RSpacecraftDynamics.new(ROrbitalDynamics.from_models([RPointMasses((RNAIF.EARTH, RNAIF.SUN))], moon))
    setup = RPropagator.rk89(dyn, replace(RIntegratorOptions.with_adaptive_step(0.1, 30.0, 1e-9),
                                          integration_frame=moon))
    prop_time = chip_smoke.EX05_HOURS * 3600.0
    _, tx_traj = setup.with_state(R.Spacecraft.from_orbit(nrho), alm).for_duration_with_traj(
        prop_time, n_capture=16384)
    llo_sc = R.Spacecraft.from_orbit(R.Orbit.keplerian(1737.4 + 110.0, 1e-4, 90.0, 0.0, 0.0, 0.0, epoch, moon))
    _, llo_traj = setup.with_state(llo_sc, alm).for_duration_with_traj(prop_time, n_capture=16384)
    noises = {
        TYPES[0]: rnoise.StochasticNoise.from_hardware_range_km(1e-11, 10.0, rnoise.ChipRate.StandardT4B,
                                                               rnoise.SN0.Average),
        TYPES[1]: rnoise.StochasticNoise.from_hardware_doppler_km_s(1e-11, 10.0, rnoise.CarrierFreq.SBand,
                                                                   rnoise.CN0.Average),
    }
    link = RInterlinkTxSpacecraft(tx_traj, name="NRHO Tx SC", occulting_radius_km=1737.4)
    link.stochastic_noises = noises
    cfg = RTrkConfig(sampling_s=60.0, strands=[(epoch, epoch + prop_time)])
    arc = RTrackingArcSim.with_seed([link], llo_traj, {"NRHO Tx SC": cfg}, seed=0).generate_measurements()
    unc = RSpacecraftUncertainty(nominal=llo_sc, frame="ric", x_km=1.0, y_km=1.0, z_km=1.0,
                                 vx_km_s=1e-3, vy_km_s=1e-3, vz_km_s=1e-3)
    est0, dispersed = unc.to_estimate_randomized(np.random.default_rng(0))
    est0 = replace(est0, nominal=dispersed, covar=est0.covar * 2.5)
    proc = RInterlinkTxSpacecraft(tx_traj, name="NRHO Tx SC", occulting_radius_km=1737.4)
    proc.stochastic_noises = {t: rnoise.StochasticNoise(rnoise.WhiteNoise(n.white_noise.sigma * 3.0))
                              for t, n in noises.items()}
    od = RScanKalmanOD(setup, [proc], types=TYPES, variant="ekf", resid_rejection_sigmas=3.0, almanac=alm)
    arc_2h = arc.filter_by_offset(0.0, chip_smoke.EX05_OD_S)
    sol = od.process_arc(est0, arc_2h)
    rvr = od.process_arc(est0, arc_2h.resid_vs_ref_check())
    truth = llo_traj.at(R.Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1])))
    return dict(arc=arc, sol=sol, rvr=rvr, dispersed=dispersed, truth=truth.to_vector(), tx_traj=tx_traj,
                llo_traj=llo_traj)


@pytest.fixture(scope="module")
def ex05(tmp_path_factory):
    out = tmp_path_factory.mktemp("ex05")
    return dict(port=chip_smoke.ex05_flow(chip_smoke.EX05_HOURS, device="cpu", out_dir=out),
                ref=_ex05_reference())


def test_ex05_truths_arc_and_draw_match_reference(ex05):
    """ex05's two truths (final states within 1e-6 km), its crosslink arc
    (the same 75 epochs over the 2 h, values within 1e-9 of each column's
    scale: the truths' nodes part at 1e-9 km), the randomized start (1e-15
    relative: the draw is the same, about nominals an ulp apart), and the
    arc's parquet read back by the reference."""
    port, ref = ex05["port"], ex05["ref"]
    for a, b in ((port.tx_traj, ref["tx_traj"]), (port.llo_traj, ref["llo_traj"])):
        assert a.template.frame == P.Frames.MOON_J2000
        assert np.abs(a.ys[-1, :3] - np.asarray(b.ys)[-1, :3]).max() < 1e-6
    gap = _assert_same_arc(port.arc, ref["arc"])
    print(f"ex05 arc: {len(port.arc)} rows, values {gap:.2e}")
    # the same draw about nominals that the two Keplerian conversions put
    # an ulp apart
    np.testing.assert_allclose(port.dispersed.to_vector(), ref["dispersed"].to_vector(), rtol=1e-15, atol=0)
    back = RTrackingDataArc.from_parquet(port.paths[0])
    np.testing.assert_array_equal(back.values, port.arc.values)


def test_ex05_od_matches_reference_and_the_chip_constants(ex05):
    """ex05's 2 h segmented EKF through the port: the reference's row
    count, acceptances and rejections (75, 75, 0), its final state within
    1e-6 km (measured 8.8e-9 km) and the residual-versus-reference run's
    final position within 1e-10 km (measured 4.7e-13 km), that run
    accepting nothing, both result parquets read back; and the port's CPU
    numbers that chip_smoke holds the card to (EX05_CPU_*: the counts
    exactly, the final error within 1 mm)."""
    port, ref = ex05["port"], ex05["ref"]
    sol, sol_r = port.sol, ref["sol"]
    assert len(port.arc_2h) == len(sol_r.epochs_tai_s) == chip_smoke.EX05_CPU_ROWS
    assert sol.accepted == int(np.sum(~np.asarray(sol_r.rejected))) == chip_smoke.EX05_CPU_ACCEPTED
    np.testing.assert_array_equal(sol.rejected, np.asarray(sol_r.rejected))
    d = float(np.abs(sol.final_state()[:6] - np.asarray(sol_r.final_state())[:6]).max())
    d_rvr = float(np.abs(port.rvr.final_state()[:3] - np.asarray(ex05["ref"]["rvr"].final_state())[:3]).max())
    err_r = 1e3 * float(np.linalg.norm(np.asarray(sol_r.final_state())[:3] - ref["truth"][:3]))
    print(f"ex05: final state {d:.3e} from the reference; error {port.err_m:.4f} m (reference "
          f"{err_r:.4f} m), pure propagation {port.prop_err_m:.1f} m (gap {d_rvr:.3e} km), "
          f"RIC {port.err_ric_m}")
    assert d < 1e-6 and d_rvr < 1e-10
    assert port.rvr.accepted == 0
    assert abs(port.err_m - chip_smoke.EX05_CPU_ERROR_M) < 1e-3
    assert abs(port.err_m - chip_smoke.EX05_REFERENCE_ERROR_M) < chip_smoke.EX05_REFERENCE_TOL_M
    for path in port.paths[1:]:
        tab = pq.read_table(path)
        assert tab.num_rows == len(port.arc_2h) and "sigma_x_km" in tab.column_names


# ---------------------------------------------------------------- ex06
# The small ex06: its field cut to degree 8, and stage 2 cut to degree 4
# (the example differentiates its 50x50 field through degree 8: the STM
# sees a cut field in both), which halves the reference's compiles.
EX06_DEG = 8
EX06_JVP = 4
EX06_S = 3600.0


def _ex06_reference(precision, yaml_dir, variant):
    """examples/06_lunar_od.py:90-205 in the reference at degree 8 over
    1 h on the test's YAML (stage 2 cut to EX06_JVP): the truth, the arc
    (perfect stations for the CKF), and the CKF from the truth or the EKF
    from the dispersed start."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("ex06", Path(chip_smoke.HERE) / "examples/06_lunar_od.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    alm = RAlmanac()
    moon = R.Frames.MOON_J2000
    epoch = R.Epoch.from_gregorian_utc(2024, 2, 29, 12, 0, 0.0)
    orbiter = R.Spacecraft.new(R.Orbit.keplerian(1737.4 + 150.0, 0.00212, 33.6, 45.0, 45.0, 0.0, epoch, moon),
                               1018.0, 900.0, 3.9 * 2.7, 0.0, 0.96, 2.2)
    dyn = RSpacecraftDynamics(ROrbitalDynamics.from_models(
        [RHarmonics.from_stor(mod.kaula_moon_field(EX06_DEG), precision=precision),
         RPointMasses((RNAIF.EARTH, RNAIF.SUN, RNAIF.JUPITER_BARYCENTER))], moon),
        (RSolarPressure.default(RNAIF.MOON),))
    setup = RPropagator.rk89(dyn, RIntegratorOptions(tolerance=1e-10, max_step_s=60.0))
    _, traj = setup.with_state(orbiter, alm).for_duration_with_traj(EX06_S)
    devices = RGroundStation.load_named(Path(yaml_dir) / "dsn-network.yaml")
    configs = r_load_trk_configs(Path(yaml_dir) / "tracking-cfg.yaml")
    st = [g.with_target_frame(alm, RNAIF.MOON, epoch, epoch + EX06_S) for g in devices.values()]
    unc = RSpacecraftUncertainty(nominal=orbiter, frame="ric", x_km=0.5, y_km=0.5, z_km=0.5,
                                 vx_km_s=5e-3, vy_km_s=5e-3, vz_km_s=5e-3)
    if variant == "ckf":
        arc = RTrackingArcSim.with_seed([g.perfect() for g in st], traj, configs, seed=123).generate_measurements()
        od = RScanKalmanOD(setup, st, types=TYPES, variant="ckf", almanac=alm, stm_jvp_degree=EX06_JVP)
        return dict(traj=traj, arc=arc, sol=od.process_arc(unc.to_estimate(), arc))
    arc = RTrackingArcSim.with_seed(st, traj, configs, seed=123).generate_measurements()
    est0, disp = unc.to_estimate_randomized(np.random.default_rng(123))
    snc = RProcessNoise.from_velocity_km_s([1e-14] * 3, 3600.0, disable_time_s=600.0)
    od = RScanKalmanOD(setup, st, types=TYPES, variant="ekf", process_noise=(snc,), resid_rejection_sigmas=3.0,
                       almanac=alm, stm_jvp_degree=EX06_JVP, segment_rows=8)
    return dict(traj=traj, arc=arc, sol=od.process_arc(replace(est0, nominal=disp), arc))


def _ex06_port(precision, yaml_dir, variant):
    scene = chip_smoke.ex06_scene(chip_smoke.ex06_moon_field(EX06_DEG), precision, yaml_dir=yaml_dir,
                                  device="cpu")
    _, traj = scene.propagator("auto").with_state(scene.orbiter, scene.almanac, device="cpu") \
        .for_duration_with_traj(EX06_S)
    st = scene.stations(scene.epoch, scene.epoch + EX06_S)
    if variant == "ckf":
        arc = TrackingArcSim.with_seed([g.perfect() for g in st], traj, scene.configs, seed=123,
                                       device="cpu").generate_measurements()
        od = scene.od(st, "auto", "ckf", EX06_JVP)
        return dict(traj=traj, arc=arc, sol=od.process_arc(scene.unc.to_estimate(), arc))
    arc = TrackingArcSim.with_seed(st, traj, scene.configs, seed=123, device="cpu").generate_measurements()
    od = scene.od(st, "auto", "ekf", EX06_JVP)
    return dict(traj=traj, arc=arc, sol=od.process_arc(scene.est0, arc), scene=scene)


@pytest.fixture(scope="module")
def ex06_yaml(tmp_path_factory):
    """The stations' and tracking YAML, written by the port's ex06 scene."""
    d = tmp_path_factory.mktemp("ex06")
    chip_smoke.ex06_scene(chip_smoke.ex06_moon_field(EX06_DEG), "f64", yaml_dir=d, device="cpu")
    return d


@pytest.mark.parametrize("precision,variant", [("f64", "ckf"), ("split", "ekf")])
def test_small_ex06_cross_body_od_matches_reference(precision, variant, ex06_yaml):
    """A small ex06 (degree 8, 1 h): Earth stations from the YAML, each
    with_target_frame to the Moon, tracking the lunar orbiter. The f64
    zero-noise CKF from the truth: the reference's arc (1e-9 of each
    column's scale) and prefits, range under 1e-4 km (the reference's own
    bound, tests/test_od.py:1940-1945), the estimates within 1e-6 km of
    the reference's. The split EKF from the dispersed start: the same arc
    rows, rejections and final estimate within 1e-3 km of the reference's,
    under half the initial error. The truths are held by their final
    states: within 1e-6 km at f64; at split precision the float32 field's
    rounding (the twin's against XLA's, up to 2e-5 of the float32 part)
    steers RK89's step, so within 1e-5 km. Measured: 1.4e-6 km at split."""
    port, ref = _ex06_port(precision, ex06_yaml, variant), _ex06_reference(precision, ex06_yaml, variant)
    d_truth = float(np.abs(port["traj"].ys[-1, :3] - np.asarray(ref["traj"].ys)[-1, :3]).max())
    gap = _assert_same_arc(port["arc"], ref["arc"], tol=1e-9 if precision == "f64" else 1e-8)
    sol, sol_r = port["sol"], ref["sol"]
    d_est = float(np.linalg.norm(sol.y_est[:, :3] - np.asarray(sol_r.y_est)[:, :3], axis=1).max())
    print(f"ex06 {precision} {variant}: truth {d_truth:.3e} km, arc {gap:.2e}, estimates {d_est:.3e} km")
    assert d_truth < (1e-6 if precision == "f64" else 1e-5)
    np.testing.assert_array_equal(sol.rejected, np.asarray(sol_r.rejected))
    if variant == "ckf":
        assert np.abs(sol.prefit[:, 0]).max() < 1e-4
        assert d_est < 1e-6
    else:
        truth = port["traj"].at(P.Epoch.from_tai_seconds_j2000(float(sol.epochs_tai_s[-1]))).to_vector()
        err = float(np.linalg.norm(sol.final_state()[:3] - truth[:3]))
        init = float(np.linalg.norm(port["scene"].dispersed.orbit.r_km - port["scene"].orbit.r_km))
        assert d_est < 1e-3 and err < 0.5 * init, (err, init)
