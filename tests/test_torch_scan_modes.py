"""ScanKalmanOD whole, and the configuration documents: the PyTorch port
against nyx_tpu.

The filter modes the port's scan filter gained: the associative-scan
filter (`filter_mode="parallel"`, without and with the iterated sigma
gate), the per-row modes (`prop_mode` "fixed" and "adaptive", the CKF and
the per-row EKF) with their filler layout, estimated Gauss-Markov
measurement biases (`estimate_biases`), the ensemble of filters
(`process_arc_batch`), and every refusal of the reference; then the Cr and
Cd estimation flags and the documents: spacecraft and integrator options
in YAML and TOML, the Dhall parser and its propagator and sequence
loaders, and DER. The scene is the reference's two-body one
(tests/test_od.py:47-83): a 22,000 km orbit tracked by DSS-65, DSS-34 and
DSS-13 every 60 s, here over 6 h (305 rows, more than the reference's
128-row parallel blocks). The reference's arcs, estimates and trajectory
reach the port through `nyx_tpu_torch.interop`; JAX runs on the CPU in
float64, its filters module-scoped so that each compiles once. Documents
are written by the tests themselves.

Tolerances, unless a test says otherwise: estimates 1e-6 km and 1e-9 km/s,
covariances 1e-10 absolute, identical rejections.

The test marked `cuda` needs only the port. A machine with a card but no
JAX runs it alone with

    python -m pytest --noconftest -m cuda tests/test_torch_scan_modes.py
"""

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import nyx_tpu as R
    from nyx_tpu.cosmic.spacecraft import Thruster as RThruster
    from nyx_tpu.dynamics import Drag as RDrag
    from nyx_tpu.dynamics import Harmonics as RHarmonics
    from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
    from nyx_tpu.dynamics import SolarPressure as RSolarPressure
    from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
    from nyx_tpu.dynamics import sequence as rsequence
    from nyx_tpu.io import config as rconfig
    from nyx_tpu.io import der as rder
    from nyx_tpu.io import dhall as rdhall
    from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
    from nyx_tpu.od import GroundStation as RGroundStation
    from nyx_tpu.od import KfEstimate as RKfEstimate
    from nyx_tpu.od import SpacecraftUncertainty as RSpacecraftUncertainty
    from nyx_tpu.od import TrackingArcSim as RTrackingArcSim
    from nyx_tpu.od import TrkConfig as RTrkConfig
    from nyx_tpu.od.noise import GaussMarkov as RGaussMarkov
    from nyx_tpu.od.noise import StochasticNoise as RStochasticNoise
    from nyx_tpu.od.noise import WhiteNoise as RWhiteNoise
    from nyx_tpu.od.scan_filter import ScanKalmanOD as RScanKalmanOD
    from nyx_tpu.od.simulator import Scheduler as RScheduler
    from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
    from nyx_tpu.propagators import Propagator as RPropagator
except ModuleNotFoundError:  # no JAX: only the port-only `cuda` test can run
    jax = None

import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.cosmic.spacecraft import Thruster
from nyx_tpu_torch.dynamics import Drag, OrbitalDynamics, SolarPressure, SpacecraftDynamics
from nyx_tpu_torch.dynamics import sequence
from nyx_tpu_torch.errors import ConfigError
from nyx_tpu_torch.io import config, der, dhall
from nyx_tpu_torch.od import (
    GroundStation,
    InterlinkTxSpacecraft,
    KfEstimate,
    MeasurementType,
    ScanKalmanOD,
    Scheduler,
    SpacecraftUncertainty,
    TrackingArcSim,
    TrackingDataArc,
    TrkConfig,
)
from nyx_tpu_torch.od.noise import GaussMarkov, StochasticNoise, WhiteNoise
from nyx_tpu_torch.parallel import Mesh
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX and nyx_tpu (the reference)")

ROOT = Path(__file__).parents[1]
ARC_S = 6 * 3600.0
TYPES = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
HEAD_ROWS = 30
EST_KM, EST_KM_S, COV = 1e-6, 1e-9, 1e-10


def _two_body(M):
    od, sd = ((ROrbitalDynamics, RSpacecraftDynamics) if M is R
              else (OrbitalDynamics, SpacecraftDynamics))
    return (RPropagator if M is R else Propagator).rk89(
        sd.new(od.two_body(M.Frames.EME2000)),
        (RIntegratorOptions if M is R else IntegratorOptions)())


def _truth(M):
    epoch = M.Epoch.from_gregorian_utc(2020, 1, 1, 0, 0, 0)
    orbit = M.Orbit.keplerian(22_000.0, 0.01, 30.0, 80.0, 40.0, 0.0, epoch, M.Frames.EME2000)
    return M.Spacecraft.from_orbit(orbit)


def _stations(M, biased=False):
    """DSS-65, DSS-34 and DSS-13 with the DSN white noise (tests/test_od.py
    :36-44); `biased`: DSS-65 and DSS-34 whose range also carries a
    Gauss-Markov bias of tau 30 days and process noise 0.02 km (:535-547)."""
    gs, sn, wn, gm = ((RGroundStation, RStochasticNoise, RWhiteNoise, RGaussMarkov) if M is R
                      else (GroundStation, StochasticNoise, WhiteNoise, GaussMarkov))
    out = [gs.dss65_madrid(10.0), gs.dss34_canberra(10.0)]
    if not biased:
        out.append(gs.dss13_goldstone(10.0))
    for g in out:
        bias = gm(tau_s=30 * 86400.0, process_noise=0.02) if biased else None
        g.stochastic_noises = {TYPES[0]: sn(wn(2.0e-3), bias), TYPES[1]: sn(wn(3.0e-6))}
    return out


def _dispersed(truth, rng, M=None):
    """The reference's `_dispersed_estimate` (tests/test_od.py:85-101):
    150 m and 5 mm/s RIC sigmas, the nominal drawn from them."""
    M = M or R
    est = (RSpacecraftUncertainty if M is R else SpacecraftUncertainty)(
        nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
        vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()
    draw = rng.multivariate_normal(np.zeros(9), est.covar)
    nominal = truth.set_vector(truth.epoch, truth.to_vector() + draw)
    return (RKfEstimate if M is R else KfEstimate).from_covar(nominal, est.covar)


def _to_port_estimate(est):
    return interop.kf_estimate_from_numpy(est.nominal.to_vector(), est.covar,
                                          est.epoch.to_tai_seconds())


def _to_port_arc(arc):
    return interop.tracking_arc_from_numpy(arc.trackers, arc.types, arc.epochs_tai_s,
                                           arc.tracker_idx, arc.values)


def _head(arc, n):
    """The arc's first n rows (either package's arc)."""
    return replace(arc, epochs_tai_s=arc.epochs_tai_s[:n], tracker_idx=arc.tracker_idx[:n],
                   values=arc.values[:n])


def _corrupt(arc, rng, share, mixed):
    """The reference's outlier scenes: `share` of the range rows moved by
    +5 km (tests/test_od.py:662-667) or, `mixed`, by 0.5-50 km of either
    sign (:705-715). Returns the arc and the corrupted rows."""
    vals = np.array(arc.values)
    col = arc.types.index(MeasurementType.RANGE_KM)
    n_bad = int(share * len(arc))
    bad = rng.choice(len(arc), size=n_bad, replace=False)
    vals[bad, col] += (rng.choice([-1.0, 1.0], n_bad) * rng.uniform(0.5, 50.0, n_bad)
                       if mixed else 5.0)
    return replace(arc, values=vals), bad


def _gaps(sol, ref):
    """(position, velocity and covariance gaps over every row)."""
    y, yr = sol.y_est, np.asarray(ref.y_est)
    return (float(np.abs(y[:, :3] - yr[:, :3]).max()), float(np.abs(y[:, 3:6] - yr[:, 3:6]).max()),
            float(np.abs(sol.covar - np.asarray(ref.covar)).max()))


def _hold(sol, ref, label, est_km=EST_KM, est_km_s=EST_KM_S, cov=COV):
    d_pos, d_vel, d_cov = _gaps(sol, ref)
    print(f"\n{label}: estimates {d_pos:.3e} km, {d_vel:.3e} km/s, covariances {d_cov:.3e}")
    assert sol.y_est.shape == np.asarray(ref.y_est).shape
    np.testing.assert_array_equal(sol.rejected, np.asarray(ref.rejected))
    assert d_pos < est_km and d_vel < est_km_s and d_cov < cov, (d_pos, d_vel, d_cov)


def _od(M, stations, **kw):
    if M is R:
        return RScanKalmanOD(_two_body(R), stations, types=TYPES, variant=kw.pop("variant", "ckf"),
                             **kw)
    return ScanKalmanOD(_two_body(P), stations, types=TYPES, variant=kw.pop("variant", "ckf"),
                        device="cpu", **kw)


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def scene():
    """The reference's truth, arc (305 rows), a dispersed estimate, the
    two outlier arcs and the bias scene (DSS-65 and DSS-34 with range
    biases every 120 s), each with its port copy."""
    truth = _truth(R)
    _, traj = _two_body(R).with_state(truth).for_duration_with_traj(ARC_S)
    stations = _stations(R)
    cfg = RTrkConfig(sampling_s=60.0, scheduler=RScheduler(min_samples=5))
    arc = RTrackingArcSim.with_seed(stations, traj, {g.name: cfg for g in stations},
                                    seed=0).generate_measurements()
    est = _dispersed(truth, np.random.default_rng(42))
    bad3, rows3 = _corrupt(arc, np.random.default_rng(42), 1 / 33, mixed=False)
    bad18, rows18 = _corrupt(arc, np.random.default_rng(7), 0.18, mixed=True)
    biased = _stations(R, biased=True)
    cfg2 = RTrkConfig(sampling_s=120.0, scheduler=RScheduler(min_samples=5))
    bias_arc = RTrackingArcSim.with_seed(biased, traj, {g.name: cfg2 for g in biased},
                                         seed=5).generate_measurements()
    bias_est = _dispersed(truth, np.random.default_rng(7))
    return dict(
        truth=truth, traj=traj, stations=stations, arc=arc, est=est, bad3=bad3, rows3=rows3,
        bad18=bad18, rows18=rows18, biased=biased, bias_arc=bias_arc, bias_est=bias_est,
        p_arc=_to_port_arc(arc), p_est=_to_port_estimate(est), p_bad3=_to_port_arc(bad3),
        p_bad18=_to_port_arc(bad18), p_bias_arc=_to_port_arc(bias_arc),
        p_bias_est=_to_port_estimate(bias_est),
        p_traj=interop.trajectory_from_numpy(traj.epoch0.to_tai_seconds(), traj.ts, traj.ys))


@pytest.fixture(scope="module")
def ref_parallel(scene):
    """The reference's parallel filter with the 4-sigma gate, compiled
    once: on the clean arc with the gate disarmed (rej_thresh = inf, which
    reruns the same filter three times and rejects nothing: the ungated
    filter exactly) and on both outlier arcs."""
    od = _od(R, scene["stations"], resid_rejection_sigmas=4.0, filter_mode="parallel")
    prog, args, ctx, sc_params, epochs0, real = od._setup(scene["est"], scene["arc"])
    y0 = jnp.asarray(scene["est"].nominal.to_vector())
    p0 = jnp.asarray(scene["est"].covar)
    out, *_ = od._run_stages(prog["stages"], args, y0, p0, ctx, sc_params, epochs0,
                             rej_thresh=np.inf)
    return dict(clean=od._result(scene["arc"], real, *out),
                bad3=od.process_arc(scene["est"], scene["bad3"]),
                bad18=od.process_arc(scene["est"], scene["bad18"]))


# ---------------------------------------------------------------- parallel
@needs_jax
def test_parallel_without_gate_matches_reference(scene, ref_parallel):
    """filter_mode="parallel" without a gate, against the reference's
    parallel filter (blocked by 128 rows; the port's flat scan differs in
    rounding alone)."""
    od = _od(P, _stations(P), filter_mode="parallel")
    sol = od.process_arc(scene["p_est"], scene["p_arc"])
    _hold(sol, ref_parallel["clean"], "parallel, no gate")
    assert not sol.rejected.any()
    assert od.stage_walls_s["s4"] > 0.0


@needs_jax
@pytest.mark.parametrize("case", ["bad3", "bad18"])
def test_parallel_gate_matches_reference(scene, ref_parallel, case):
    """The iterated 4-sigma gate on the reference's two outlier scenes:
    ~3 % of the range rows moved by +5 km (tests/test_od.py:652-690) and
    ~18 % by 0.5-50 km of either sign (:696-747): the reference's
    rejections, every corrupted row among them, and its estimates."""
    od = _od(P, _stations(P), resid_rejection_sigmas=4.0, filter_mode="parallel")
    sol = od.process_arc(scene["p_est"], scene[f"p_{case}"])
    _hold(sol, ref_parallel[case], f"parallel, gate, {case}")
    assert sol.rejected[scene[f"rows{case[3:]}"]].all()


@needs_jax
def test_parallel_matches_own_scan(scene):
    """The port's parallel filter against its own sequential scan at f64
    on the clean arc, and with the gate on the 3 % scene (the same
    rejections): estimates within 1e-6 km."""
    for arc, gate in ((scene["p_arc"], None), (scene["p_bad3"], 4.0)):
        sols = [_od(P, _stations(P), filter_mode=mode, resid_rejection_sigmas=gate).process_arc(
            scene["p_est"], arc) for mode in ("scan", "parallel")]
        d = float(np.abs(sols[0].y_est[:, :3] - sols[1].y_est[:, :3]).max())
        print(f"\nparallel vs scan, gate {gate}: {d:.3e} km")
        assert d < 1e-6
        np.testing.assert_array_equal(sols[0].rejected, sols[1].rejected)


# ---------------------------------------------------------------- per-row modes
ROW_CASES = {
    "fixed-1-ckf": dict(prop_mode="fixed", substeps=1),
    "fixed-2-ckf": dict(prop_mode="fixed", substeps=2),
    "fixed-1-ekf": dict(prop_mode="fixed", substeps=1, variant="ekf"),
    "adaptive-ckf": dict(prop_mode="adaptive"),
}


@pytest.fixture(scope="module")
def ref_rows(scene):
    """The reference's per-row modes on the arc's first HEAD_ROWS rows."""
    head = _head(scene["arc"], HEAD_ROWS)
    return {case: _od(R, scene["stations"], **dict(kw)).process_arc(scene["est"], head)
            for case, kw in ROW_CASES.items()}


@needs_jax
@pytest.mark.parametrize("case", list(ROW_CASES))
def test_row_modes_match_reference(scene, ref_rows, case):
    """prop_mode "fixed" (substeps 1 and 2, the CKF and the per-row EKF)
    and "adaptive" (the CKF) on the arc's first rows. Fixed RK steps are
    deterministic, but the reference's compiled row scan rounds otherwise
    than the same reference run op by op (under jax.disable_jit): on its
    second row, 60 s after a first update of 0.2 km, the prefit moves by
    7.6e-9 km, where the port equals the op-by-op run to the bit. So the
    fixed cases are held to 1e-7 km (measured 4.9e-8), the adaptive one at
    the default tolerances."""
    od = _od(P, _stations(P), **dict(ROW_CASES[case]))
    sol = od.process_arc(scene["p_est"], _head(scene["p_arc"], HEAD_ROWS))
    est_km = 1e-7 if case.startswith("fixed") else EST_KM
    _hold(sol, ref_rows[case], case, est_km=est_km)
    assert od.stage_walls_s["rows"] > 0.0


@needs_jax
@pytest.mark.parametrize("mode,substeps", [("fixed", 1), ("fixed", 3), ("adaptive", 1),
                                           ("batch", 1)])
def test_filler_layout_matches_reference(scene, mode, substeps):
    """`_prepare`'s rows: fillers every max_gap_s * substeps in fixed mode
    (the remainder last), none in adaptive mode; equal to the reference's
    on an arc with its first 3 hours' rows removed (a long gap), at the
    period-derived max_gap_s."""
    keep = scene["arc"].epochs_tai_s > scene["arc"].epochs_tai_s[0] + 3 * 3600.0
    arc = replace(scene["arc"], epochs_tai_s=scene["arc"].epochs_tai_s[keep],
                  tracker_idx=scene["arc"].tracker_idx[keep], values=scene["arc"].values[keep])
    od = _od(P, _stations(P), prop_mode=mode, substeps=substeps)
    rows = od._layout(scene["p_est"], _to_port_arc(arc))
    orbit = scene["est"].nominal.orbit
    period = 2.0 * np.pi * np.sqrt(float(orbit.sma_km) ** 3 / orbit.frame.mu_km3_s2)
    assert od.max_gap_s == float(np.clip(period / 24.0, 60.0, 2700.0))
    ref = _od(R, scene["stations"], prop_mode=mode, substeps=substeps, max_gap_s=od.max_gap_s)
    for a, b in zip(rows, ref._prepare(arc, scene["est"].epoch)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    n_fill = int((~rows[4]).sum())
    assert (n_fill == 0) == (mode == "adaptive")


# ---------------------------------------------------------------- biases
# The two packages' stage-1 nominals are adaptive integrations whose node
# times part by up to 11 s after ~10 steps (their error norms round
# differently, which moves each next step); their quintic interpolations
# then part by ~7e-8 km at the rows, which the filters carry into estimates
# up to a few 1e-6 km apart, depending on the estimate. The cases below
# that run the batch pipeline from other estimates than the clean arc's
# are held to bounds set from these measurements.
BIAS_CASES = {
    "scan-f64": dict(),
    "scan-f32": dict(filter_algebra="f32"),
    "parallel": dict(filter_mode="parallel"),
}


@pytest.fixture(scope="module")
def ref_bias(scene):
    """The reference's bias lanes under the f64 and the f32 scan. Its
    parallel filter runs the same filter in exact arithmetic (within 4e-11
    km of the scan, `test_parallel_matches_own_scan`); its bias lanes'
    compile (~20 s) is left out, and the port's parallel run is held to the
    reference's f64 scan."""
    return {case: _od(R, scene["biased"], estimate_biases=True,
                      **dict(BIAS_CASES[case])).process_arc(scene["bias_est"], scene["bias_arc"])
            for case in ("scan-f64", "scan-f32")}


@needs_jax
@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_bias_lanes_match_reference(scene, ref_bias, case):
    """estimate_biases on the reference's bias scene (tests/test_od.py:
    526-615, here over 6 h): the lanes, each row's bias estimates within
    5e-7 km (measured 1.24e-7; the nominals' gap above) and variances
    within 1e-12 km^2 (7.8e-15), the states within 2e-6 km (7.9e-7) and
    the default tolerances otherwise. The f32 algebra is the port's square-root form,
    the reference's a float32 Joseph chain, 6.5e-6 km and 2.3e-4 (relative
    variance) off its own f64 run: the port's is held to the reference's
    f64 run (the same filter in exact arithmetic) within 1e-5 km and 1e-3,
    and its states within 1e-4 km and 1e-7 km/s and covariances within
    1e-6 km^2 (tests/test_torch_od.py's f32 bounds)."""
    sol = _od(P, _stations(P, biased=True), estimate_biases=True,
              **dict(BIAS_CASES[case])).process_arc(scene["p_bias_est"], scene["p_bias_arc"])
    ref = ref_bias["scan-f64"]
    assert sol.bias_lanes == tuple(ref.bias_lanes) == (
        ("Madrid", MeasurementType.RANGE_KM), ("Canberra", MeasurementType.RANGE_KM))
    d_b = float(np.abs(sol.bias_est - np.asarray(ref.bias_est)).max())
    d_v = float(np.abs(sol.bias_var - np.asarray(ref.bias_var)).max())
    rel_v = float((np.abs(sol.bias_var - np.asarray(ref.bias_var)) / np.asarray(ref.bias_var)).max())
    print(f"\nbias lanes, {case}: estimates {d_b:.3e} km, variances {d_v:.3e} km^2 ({rel_v:.3e})")
    if case == "scan-f32":
        r32 = ref_bias["scan-f32"]
        print(f"reference f32 vs f64: "
              f"{float(np.abs(np.asarray(r32.bias_est) - np.asarray(ref.bias_est)).max()):.3e} km")
        assert d_b < 1e-5 and rel_v < 1e-3, (d_b, rel_v)
        _hold(sol, ref, f"bias lanes, {case}", est_km=1e-4, est_km_s=1e-7, cov=1e-6)
    else:
        assert d_b < 5e-7 and d_v < 1e-12, (d_b, d_v)
        _hold(sol, ref, f"bias lanes, {case}", est_km=2e-6)


# ---------------------------------------------------------------- ensemble
@pytest.fixture(scope="module")
def ensemble(scene):
    rng = np.random.default_rng(5)
    ests = [_dispersed(scene["truth"], rng) for _ in range(4)]
    ref = _od(R, scene["stations"]).process_arc_batch(ests, scene["arc"])
    return ests, ref


@needs_jax
def test_ensemble_matches_reference(scene, ensemble):
    """process_arc_batch over 4 dispersed estimates (tests/test_od.py:
    1348-1374) against the reference's: every member's estimates within
    1e-5 km and 5e-9 km/s (measured 0.71-4.36e-6 km and up to 9.8e-10
    km/s: the nominals' gap above, larger the farther the member starts
    from the truth), covariances and rejections at the default
    tolerances; one member alone against the port's own process_arc
    within 1e-9 km."""
    ests, ref = ensemble
    p_ests = interop.kf_estimates_from_numpy([e.nominal.to_vector() for e in ests],
                                             [e.covar for e in ests],
                                             ests[0].epoch.to_tai_seconds())
    od = _od(P, _stations(P))
    sols = od.process_arc_batch(p_ests, scene["p_arc"])
    assert len(sols) == 4
    for k, (sol, r) in enumerate(zip(sols, ref)):
        _hold(sol, r, f"ensemble member {k}", est_km=1e-5, est_km_s=5e-9)
    solo = od.process_arc(p_ests[2], scene["p_arc"])
    d = float(np.abs(sols[2].y_est[:, :3] - solo.y_est[:, :3]).max())
    print(f"member 2 vs process_arc: {d:.3e} km")
    assert d < 1e-9
    one = od.process_arc_batch(p_ests[2:3], scene["p_arc"])[0]
    assert float(np.abs(one.y_est[:, :3] - solo.y_est[:, :3]).max()) < 1e-9


@needs_jax
def test_ensemble_in_fixed_mode_runs(scene):
    """process_arc_batch in fixed mode: the row loop carries the filters;
    each member as its own fixed-mode run."""
    rng = np.random.default_rng(3)
    p_ests = [_to_port_estimate(_dispersed(scene["truth"], rng)) for _ in range(2)]
    head = _head(scene["p_arc"], 12)
    od = _od(P, _stations(P), prop_mode="fixed")
    sols = od.process_arc_batch(p_ests, head)
    for sol, est in zip(sols, p_ests):
        solo = od.process_arc(est, head)
        assert np.isfinite(sol.y_est).all() and sol.y_est.shape == (12, 9)
        assert float(np.abs(sol.y_est[:, :3] - solo.y_est[:, :3]).max()) < 1e-9


# ---------------------------------------------------------------- refusals
def test_refusals(tmp_path):
    """Each of the reference's refusals, as ConfigError: interlink devices,
    cross-body stations, two-way devices and bias lanes outside the batch
    pipeline; bias lanes with the EKF; the ensemble with the EKF, on one
    device or on a mesh; and unknown modes."""
    prop = _two_body(P)
    truth = _truth(P)
    _, traj = prop.with_state(truth, device="cpu").for_duration_with_traj(600.0)
    link = InterlinkTxSpacecraft(traj)
    cross = _stations(P)[0]
    cross.target_center_offset = object()
    two_way = _stations(P)[0]
    two_way.integration_time_s = 60.0
    for mode in ("fixed", "adaptive"):
        for devices in ([link], [cross], [two_way]):
            with pytest.raises(ConfigError):
                ScanKalmanOD(prop, devices, types=TYPES, prop_mode=mode, device="cpu")
        with pytest.raises(ConfigError):
            ScanKalmanOD(prop, _stations(P, biased=True), types=TYPES, prop_mode=mode,
                         estimate_biases=True, device="cpu")
    for kw in (dict(prop_mode="rows"), dict(filter_mode="blocked")):
        with pytest.raises(ConfigError):
            ScanKalmanOD(prop, _stations(P), types=TYPES, device="cpu", **kw)
    est = SpacecraftUncertainty(nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
                                vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()
    arc = TrackingDataArc(trackers=("Madrid",), types=TYPES,
                          epochs_tai_s=truth.epoch.to_tai_seconds() + np.array([60.0, 120.0]),
                          tracker_idx=np.zeros(2, dtype=np.int64), values=np.full((2, 2), np.nan))
    ekf_bias = ScanKalmanOD(prop, _stations(P, biased=True), types=TYPES, variant="ekf",
                            estimate_biases=True, device="cpu")
    with pytest.raises(ConfigError):
        ekf_bias.process_arc(est, arc)
    with pytest.raises(ConfigError):
        ScanKalmanOD(prop, _stations(P), types=TYPES, variant="ekf",
                     device="cpu").process_arc_batch([est], arc)
    with pytest.raises(ConfigError):  # an EKF ensemble on a mesh too
        ScanKalmanOD(prop, _stations(P), types=TYPES, variant="ekf", device="cpu").process_arc_batch(
            [est], arc, mesh=Mesh((torch.device("cpu"),) * 2))


# ---------------------------------------------------------------- Cr and Cd
@needs_jax
def test_estimation_index_matches_reference():
    for est in (False, True):
        assert (SolarPressure(estimate=est).estimation_index()
                == RSolarPressure(estimate=est).estimation_index())
        assert (replace(Drag.earth_exp(), estimate=est).estimation_index()
                == replace(RDrag.earth_exp(), estimate=est).estimation_index())
    assert SolarPressure(estimate=True).estimation_index() == 6
    assert replace(Drag.earth_exp(), estimate=True).estimation_index() == 7
    assert SolarPressure.default().estimation_index() is None


# ---------------------------------------------------------------- documents
def _spacecraft(M):
    epoch = M.Epoch.from_gregorian_utc(2021, 3, 4, 12, 30, 15)
    orbit = M.Orbit.cartesian(-2436.45, -2436.45, 6891.037, 5.088_611, -5.088_611, 0.0, epoch,
                              M.Frames.EME2000)
    sc = M.Spacecraft.new(orbit, 100.0, 12.5, 2.0, 1.5, 1.8, 2.2)
    thruster = (RThruster if M is R else Thruster)(thrust_N=0.472, isp_s=4435.0)
    return replace(sc, thruster=thruster)


@needs_jax
def test_spacecraft_and_options_documents_match_reference(tmp_path):
    """Spacecraft and integrator-options documents through YAML and TOML:
    the dicts equal the reference's, `toml_dumps` equal byte for byte, and
    each document read back (by both packages) equal to what was written."""
    sc, r_sc = _spacecraft(P), _spacecraft(R)
    d, r_d = config.spacecraft_to_dict(sc), rconfig.spacecraft_to_dict(r_sc)
    assert d == r_d
    assert config.toml_dumps(d) == rconfig.toml_dumps(r_d)
    opts = IntegratorOptions.with_adaptive_step(0.5, 900.0, 1e-11)
    r_opts = RIntegratorOptions.with_adaptive_step(0.5, 900.0, 1e-11)
    o, r_o = config.integrator_options_to_dict(opts), rconfig.integrator_options_to_dict(r_opts)
    assert o == r_o and config.toml_dumps(o) == rconfig.toml_dumps(r_o)
    for ext in ("yaml", "toml"):
        path = tmp_path / f"sc.{ext}"
        config.save_spacecraft(sc, path)
        back, r_back = config.load_spacecraft(path), rconfig.load_spacecraft(path)
        assert config.spacecraft_to_dict(back) == d == rconfig.spacecraft_to_dict(r_back)
        np.testing.assert_array_equal(back.orbit.r_km, sc.orbit.r_km)
        assert back.thruster == sc.thruster
        path = tmp_path / f"opts.{ext}"
        config.save_integrator_options(opts, path)
        back = config.load_integrator_options(path)
        assert back == opts
        assert config.integrator_options_to_dict(back) == rconfig.integrator_options_to_dict(
            rconfig.load_integrator_options(path))
    stations = _stations(P)
    config.save_ground_stations(stations, tmp_path / "gs.toml")
    loaded = config.load_ground_stations(tmp_path / "gs.toml")
    assert [g.name for g in loaded] == [g.name for g in stations]
    assert (tmp_path / "gs.toml").read_text() == rconfig.toml_dumps(
        {"stations": [config.ground_station_to_dict(g) for g in stations]})


DHALL_PROPAGATOR = """
-- a 4x4 JGM3 field about the Earth, RK89 at 1e-11
{ accel_models =
    { gravity_field = Some
        { _1 = { filepath = "%s", degree = 4, order = 4, gunzipped = True }
        , _2 = { ephemeris_id = +399, orientation_id = +399 }
        }
    , point_masses = None { celestial_objects : List Integer }
    }
, force_models = { solar_pressure = None { phi : Optional Double }, drag = None { density : Text } }
, method = "RungeKutta89"
, options =
    { init_step = "60 s", min_step = "0.001 s", max_step = "2700 s"
    , tolerance = 1.0e-11, attempts = 50, fixed_step = False
    , error_ctrl = "RSSCartesianStep"
    }
}
"""

DHALL_SEQUENCE = """
{ seq =
  [ { _1 = "2021-03-04T00:00:00 UTC"
    , _2 = < Activity : { name : Text } | Terminate >.Activity
        { name = "coast", propagator = "two_body", disabled = False
        , guidance = None { law : Text }
        , on_entry = Some (< Staging : {} | Docking : {} | FrameSwap : {} >.Staging
            { decrement_properties = Some { mass = Some { dry_mass_kg = 5.0, extra_mass_kg = 0.5 }
                                          , srp = None { area_m2 : Double }
                                          , drag = None { area_m2 : Double } }
            , impulsive_maneuver = Some { dv_km_s = { _1 = 0.001, _2 = -0.0005, _3 = 0.0 }
                                        , local_frame = "VNC" } })
        }
    }
  , { _1 = "2021-03-04T01:00:00 UTC"
    , _2 = < Activity : { name : Text } | Terminate >.Activity
        { name = "burn", propagator = "two_body", disabled = False
        , guidance = Some
            { law = < FiniteBurn : {} | Kluever : {} >.FiniteBurn
                { start = "2021-03-04T01:00:00 UTC", end = "2021-03-04T01:10:00 UTC"
                , thrust_prct = 0.8, frame = "RCN"
                , representation = < Vector : {} | Angles : {} >.Vector
                    { _1 = 0.0, _2 = 1.0, _3 = 0.0 }
                }
            , thruster_model = "hall", disable_prop_mass = False
            }
        , on_entry = None { x : Text }
        }
    }
  , { _1 = "2021-03-04T02:00:00 UTC", _2 = < Activity : { name : Text } | Terminate >.Terminate }
  ]
, thruster_sets = [ { _1 = "hall", _2 = { thrust_N = 0.472, isp_s = 4435.0 } } ]
, propagators =
  [ { _1 = "two_body"
    , _2 = { accel_models = { point_masses = None { x : Text }, gravity_field = None { x : Text } }
           , force_models = { drag = None { x : Text } }
           , method = "DormandPrince78"
           , options = { tolerance = 1.0e-10, max_step = "10 min" }
           }
    }
  ]
}
"""


@needs_jax
def test_dhall_parser_matches_reference():
    """Dhall text written here (records, lists, text, doubles, integers,
    booleans, Some and None with their types, union selections with and
    without payloads, comments, the empty record, the propagator and
    sequence shapes that sequence.py reads), parsed by both parsers into
    equal Python objects; malformed text raises the port's ConfigError."""
    texts = [
        DHALL_PROPAGATOR % "data/JGM3.cof.gz",
        DHALL_SEQUENCE,
        '[ 1, +2, -3, 4.5, 1.0e-3, "a\\\\b \\"q\\"", True, False, None Double ]',
        "{ a = {=}, b = {}, c = [] }",
        "< Red | Green : Double >.Red",
        "(< A : { x : Natural } >.A { x = 1 })",
        "{ dur = \"1 min\", nested = { deeper = [ { k = Some 3 } ] } }",
    ]
    for text in texts:
        assert dhall.loads(text) == rdhall.loads(text)
    for bad in ("{ a = 1", "{ a 1 }", "[ 1 2 ]", "λ(x : Natural) → x", "{ a = 1 } extra"):
        with pytest.raises(ConfigError):
            dhall.loads(bad)


@needs_jax
def test_dhall_propagator_matches_reference(tmp_path):
    """load_dhall_propagator of the document above, by both packages: the
    same configuration, and the built propagators over 1 h from a LEO
    start within 1e-9 km of each other."""
    path = tmp_path / "prop.dhall"
    path.write_text(DHALL_PROPAGATOR % (ROOT / "data/JGM3.cof.gz"))
    cfg, r_cfg = sequence.load_dhall_propagator(path), rsequence.load_dhall_propagator(path)
    assert cfg.method == r_cfg.method == "rk89"
    assert config.integrator_options_to_dict(cfg.options) == rconfig.integrator_options_to_dict(
        r_cfg.options)
    g, rg = cfg.dynamics.gravity_field, r_cfg.dynamics.gravity_field
    assert (g["degree"], g["order"], g["gunzipped"], str(g["path"])) == (
        rg["degree"], rg["order"], rg["gunzipped"], str(rg["path"]))
    assert (g["frame"].center, g["frame"].orientation) == (rg["frame"].center,
                                                           rg["frame"].orientation)
    sc, r_sc = (M.Spacecraft.from_orbit(M.Orbit.keplerian(
        7000.0, 0.01, 51.6, 20.0, 30.0, 40.0, M.Epoch.from_gregorian_utc(2021, 3, 4),
        M.Frames.EME2000)) for M in (P, R))
    final, _ = cfg.build().with_state(sc, device="cpu").for_duration_with_traj(3600.0)
    r_final, _ = r_cfg.build().with_state(r_sc).for_duration_with_traj(3600.0)
    d = float(np.linalg.norm(final.orbit.r_km - np.asarray(r_final.orbit.r_km)))
    print(f"\nDhall propagator over 1 h: {d:.3e} km")
    assert d < 1e-9


@needs_jax
def test_dhall_sequence_matches_reference(tmp_path):
    """load_dhall_sequence of a two-phase sequence (a coast entered by a
    staging with an impulsive maneuver, then a finite burn under guidance)
    and its Terminate: the same phases, epochs, laws, events, thrusters and
    propagators as the reference's, and the port's sequence validates."""
    path = tmp_path / "seq.dhall"
    path.write_text(DHALL_SEQUENCE)
    seq, r_seq = sequence.load_dhall_sequence(path), rsequence.load_dhall_sequence(path)
    items, r_items = seq._sorted(), r_seq._sorted()
    assert [e.to_tai_seconds() for e, _ in items] == [e.to_tai_seconds() for e, _ in r_items]
    for (_, ph), (_, rph) in zip(items, r_items):
        assert (ph.name, ph.propagator, ph.disabled, ph.terminate) == (
            rph.name, rph.propagator, rph.disabled, rph.terminate)
        assert (ph.on_entry is None) == (rph.on_entry is None)
        if ph.on_entry is not None:
            assert ph.on_entry.kind == rph.on_entry.kind
            assert vars(ph.on_entry.properties) == vars(rph.on_entry.properties)
            np.testing.assert_array_equal(ph.on_entry.impulsive_maneuver.dv_km_s,
                                          rph.on_entry.impulsive_maneuver.dv_km_s)
        assert (ph.guidance is None) == (rph.guidance is None)
        if ph.guidance is not None:
            law, r_law = ph.guidance["law"], rph.guidance["law"]
            assert type(law).__name__ == type(r_law).__name__ == "Maneuver"
            assert (law.thrust_prct, law.frame) == (r_law.thrust_prct, r_law.frame)
            assert law.start.to_tai_seconds() == r_law.start.to_tai_seconds()
            np.testing.assert_array_equal(law.vector, r_law.vector)
            assert ph.guidance["thruster_model"] == rph.guidance["thruster_model"]
    assert seq.thruster_sets == {"hall": Thruster(0.472, 4435.0)}
    assert seq.propagators["two_body"].method == r_seq.propagators["two_body"].method == "dp78"
    assert config.integrator_options_to_dict(seq.propagators["two_body"].options) == \
        rconfig.integrator_options_to_dict(r_seq.propagators["two_body"].options)
    seq.validate()


@needs_jax
def test_der_matches_reference():
    """A spacecraft with a thruster through DER: the port's bytes equal the
    reference's, and decode back equal to the bit; the primitives (REAL's
    special values, INTEGER, BOOLEAN) equal the reference's; every
    measurement type has its ENUMERATED value, round trip, keyed by the
    port's tags (the reference's table names the position types "x", "y",
    "z"), the reference's values on the types both name alike."""
    sc, r_sc = _spacecraft(P), _spacecraft(R)
    data = der.spacecraft_to_der(sc)
    assert data == rder.spacecraft_to_der(r_sc)
    back = der.spacecraft_from_der(data)
    np.testing.assert_array_equal(back.orbit.r_km, sc.orbit.r_km)
    np.testing.assert_array_equal(back.orbit.v_km_s, sc.orbit.v_km_s)
    assert back.orbit.epoch.to_tai_seconds() == sc.orbit.epoch.to_tai_seconds()
    assert (back.orbit.frame.center, back.orbit.frame.orientation) == (
        sc.orbit.frame.center, sc.orbit.frame.orientation)
    for f in ("dry_mass_kg", "prop_mass_kg", "srp_area_m2", "cr", "drag_area_m2", "cd", "thruster",
              "mode"):
        assert getattr(back, f) == getattr(sc, f), f
    for x in (0.0, -0.0, 1.5, -3.25e-300, 6.02e23, float("inf"), float("-inf"), 1 / 3):
        assert der.encode_real(x) == rder.encode_real(x)
        assert der.DerReader(der.encode_real(x)).read_real() == x
    for v in (0, 127, 128, -129, 2**40):
        assert der.encode_integer(v) == rder.encode_integer(v)
    assert der.encode_bool(True) == rder.encode_bool(True)
    assert sorted(der.MEASUREMENT_TYPE_ENUM) == sorted(MeasurementType.ALL)
    for t in MeasurementType.ALL:
        value = der.DerReader(der.encode_enumerated(der.MEASUREMENT_TYPE_ENUM[t])).read_enumerated()
        assert der.MEASUREMENT_TYPE_FROM_ENUM[value] == t
    shared = set(der.MEASUREMENT_TYPE_ENUM) & set(rder.MEASUREMENT_TYPE_ENUM)
    assert len(shared) == 7
    assert all(der.MEASUREMENT_TYPE_ENUM[k] == rder.MEASUREMENT_TYPE_ENUM[k] for k in shared)


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_parallel_and_ensemble_on_card_match_cpu():
    """The port's two-body scene over 2 h, simulated on the CPU, filtered on
    the card and on the CPU at f64. The filter algebra on the same rows (a
    CPU run's stage outputs for 4 estimates, moved to the card): the gated
    parallel filter and the 4-member sequential scan, deviations within
    1e-9 km and the same rejections. The whole pipelines, the gated
    parallel filter and the 4-member ensemble, within 1e-5 km: the
    nominal's adaptive steps round otherwise on the card (its step
    control's powers), so the nodes, and the interpolated nominal, part,
    and a start dispersed by 150 m carries that into the estimates
    (measured 3.3e-6 km). Each ensemble member on the card within 1e-9 km
    of process_arc on the card, at f64 and at f32. (At f32 the two
    devices' algebra parts by the float32 rounding itself: 5.8e-5 km on
    these rows.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import math

    from nyx_tpu_torch.od.scan_filter import filter_parallel, filter_scan

    prop, truth = _two_body(P), _truth(P)
    _, traj = prop.with_state(truth, device="cpu").for_duration_with_traj(7200.0)
    stations = _stations(P)
    cfg = TrkConfig(sampling_s=60.0, scheduler=Scheduler(min_samples=5))
    arc = TrackingArcSim.with_seed(stations, traj, {g.name: cfg for g in stations}, seed=0,
                                   device="cpu").generate_measurements()
    rng = np.random.default_rng(5)
    ests = [_dispersed(truth, rng, M=P) for _ in range(4)]

    od = ScanKalmanOD(prop, stations, types=TYPES, device="cpu")
    gate, thresh, layout, rows, sc_params, y0, p0, walls = od._inputs(ests, arc)
    span = float(layout[0][-1])
    _, aux = od._run(y0, p0, rows, ests[0].epoch, float(layout[0][0]), span, od._k_cap(span),
                     thresh, gate, sc_params, walls)
    args = [aux[k] for k in ("phi", "q_all", "h_all", "z_all", "r_all", "avail")] + [p0]
    for fn, th in ((filter_parallel, 4.0), (filter_scan, math.inf)):
        cpu = fn(*args, th, True)
        card = fn(*(x.cuda() for x in args), th, True)
        assert torch.equal(cpu[5], card[5].cpu())
        assert float((cpu[0] - card[0].cpu())[..., :3].abs().max()) < 1e-9

    out = {}
    for dev in ("cpu", "cuda"):
        par = ScanKalmanOD(prop, stations, types=TYPES, filter_mode="parallel",
                           resid_rejection_sigmas=4.0, device=dev).process_arc(ests[0], arc)
        ens_od = ScanKalmanOD(prop, stations, types=TYPES, device=dev)
        out[dev] = [par] + ens_od.process_arc_batch(ests, arc)
    gaps = [float(np.abs(a.y_est[:, :3] - b.y_est[:, :3]).max())
            for a, b in zip(out["cpu"], out["cuda"])]
    print(f"\ncard vs CPU pipelines, the parallel filter then the members: {gaps} km")
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a.rejected, b.rejected)
    assert max(gaps) < 1e-5
    for algebra in ("f64", "f32"):
        ens_od = ScanKalmanOD(prop, stations, types=TYPES, filter_algebra=algebra, device="cuda")
        member = ens_od.process_arc_batch(ests, arc)[2]
        solo = ens_od.process_arc(ests[2], arc)
        assert float(np.abs(member.y_est[:, :3] - solo.y_est[:, :3]).max()) < 1e-9, algebra


# ---------------------------------------------------------------- measurement
def reference_row_gap(n_rows: int) -> None:
    """The reference's own per-row modes against its batch CKF on
    chip_smoke.py's phase 6b scene (the 22,000 km orbit under 21x21 JGM3
    split, its one-day truth, DSS-65, DSS-34 and DSS-13 every 60 s, seed 0)
    over the arc's first n_rows rows, from the truth with the bench's
    covariance: the batch CKF (stm_jvp_degree 8, f64) and `prop_mode`
    "fixed" (substeps 1) and "adaptive". Prints each per-row mode's largest
    row position gap to the batch CKF over the first n rows for every even
    n, km. Phase 6l (d) holds the port's per-row modes to its batch CKF on
    the card within the tests' 1e-6 km, or 1.1 times this gap where it is
    larger (chip_smoke.SCAN_ROW_KM; 7.554e-9 km for both modes at 8 rows,
    4.484e-8 at 12). Not a test; run it as

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_scan_modes.py 8    # ~6 min
    """
    import time

    stor = RGravityFieldData.from_cof(ROOT / "data/JGM3.cof.gz", 21, 21, True, R.Frames.IAU_EARTH)
    field = RHarmonics.from_stor(stor, precision="split")
    prop = RPropagator.rk89(
        RSpacecraftDynamics(ROrbitalDynamics.from_model(field, R.Frames.EME2000), ()),
        RIntegratorOptions())
    epoch = R.Epoch.from_gregorian_utc(2021, 3, 4)
    truth = R.Spacecraft.from_orbit(
        R.Orbit.keplerian(22_000.0, 0.01, 30.0, 80.0, 40.0, 0.0, epoch, R.Frames.EME2000))
    t0 = time.perf_counter()
    _, traj = prop.with_state(truth).for_duration_with_traj(86_400.0)
    stations = [RGroundStation.dss65_madrid(10.0), RGroundStation.dss34_canberra(10.0),
                RGroundStation.dss13_goldstone(10.0)]
    for gs in stations:
        gs.stochastic_noises = {TYPES[0]: RStochasticNoise(RWhiteNoise(2.0e-3)),
                                TYPES[1]: RStochasticNoise(RWhiteNoise(3.0e-6))}
    cfg = RTrkConfig(sampling_s=60.0, scheduler=RScheduler(min_samples=5))
    arc = RTrackingArcSim.with_seed(stations, traj, {g.name: cfg for g in stations},
                                    seed=0).generate_measurements()
    head = _head(arc, n_rows)
    print(f"truth and arc: {time.perf_counter() - t0:.1f} s, {len(arc)} rows, the first {len(head)} "
          f"over {head.epochs_tai_s[-1] - epoch.to_tai_seconds():.0f} s from the start", flush=True)
    est = RSpacecraftUncertainty(nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
                                 vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()
    sols = {}
    for mode in ("batch", "fixed", "adaptive"):
        t0 = time.perf_counter()
        sols[mode] = RScanKalmanOD(prop, stations, types=TYPES, variant="ckf", stm_jvp_degree=8,
                                   prop_mode=mode).process_arc(est, head)
        print(f"{mode}: {time.perf_counter() - t0:.1f} s", flush=True)
    for mode in ("fixed", "adaptive"):
        gap = np.linalg.norm(np.asarray(sols[mode].y_est)[:, :3]
                             - np.asarray(sols["batch"].y_est)[:, :3], axis=1)
        print(f"{mode} vs batch over {len(head)} rows: largest row position gap {gap.max():.6e} km "
              f"(row {int(gap.argmax())}), final {gap[-1]:.6e} km; over the first n rows: "
              + ", ".join(f"{n} {gap[:n].max():.6e}" for n in range(4, len(head) + 1, 2)))

if __name__ == "__main__":
    import sys

    reference_row_gap(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
