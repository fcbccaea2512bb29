"""OD-slice parity: the PyTorch port's orbit determination against nyx_tpu.

Module by module along the bench's OD leg (the gravity tangent, the STM
EOM, trajectory capture and interpolation, the tracking simulator, the
staged CKF), then the whole slice through the port alone. Inputs come from
numpy seeds and the repo's JGM3; JAX runs on the CPU in float64 with
`backend="auto"`, which there is its XLA recursion. The reference's arc,
estimate and trajectory reach the port through `nyx_tpu_torch.interop`.
The JAX `ScanKalmanOD` builds are module-scoped: each compiles once.

The scene is an 8x8 JGM3 split-precision LEO (sma 7500 km, i 60 deg)
tracked by DSS-65 and DSS-13 every 30 s over 4 h (88 range and Doppler
rows), RK89 adaptive at 1e-10 (at the default 1e-12 the float32 part of
a split field sets the step, and the reference's stage-1 capture
saturates on this arc).
"""

import subprocess
import sys
from pathlib import Path

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
from nyx_tpu.md.trajectory import Trajectory as RTrajectory
from nyx_tpu.od import GroundStation as RGroundStation
from nyx_tpu.od import ProcessNoise as RProcessNoise
from nyx_tpu.od import SpacecraftUncertainty as RSpacecraftUncertainty
from nyx_tpu.od import TrackingArcSim as RTrackingArcSim
from nyx_tpu.od import TrkConfig as RTrkConfig
from nyx_tpu.od.noise import StochasticNoise as RStochasticNoise
from nyx_tpu.od.noise import WhiteNoise as RWhiteNoise
from nyx_tpu.od.scan_filter import ScanKalmanOD as RScanKalmanOD
from nyx_tpu.od.simulator import Scheduler as RScheduler
from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
from nyx_tpu.propagators import Propagator as RPropagator
from nyx_tpu.propagators import integrator as r_integrator

import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.dynamics import Harmonics, OrbitalDynamics, SpacecraftDynamics
from nyx_tpu_torch.dynamics import gravity_pines
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
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator, integrator

ROOT = Path(__file__).parents[1]
JGM3 = ROOT / "data/JGM3.cof.gz"
ARC_S = 4 * 3600.0
TYPES = (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S)
# The reference's f32 bound between two f32 evaluations of the recursion
# (tests/test_dynamics.py:399), per-lane relative norm.
F32_REL = 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _field(M, precision, degree=8):
    stor = (RGravityFieldData if M is R else GravityFieldData).from_cof(
        JGM3, degree, degree, True, M.Frames.IAU_EARTH)
    return (RHarmonics if M is R else Harmonics).from_stor(stor, precision=precision)


def _dynamics(M, precision="split"):
    od, sd = ((ROrbitalDynamics, RSpacecraftDynamics) if M is R
              else (OrbitalDynamics, SpacecraftDynamics))
    return sd(od.from_model(_field(M, precision), M.Frames.EME2000), ())


def _propagator(M, precision="split"):
    opts = (RIntegratorOptions if M is R else IntegratorOptions).with_adaptive_step(
        1.0, 2700.0, 1e-10)
    return (RPropagator if M is R else Propagator).rk89(_dynamics(M, precision), opts)


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
    return out


def _trk(M):
    return (RTrkConfig if M is R else TrkConfig)(
        sampling_s=30.0, scheduler=(RScheduler if M is R else Scheduler)(min_samples=5))


def _estimate(M, truth):
    return (RSpacecraftUncertainty if M is R else SpacecraftUncertainty)(
        nominal=truth, frame="ric", x_km=0.15, y_km=0.15, z_km=0.15,
        vx_km_s=5e-6, vy_km_s=5e-6, vz_km_s=5e-6).to_estimate()


# The filter cases of (e): keyword arguments for both packages.
FILTER_CASES = {
    "f64": dict(filter_algebra="f64"),
    "f64-snc-gate": dict(filter_algebra="f64", resid_rejection_sigmas=3.0, process_noise="snc"),
    "f32-snc-gate": dict(filter_algebra="f32", resid_rejection_sigmas=3.0, process_noise="snc"),
}


def _filter_kw(M, case):
    kw = dict(FILTER_CASES[case])
    if kw.get("process_noise") == "snc":
        pn = RProcessNoise if M is R else ProcessNoise
        kw["process_noise"] = (pn.from_diag([1e-16] * 3, 3600.0),)
    return kw


def _port_solution(case, port_inputs):
    od = ScanKalmanOD(_propagator(P), _stations(P), types=TYPES, variant="ckf",
                      stm_jvp_degree=4, device="cpu", **_filter_kw(P, case))
    return od.process_arc(port_inputs["est"], port_inputs["arc"])


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


@pytest.fixture(scope="module")
def ref_scene():
    """The reference's truth trajectory, stations, arc and estimate."""
    truth = _truth(R)
    _, traj = _propagator(R).with_state(truth).for_duration_with_traj(ARC_S)
    stations = _stations(R)
    sim = RTrackingArcSim.with_seed(stations, traj, {g.name: _trk(R) for g in stations}, seed=0)
    return dict(truth=truth, traj=traj, stations=stations, arc=sim.generate_measurements(),
                est=_estimate(R, truth))


@pytest.fixture(scope="module")
def port_inputs(ref_scene):
    """The reference's arc, estimate and trajectory carried into the port."""
    arc, est, traj = ref_scene["arc"], ref_scene["est"], ref_scene["traj"]
    return dict(
        arc=interop.tracking_arc_from_numpy(arc.trackers, arc.types, arc.epochs_tai_s,
                                            arc.tracker_idx, arc.values),
        est=interop.kf_estimate_from_numpy(est.nominal.to_vector(), est.covar,
                                           est.epoch.to_tai_seconds()),
        traj=interop.trajectory_from_numpy(traj.epoch0.to_tai_seconds(), traj.ts, traj.ys),
    )


@pytest.fixture(scope="module")
def ref_solutions(ref_scene):
    """The reference's ScanKalmanOD solutions of every filter case."""
    out = {}
    for case in FILTER_CASES:
        od = RScanKalmanOD(_propagator(R), ref_scene["stations"], types=TYPES, variant="ckf",
                           stm_jvp_degree=4, **_filter_kw(R, case))
        out[case] = od.process_arc(ref_scene["est"], ref_scene["arc"])
    return out


@pytest.mark.parametrize("jvp_degree", [None, 4])
def test_gravity_tangent_matches_jax_jvp(jvp_degree):
    """(a) torch.func.jvp of Harmonics.accel_body_fixed (the PinesAccel
    Function: twin primal on the CPU, twin tangent) against jax.jvp of the
    reference's, on 8x8 JGM3 split at f32, with the derivative through the
    whole field or through degree 4 only. Measured: 7.1e-7 (values),
    7.2e-7 and 4.5e-7 (tangents)."""
    ref, port = _field(R, "split"), _field(P, "split")
    if jvp_degree is not None:
        ref, port = ref.with_jvp_degree(jvp_degree), port.with_jvp_degree(jvp_degree)
    rng = np.random.default_rng(31)
    r = rng.normal(size=(16, 3))
    r = r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(6700.0, 42000.0, (16, 1))
    dr = rng.normal(size=(16, 3))
    a_ref, da_ref = jax.jvp(ref.accel_body_fixed, (jnp.asarray(r, jnp.float32),),
                            (jnp.asarray(dr, jnp.float32),))
    calls = gravity_pines.pines_tangent_torch.cuda_calls
    a, da = torch.func.jvp(port.accel_body_fixed, (torch.tensor(r, dtype=torch.float32),),
                           (torch.tensor(dr, dtype=torch.float32),))
    assert a.dtype == da.dtype == torch.float32
    assert gravity_pines.pines_tangent_torch.cuda_calls == calls  # CPU tensors
    print(f"jvp_degree {jvp_degree}: value {_rel(a.numpy(), a_ref):.2e}, "
          f"tangent {_rel(da.numpy(), da_ref):.2e}")
    assert _rel(a.numpy(), a_ref) < F32_REL
    assert _rel(da.numpy(), da_ref) < F32_REL
    if jvp_degree is not None:  # the cut tangent is not the whole field's
        _, da_full = torch.func.jvp(_field(P, "split").accel_body_fixed,
                                    (torch.tensor(r, dtype=torch.float32),),
                                    (torch.tensor(dr, dtype=torch.float32),))
        assert _rel(da.numpy(), da_full.numpy()) > 1e-4


@pytest.mark.parametrize("jvp_degree", [None, 4])
def test_stm_eom_matches_reference(jvp_degree):
    """(b) make_eom(with_stm=True) on [8, 90] states (LEO to GEO, a
    perturbed STM) against the reference's EOM, per lane 1e-6 relative
    (measured 1.7e-12 on the acceleration and 3.9e-15 on Phi')."""
    ref_dyn, dyn = _dynamics(R), _dynamics(P)
    if jvp_degree is not None:
        ref_dyn = RScanKalmanOD(_propagator(R), _stations(R), stm_jvp_degree=jvp_degree)._stm_dynamics(ref_dyn)
        dyn = ScanKalmanOD(_propagator(P), _stations(P), stm_jvp_degree=jvp_degree,
                           device="cpu")._stm_dynamics(dyn)
    epoch = R.Epoch.from_gregorian_utc(2021, 3, 4)
    ctx_ref = ref_dyn.build_context(epoch, 3600.0, None)
    ctx = dyn.build_context(P.Epoch(epoch.tai_int, epoch.tai_frac), 3600.0, None, device="cpu")
    rng = np.random.default_rng(5)
    y = np.zeros((8, 90))
    rmag = np.linspace(6800.0, 42164.0, 8)
    u = rng.normal(size=(8, 3))
    y[:, 0:3] = u / np.linalg.norm(u, axis=1, keepdims=True) * rmag[:, None]
    y[:, 3:6] = rng.normal(size=(8, 3)) * np.sqrt(398600.0 / rmag)[:, None] / np.sqrt(3)
    y[:, 6:9] = [1.8, 2.2, 10.0]
    y[:, 9:] = (np.eye(9) + 0.01 * rng.normal(size=(8, 9, 9))).reshape(8, 81)
    t = np.linspace(0.0, 3600.0, 8)
    p = dict(dry_mass_kg=100.0, srp_area_m2=0.0, drag_area_m2=0.0)
    d_ref = np.asarray(ref_dyn.make_eom(with_stm=True)(jnp.asarray(t), jnp.asarray(y), ctx_ref, p))
    d = dyn.make_eom(with_stm=True)(torch.tensor(t), torch.tensor(y), ctx, p).numpy()
    np.testing.assert_array_equal(d[:, 0:3], d_ref[:, 0:3])
    phi_dot, phi_dot_ref = d[:, 9:].reshape(8, 9, 9), d_ref[:, 9:].reshape(8, 9, 9)
    # column by column: each is A times a column of Phi
    gaps = [_rel(phi_dot[:, :, j], phi_dot_ref[:, :, j]) for j in range(9)]
    print(f"jvp_degree {jvp_degree}: acceleration {_rel(d[:, 3:6], d_ref[:, 3:6]):.2e}, "
          f"Phi' {max(gaps):.2e}")
    assert _rel(d[:, 3:6], d_ref[:, 3:6]) < 1e-6
    assert max(gaps) < 1e-6, gaps


def _agree_with_reference_traj(ts, ys, traj_ref):
    """Nodes (ts [K], ys [K, 9]) of one run against the reference's
    trajectory interpolated at the same times: node times of the two runs
    differ by ~1e-7 relative (the step controller's error estimate cancels
    about ten digits, so last-bit differences in the forces move the step
    sizes), but both lie on one solution, within 1e-9 km (measured 1.3e-11
    and 5.5e-12 for the two lanes of the capture test, 3.8e-11 for
    for_duration_with_traj)."""
    gap = max(np.abs(y - traj_ref.interpolate(t)[:9]).max() for t, y in zip(ts, ys))
    print(f"nodes on the reference's trajectory within {gap:.2e}")
    assert gap < 1e-9, gap


def test_capture_matches_reference():
    """(c) The capture buffer of propagate against the reference's, on
    8x8 f64 gravity over 2 h with two lanes (2 h and 5000 s): the same
    node counts, node times within 1e-6 relative and states on the
    reference's solution (see _agree_with_reference_traj). A stride of 2
    and a saturated buffer (its last slot holding the last step) keep
    exactly the port's own dense nodes that the reference's rule keeps."""
    ref_dyn, dyn = _dynamics(R, "f64"), _dynamics(P, "f64")
    truth = _truth(R)
    y0 = np.stack([truth.to_vector(), truth.to_vector() + [50.0, 0, 0, 0, 0.01, 0, 0, 0, 0]])
    dur = np.array([7200.0, 5000.0])
    epoch = truth.epoch
    ctx_ref = ref_dyn.build_context(epoch, 7200.0, None)
    ctx = dyn.build_context(P.Epoch(epoch.tai_int, epoch.tai_frac), 7200.0, None, device="cpu")
    p = dict(dry_mass_kg=0.0, srp_area_m2=0.0, drag_area_m2=0.0)
    ref_opts = RIntegratorOptions.with_adaptive_step(1.0, 2700.0, 1e-10)
    opts = IntegratorOptions.with_adaptive_step(1.0, 2700.0, 1e-10)

    def run(n_capture, stride):
        res_ref = r_integrator.propagate(
            ref_dyn.make_eom(), jnp.asarray(y0), jnp.asarray(dur), ref_opts,
            n_capture=n_capture, capture_stride=stride, finally_fn=ref_dyn.make_finally(),
            eom_args=(ctx_ref, p))
        res = integrator.propagate(
            dyn.make_eom(), torch.tensor(y0), torch.tensor(dur), opts,
            n_capture=n_capture, capture_stride=stride, finally_fn=dyn.make_finally(),
            eom_args=(ctx, p))
        assert res.traj_t.shape == (2, n_capture) and res.traj_y.shape == (2, n_capture, 9)
        np.testing.assert_array_equal(res.traj_len.numpy(), np.asarray(res_ref.traj_len))
        return res, res_ref

    full, full_ref = run(256, 1)
    n_full = full.traj_len.numpy()
    for lane in range(2):
        k = n_full[lane]
        np.testing.assert_allclose(full.traj_t[lane, :k].numpy(),
                                   np.asarray(full_ref.traj_t)[lane, :k], rtol=1e-6)
        traj_ref = RTrajectory.from_capture(
            epoch, np.concatenate([[0.0], np.asarray(full_ref.traj_t)[lane, :k]]),
            np.concatenate([y0[lane:lane + 1], np.asarray(full_ref.traj_y)[lane, :k]]), truth)
        _agree_with_reference_traj(full.traj_t[lane, :k].numpy(), full.traj_y[lane, :k].numpy(),
                                   traj_ref)
    for n_capture, stride in ((64, 2), (16, 1)):
        res, _ = run(n_capture, stride)
        for lane in range(2):
            kept = [i for i in range(n_full[lane]) if i % stride == 0 or i == n_full[lane] - 1]
            if len(kept) > n_capture:
                kept = kept[: n_capture - 1] + kept[-1:]
            k = len(kept)
            assert res.traj_len[lane] == min(k, n_capture)
            np.testing.assert_array_equal(res.traj_t[lane, :k].numpy(), full.traj_t[lane, kept].numpy())
            np.testing.assert_array_equal(res.traj_y[lane, :k].numpy(), full.traj_y[lane, kept].numpy())
    assert (res.traj_len == 16).all()  # the small buffer saturated


def test_for_duration_with_traj_matches_reference():
    """(c) Propagator.with_state(...).for_duration_with_traj against the
    reference's: the same node count, node times within 1e-6 relative, and
    nodes on the reference's trajectory within 1e-9 km."""
    ref_opts = RIntegratorOptions.with_adaptive_step(1.0, 2700.0, 1e-10)
    opts = IntegratorOptions.with_adaptive_step(1.0, 2700.0, 1e-10)
    end_ref, traj_ref = RPropagator.rk89(_dynamics(R, "f64"), ref_opts).with_state(
        _truth(R)).for_duration_with_traj(7200.0)
    end, traj = Propagator.rk89(_dynamics(P, "f64"), opts).with_state(
        _truth(P), device="cpu").for_duration_with_traj(7200.0)
    assert len(traj) == len(traj_ref) > 10
    np.testing.assert_allclose(traj.ts, traj_ref.ts, rtol=1e-6)
    _agree_with_reference_traj(traj.ts, traj.ys, traj_ref)
    assert end.epoch == P.Epoch(end_ref.epoch.tai_int, end_ref.epoch.tai_frac)
    np.testing.assert_allclose(end.to_vector(), end_ref.to_vector(), rtol=0, atol=1e-9)


def test_trajectory_interpolate_matches_reference(ref_scene, port_inputs):
    """(c) Trajectory.interpolate and .at on identical nodes (the
    reference's truth, carried over), 1e-12 relative: the same host
    numpy arithmetic."""
    traj_ref, traj = ref_scene["traj"], port_inputs["traj"]
    t = np.random.default_rng(2).uniform(traj.ts[0], traj.ts[-1], 32)
    for ti in np.concatenate([t, traj.ts[[0, 1, -1]]]):
        np.testing.assert_allclose(traj.interpolate(ti), traj_ref.interpolate(ti), rtol=1e-12)
    e = P.Epoch.from_tai_seconds_j2000(traj.epoch0.to_tai_seconds() + 1234.5)
    ref_at = traj_ref.at(R.Epoch.from_tai_seconds_j2000(e.to_tai_seconds()))
    np.testing.assert_allclose(traj.at(e).to_vector(), ref_at.to_vector(), rtol=1e-12)


def test_simulator_matches_reference(ref_scene, port_inputs):
    """(d) TrackingArcSim fed the reference's truth through interop: the
    same epochs, trackers and types, and values within 1e-9 of each
    column's scale (the same seeded noise on the same schedule). Relative
    to the column, not to each value: the reference computes the geometry
    under jit, whose vectorized CPU trig is a few ulp off its own eager
    evaluation (which the port matches), and a Doppler value near zero
    would turn that into an unbounded per-value ratio. Measured: 9.3e-12 (range), 2.0e-11
    (Doppler)."""
    stations = _stations(P)
    sim = TrackingArcSim.with_seed(stations, port_inputs["traj"],
                                   {g.name: _trk(P) for g in stations}, seed=0, device="cpu")
    arc, arc_ref = sim.generate_measurements(), ref_scene["arc"]
    assert len(arc) == len(arc_ref) > 50
    assert arc.trackers == arc_ref.trackers and arc.types == arc_ref.types
    np.testing.assert_array_equal(arc.epochs_tai_s, arc_ref.epochs_tai_s)
    np.testing.assert_array_equal(arc.tracker_idx, arc_ref.tracker_idx)
    gaps = np.abs(arc.values - arc_ref.values).max(axis=0) / np.abs(arc_ref.values).max(axis=0)
    print(f"values, relative to each column's scale: {gaps}")
    assert (gaps < 1e-9).all(), gaps


@pytest.mark.parametrize("case", ["f64", "f64-snc-gate"])
def test_scan_filter_matches_reference(case, ref_solutions, port_inputs):
    """(e) ScanKalmanOD.process_arc on the reference's arc and estimate,
    stm_jvp_degree 4, f64 algebra, without and with SNC and a 3-sigma gate:
    every row's estimate within 1e-4 km, covariance diagonals within 1e-6
    relative, identical rejections, and prefit and postfit within 1e-5 (km
    and km/s), loosened from 1e-6: the two nominals differ by the float32
    rounding of the split field (twin against the XLA recursion, up to
    2e-5 of the float32 part), a few mm after 4 h, and the fits follow.
    Measured: estimates 2.7e-6 and 5.3e-6 km, diagonals 3.0e-9 and 5.1e-9,
    fits 3.7e-7 and 1.6e-6."""
    sol, sol_ref = _port_solution(case, port_inputs), ref_solutions[case]
    assert sol.y_est.shape == sol_ref.y_est.shape
    np.testing.assert_array_equal(sol.epochs_tai_s, sol_ref.epochs_tai_s)
    d_est, d_cov, d_fit = _gaps(sol, sol_ref)
    print(f"{case}: estimate {d_est:.3e} km, covariance diagonal {d_cov:.3e}, fits {d_fit:.3e}")
    assert d_est < 1e-4, d_est
    assert d_cov < 1e-6, d_cov
    assert d_fit < 1e-5, d_fit
    np.testing.assert_array_equal(sol.rejected, sol_ref.rejected)


def test_scan_filter_f32_algebra_matches_reference(ref_solutions, port_inputs):
    """(e) The f32 CKF with SNC and a 3-sigma gate. The port's f32 algebra
    carries a square-root factor of P (see scan_filter.filter_scan_f32),
    the reference's a float32 Joseph chain, which is itself 7.4e-4 off its
    f64 run in the covariance diagonals on this arc. So the port's run is
    held to the reference's f64 run (the same filter in exact arithmetic):
    identical rejections, every row's estimate within 1e-4 km, prefit and
    postfit within 1e-5 (as in the f64 cases), covariance diagonals within
    1e-4 relative, loosened from 1e-6 for the float32 rounding of the
    factor; and to the reference's f32 run: identical rejections,
    estimates within 1e-4 km, diagonals within 5e-3 (the reference's own
    float32 error). Both meet TestF32FilterAlgebra's bounds
    (tests/test_od.py:1782-1792). Measured: to the f64 run 5.2e-6 km,
    1.5e-5, 1.6e-6 (fits); to the f32 run 1.3e-5 km and 7.3e-4."""
    sol = _port_solution("f32-snc-gate", port_inputs)
    ref32, ref64 = ref_solutions["f32-snc-gate"], ref_solutions["f64-snc-gate"]
    d_est, d_cov, d_fit = _gaps(sol, ref64)
    d_est32, d_cov32, _ = _gaps(sol, ref32)
    print(f"f32 against the reference's f64: estimate {d_est:.3e} km, covariance diagonal "
          f"{d_cov:.3e}, fits {d_fit:.3e}; against its f32: estimate {d_est32:.3e} km, "
          f"covariance diagonal {d_cov32:.3e}")
    np.testing.assert_array_equal(sol.rejected, ref64.rejected)
    np.testing.assert_array_equal(sol.rejected, ref32.rejected)
    assert d_est < 1e-4 and d_cov < 1e-4 and d_fit < 1e-5, (d_est, d_cov, d_fit)
    assert d_est32 < 1e-4 and d_cov32 < 5e-3, (d_est32, d_cov32)


def test_od_slice_recovers_truth_on_cpu():
    """(f) The whole slice through the port alone, on the CPU: truth with
    capture, simulated tracking, the f64 CKF, the final estimate within
    10 m of the truth and inside its 3-sigma position bound."""
    truth = _truth(P)
    prop = _propagator(P)
    _, traj = prop.with_state(truth, device="cpu").for_duration_with_traj(ARC_S)
    stations = _stations(P)
    sim = TrackingArcSim.with_seed(stations, traj, {g.name: _trk(P) for g in stations}, seed=3,
                                   device="cpu")
    arc = sim.generate_measurements()
    od = ScanKalmanOD(prop, stations, types=TYPES, stm_jvp_degree=4, device="cpu")
    sol = od.process_arc(_estimate(P, truth), arc)
    assert set(od.stage_walls_s) == {"s1", "s2", "s3", "s4", "segments", "s1_iterations"}
    assert od.stage_walls_s["segments"] == 1 and od.stage_walls_s["s1_iterations"] % 16 == 0
    assert np.isfinite(sol.y_est).all() and sol.y_est.shape == (len(arc), 9)
    final = traj.at(P.Epoch.from_tai_seconds_j2000(sol.epochs_tai_s[-1])).to_vector()
    err = np.linalg.norm(sol.final_state()[:3] - final[:3])
    assert err < 0.01, err
    assert err < 3 * np.sqrt(np.trace(sol.final_covar()[:3, :3]))


def test_capture_saturation_grows_and_reruns():
    """A saturated stage-1 capture buffer doubles and stage 1 reruns, as
    the reference's process_arc does, instead of interpolating a cut
    nominal: at tolerance 1e-11 this 2-hour arc's nominal needs more than
    the first buffer's 162 nodes. The grown run agrees with a 1e-10 run,
    whose buffer suffices, within 1e-3 km at every row (a cut buffer would
    put km-level garbage in the interpolated nominal)."""
    truth = _truth(P)
    _, traj = _propagator(P).with_state(truth, device="cpu").for_duration_with_traj(7200.0)
    stations = _stations(P)
    arc = TrackingArcSim.with_seed(stations, traj, {g.name: _trk(P) for g in stations}, seed=3,
                                   device="cpu").generate_measurements()
    sols = {}
    for tol in (1e-10, 1e-11):
        prop = Propagator.rk89(_dynamics(P), IntegratorOptions.with_adaptive_step(1.0, 2700.0, tol))
        od = ScanKalmanOD(prop, stations, types=TYPES, stm_jvp_degree=4, device="cpu")
        sols[tol] = od.process_arc(_estimate(P, truth), arc)
        grown = od._kcap_grow
    assert grown == 2 and od._last_k_cap == 324
    d = np.linalg.norm(sols[1e-11].y_est[:, :3] - sols[1e-10].y_est[:, :3], axis=1).max()
    assert d < 1e-3, d


def test_port_modules_never_import_jax():
    """Every module of the port, imported one by one in a fresh process,
    pulls in neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, nyx_tpu_torch\n"
        "for m in pkgutil.walk_packages(nyx_tpu_torch.__path__, 'nyx_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nyx_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
