"""Config 1 parity: one spacecraft propagated with events, trajectory queries,
parquet/OEM export, every error control and fixed-step RK4, against nyx_tpu
and against GMAT (examples/01_orbit_prop.py, tests/test_propagators_gmat.py).

Inputs come from numpy seeds and reach both packages unchanged: states and
trajectory nodes as arrays, carried into the port by
`nyx_tpu_torch.interop`. JAX runs on the CPU in float64; the port runs on
CPU tensors.

Tolerances, each stated at its test: 1e-15 relative for the error controls
(the same few float64 operations); 1e-12 relative where both packages
evaluate the same float64 formulas on the same inputs (angles compared
modulo 360, relative to 360); GMAT's own bounds for the integrators
(tests/test_propagators_gmat.py:67); and for whole propagations of ex01's
scene the bounds given at that test, with the gaps measured there printed
(`-s`).
"""

import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_propagators_gmat import MU as GMAT_MU
from test_propagators_gmat import TRUTH, Y0

import nyx_tpu as R
from nyx_tpu.constants import NAIF
from nyx_tpu.cosmic.orbit import cartesian_from_keplerian as rcartesian_from_keplerian
from nyx_tpu.dynamics import Drag as RDrag
from nyx_tpu.dynamics import Harmonics as RHarmonics
from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
from nyx_tpu.dynamics import PointMasses as RPointMasses
from nyx_tpu.dynamics import SolarPressure as RSolarPressure
from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
from nyx_tpu.dynamics import spacecraft_dyn as rspacecraft_dyn
from nyx_tpu.ephem.almanac import Almanac as RAlmanac
from nyx_tpu.io import export as rexport
from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
from nyx_tpu.md import events as revents
from nyx_tpu.md import param as rparam
from nyx_tpu.md.trajectory import Trajectory as RTrajectory
from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
from nyx_tpu.propagators import Propagator as RPropagator
from nyx_tpu.propagators import error_ctrl as rerror_ctrl
from nyx_tpu.propagators.integrator import propagate as rpropagate

import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.dynamics import Drag, Harmonics, OrbitalDynamics, PointMasses, SolarPressure
from nyx_tpu_torch.dynamics import SpacecraftDynamics, spacecraft_dyn
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.errors import ConfigError, EventError, PropagationError, StateError
from nyx_tpu_torch.io import export
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.md import events, param
from nyx_tpu_torch.od import GroundStation, Scheduler, TrackingArcSim, TrkConfig
from nyx_tpu_torch.propagators import ErrorControl, IntegratorMethod, IntegratorOptions, Propagator
from nyx_tpu_torch.propagators import error_ctrl
from nyx_tpu_torch.propagators.integrator import DONE, propagate

JGM3 = Path(__file__).parents[1] / "data/JGM3.cof.gz"
F64 = 1e-12
MU = R.Frames.EME2000.mu
EX01_EPOCH = (2024, 2, 29, 12, 13, 14)
EX01_SECONDS = 3600.0
GMAT_OPTS = IntegratorOptions.with_adaptive_step(0.1, 30.0, 1e-12, ErrorControl.RSSCartesianState)


def _ep(epoch):
    """An epoch of either package as comparable numbers."""
    return (epoch.tai_int, epoch.tai_frac)


def _gap_s(a, b) -> float:
    """|a - b| in seconds for epochs of either package."""
    return abs((a.tai_int - b.tai_int) + (a.tai_frac - b.tai_frac))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close(a, b, angle=False):
    """Max |a - b| over the values, relative to max |b| (to 360 for angles,
    whose difference is taken modulo 360)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if angle:
        return float(np.abs((a - b + 180.0) % 360.0 - 180.0).max() / 360.0)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def two_body_eom(t, y):
    r = y[..., 0:3]
    rmag = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    return torch.cat([y[..., 3:6], -GMAT_MU * r / rmag**3], dim=-1)


# ---------------------------------------------------------------- controls


@pytest.mark.parametrize("name", ["RSSCartesianStep", "RSSCartesianState", "RSSStep", "RSSState",
                                  "LargestError", "LargestState", "LargestStep"])
def test_error_controls_match_reference(name):
    """Each of the seven controls on random [B, 9] inputs whose deltas span
    both sides of every threshold: 1e-15 relative."""
    rng = np.random.default_rng(11)
    B = 256
    cur = rng.normal(size=(B, 9)) * np.array([7e3] * 3 + [7.0] * 3 + [1.0, 1.0, 10.0])
    cur[: B // 8] *= 1e-3  # states below REL_ERR_THRESH as well
    delta = rng.normal(size=(B, 9)) * 10.0 ** rng.uniform(-4.0, 2.0, (B, 1))
    cand = cur + delta
    err = rng.normal(size=(B, 9)) * 10.0 ** rng.uniform(-14.0, -6.0, (B, 1))
    ref = np.asarray(getattr(rerror_ctrl.ErrorControl, name)(*(jnp.asarray(x) for x in (err, cand, cur))))
    port = getattr(ErrorControl, name)(*(_t(x) for x in (err, cand, cur))).numpy()
    assert port.shape == (B,)
    assert np.abs(port - ref).max() <= 1e-15 * np.abs(ref).max(), name
    assert float((np.abs(port - ref) / np.abs(ref)).max()) <= 1e-15, name


# ------------------------------------------------------------ integrators


@pytest.mark.parametrize("name", list(TRUTH))
def test_gmat_truth_through_port(name):
    """A 1-day LEO two-body run at GMAT's Earth GM, RSSCartesianState, lands
    on GMAT's final state within tests/test_propagators_gmat.py:67's bounds."""
    res = propagate(two_body_eom, _t(Y0[None]), 86_400.0, GMAT_OPTS, IntegratorMethod(name))
    assert int(res.status[0]) == DONE
    err = res.y[0].numpy() - np.array(TRUTH[name])
    tol = 1e-5 if name == "CashKarp45" else 1e-7 if name == "Dormand45" else 1e-8
    print(f"{name}: {int(res.n_accepted[0])} steps, position {np.abs(err[:3]).max():.3e} km, "
          f"velocity {np.abs(err[3:]).max():.3e} km/s")
    assert np.abs(err[:3]).max() < tol, f"{name} position {err[:3]}"
    assert np.abs(err[3:]).max() < tol, f"{name} velocity {err[3:]}"


def test_rk4_fixed_day():
    """RK4Fixed at 10 s: exactly 8,640 steps, within 1e-3 km of the RK89
    truth (tests/test_propagators_gmat.py:94-99)."""
    opts = IntegratorOptions.with_fixed_step(10.0)
    res = propagate(two_body_eom, _t(Y0[None]), 86_400.0, opts, IntegratorMethod.RK4Fixed)
    assert int(res.status[0]) == DONE
    assert int(res.n_accepted[0]) == 8640 and int(res.n_rejected[0]) == 0
    err = float(np.linalg.norm(res.y[0, :3].numpy() - np.array(TRUTH["RK89"])[:3]))
    print(f"RK4Fixed: {err:.3e} km from the RK89 truth")
    assert err < 1e-3


def test_forward_backward_symmetry():
    """A day forward and back returns within 1e-5 km and 1e-8 km/s
    (tests/test_propagators_gmat.py:72-78)."""
    fwd = propagate(two_body_eom, _t(Y0[None]), 86_400.0, GMAT_OPTS, IntegratorMethod.RK89)
    back = propagate(two_body_eom, fwd.y, -86_400.0, GMAT_OPTS, IntegratorMethod.RK89)
    assert int(back.status[0]) == DONE
    err = back.y[0].numpy() - Y0
    print(f"forward/backward: {np.linalg.norm(err[:3]):.3e} km, {np.linalg.norm(err[3:]):.3e} km/s")
    assert np.linalg.norm(err[:3]) < 1e-5
    assert np.linalg.norm(err[3:]) < 1e-8


def test_short_duration_against_fixed_step():
    """Durations shorter than the max step are not integrated in one
    force-accepted clamped step: each lands within 1e-5 km of a fixed-step
    1 s RK89 run (tests/test_propagators_gmat.py:250-269)."""
    opts_a = IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9, ErrorControl.RSSCartesianState)
    opts_f = IntegratorOptions.with_fixed_step(1.0)
    for dur in (120.0, 1200.0, 2400.0, 2640.0):
        res_a = propagate(two_body_eom, _t(Y0[None]), dur, opts_a, IntegratorMethod.RK89)
        res_f = propagate(two_body_eom, _t(Y0[None]), dur, opts_f, IntegratorMethod.RK89)
        assert int(res_a.status[0]) == DONE and int(res_f.n_accepted[0]) == int(dur)
        err = float(np.linalg.norm(res_a.y[0, :3].numpy() - res_f.y[0, :3].numpy()))
        print(f"dur={dur}: {err:.3e} km off the fixed-step run")
        assert err < 1e-5, f"dur={dur}: {err * 1e3:.3e} m off fixed-step"


def test_options_and_constructors_match_reference():
    """The options' constructors give the reference's fields; the
    Propagator and SpacecraftDynamics constructors pick the reference's
    method and models; RK4 by name with a fixed step through PropInstance
    matches the reference to 1e-9 km over 600 s."""
    fields = ("init_step_s", "min_step_s", "max_step_s", "tolerance", "attempts", "fixed_step")
    pairs = [
        (IntegratorOptions.with_fixed_step(10.0), RIntegratorOptions.with_fixed_step(10.0)),
        (IntegratorOptions.with_fixed_step_s(P.Duration(5.0)), RIntegratorOptions.with_fixed_step_s(R.Duration(5.0))),
        (IntegratorOptions.with_max_step(30.0), RIntegratorOptions.with_max_step(30.0)),
        (IntegratorOptions.with_tolerance(1e-9), RIntegratorOptions.with_tolerance(1e-9)),
        (IntegratorOptions().set_max_step(20.0), RIntegratorOptions().set_max_step(20.0)),
        (IntegratorOptions.with_adaptive_step_s(1.0, 60.0, 1e-10), RIntegratorOptions.with_adaptive_step_s(1.0, 60.0, 1e-10)),
    ]
    for port, ref in pairs:
        assert all(getattr(port, f) == getattr(ref, f) for f in fields), (port, ref)

    eme = P.Frames.EME2000
    dyn = SpacecraftDynamics.new(OrbitalDynamics.two_body(eme))
    assert dyn.force_models == () and not dyn.has_guidance
    assert SpacecraftDynamics.from_models(OrbitalDynamics.two_body(eme), (Drag.earth_exp(),)).force_models
    assert Propagator.dp78(dyn).method == IntegratorMethod.DormandPrince78
    assert Propagator.default(dyn).method == IntegratorMethod.RK89
    for name, ref_method in (("rk89", "RK89"), ("dp45", "Dormand45"), ("ck45", "CashKarp45"),
                             ("rk4", "RK4Fixed"), ("verner56", "Verner56"), ("DP78", "Dormand78")):
        assert Propagator.from_method(dyn, name).method.name == ref_method
        assert RPropagator.from_method(None, name).method.name == ref_method

    epoch = (2020, 1, 1)
    ref_sc = R.Spacecraft.from_orbit(R.Orbit.keplerian(7000.0, 0.01, 40.0, 10.0, 20.0, 30.0,
                                                       R.Epoch.from_gregorian_utc(*epoch), R.Frames.EME2000))
    sc = P.Spacecraft.from_orbit(P.Orbit.keplerian(7000.0, 0.01, 40.0, 10.0, 20.0, 30.0,
                                                   P.Epoch.from_gregorian_utc(*epoch), eme))
    opts = IntegratorOptions.with_fixed_step(10.0)
    fin = Propagator.from_method(dyn, "rk4", opts).with_(sc, device="cpu").for_duration(600.0)
    ref_fin = RPropagator.from_method(
        RSpacecraftDynamics.new(ROrbitalDynamics.two_body(R.Frames.EME2000)), "rk4",
        RIntegratorOptions.with_fixed_step(10.0)).with_(ref_sc).for_duration(600.0)
    assert np.abs(fin.to_vector() - ref_fin.to_vector()).max() < 1e-9


# ------------------------------------------------------- params, orbits, time


def _random_states(kind: str, n: int, seed: int) -> np.ndarray:
    """[n, 9] states from seeded Keplerian elements (LEO, GEO or
    hyperbolic), with random Cr, Cd and propellant columns. GEO
    inclinations start at 0.05 deg: below that the arccos of the angular
    momentum's z share turns the last-bit differences of torch's CPU sqrt
    (not correctly rounded in its vector path) into more than 1e-12 of
    the equinoctial p and q."""
    rng = np.random.default_rng(seed)
    if kind == "leo":
        sma, ecc, inc = rng.uniform(6800, 7500, n), rng.uniform(1e-3, 0.05, n), rng.uniform(1, 179, n)
        ta = rng.uniform(0, 360, n)
    elif kind == "geo":
        sma, ecc, inc = rng.uniform(42100, 42230, n), rng.uniform(1e-4, 1e-3, n), rng.uniform(0.05, 15, n)
        ta = rng.uniform(0, 360, n)
    else:
        sma, ecc, inc = rng.uniform(-50_000, -10_000, n), rng.uniform(1.1, 3.0, n), rng.uniform(1, 179, n)
        ta = np.degrees(rng.uniform(-0.9, 0.9, n) * np.arccos(-1.0 / ecc))
    raan, aop = rng.uniform(0, 360, n), rng.uniform(0, 360, n)
    r, v = rcartesian_from_keplerian(
        *(jnp.asarray(x) for x in (sma, ecc, np.radians(inc), np.radians(raan), np.radians(aop),
                                   np.radians(ta))), MU)
    extra = np.stack([rng.uniform(1, 2, n), rng.uniform(2, 2.4, n), rng.uniform(0, 50, n)], 1)
    return np.concatenate([np.asarray(r), np.asarray(v), extra], axis=1)


PORTED_PARAMS = [
    "x", "y", "z", "vx", "vy", "vz", "cr", "cd", "prop_mass", "rmag", "vmag", "height", "energy",
    "hmag", "declination", "right_asc", "fpa", "velocity_declination", "hx", "hy", "hz",
    "semi_parameter", "semi_minor_axis", "true_longitude", "equinoctial_h", "equinoctial_k",
    "equinoctial_p", "equinoctial_q", "equinoctial_lambda", "sma", "ecc", "inc", "raan", "aop",
    "ta", "aol", "ea", "ma", "periapsis_radius", "apoapsis_radius", "periapsis_height",
    "apoapsis_height", "c3", "period",
]


@pytest.mark.parametrize("kind", ["leo", "geo", "hyperbolic"])
def test_param_values_match_reference(kind):
    """Every ported StateParameter on 200 random states: 1e-12 relative,
    angles modulo 360. `hyperbolic_anomaly` is held on hyperbolic states,
    where it is defined; Brouwer's mean sma and B.R at 1e-10 of their
    largest value, NaN where undefined (Brouwer on a hyperbola, the B-plane
    on an ellipse; tests/test_torch_mission_design.py holds the rest of
    them); an unknown name raises."""
    y = _random_states(kind, 200, {"leo": 1, "geo": 2, "hyperbolic": 3}[kind])
    names = PORTED_PARAMS + (["hyperbolic_anomaly"] if kind == "hyperbolic" else [])
    worst = {}
    for name in names:
        ref = np.asarray(rparam.value(name, jnp.asarray(y), MU, 6378.1363))
        port = param.value(name, _t(y), MU, 6378.1363).numpy()
        worst[name] = _close(port, ref, angle=name in rparam.StateParameter.ANGLES_DEG)
    print(f"{kind}: worst {max(worst, key=worst.get)} {max(worst.values()):.3e}")
    assert max(worst.values()) <= F64, {k: v for k, v in worst.items() if v > F64}
    for name in ("brouwer_mean_short_sma", "bdot_r"):
        ref = np.asarray(rparam.value(name, jnp.asarray(y), MU, 6378.1363))
        port = param.value(name, _t(y), MU, 6378.1363).numpy()
        assert np.array_equal(np.isnan(port), np.isnan(ref)), name
        ok = ~np.isnan(ref)
        assert not ok.any() or np.abs(port[ok] - ref[ok]).max() <= 1e-10 * np.abs(ref[ok]).max(), name
    with pytest.raises(StateError):
        param.value("no_such_parameter", _t(y), MU)


def test_orbit_and_spacecraft_accessors_match_reference():
    """Orbit's accessors (rmag_km to fpa_deg, ric_difference) on random
    LEO states: 1e-12 relative; str(Orbit) and str(Spacecraft) equal."""
    y = _random_states("leo", 20, 4)
    names = ("rmag_km", "vmag_km_s", "sma_km", "ecc", "inc_deg", "raan_deg", "aop_deg", "ta_deg",
             "ea_deg", "ma_deg", "energy_km2_s2", "period_s", "periapsis_km", "apoapsis_km",
             "periapsis_altitude_km", "apoapsis_altitude_km", "hmag", "c3_km2_s2",
             "declination_deg", "right_ascension_deg", "fpa_deg")
    epoch_r, epoch_p = R.Epoch.from_gregorian_utc(*EX01_EPOCH), P.Epoch.from_gregorian_utc(*EX01_EPOCH)
    for i, row in enumerate(y):
        ro = R.Orbit.cartesian(*row[:6], epoch_r, R.Frames.EME2000)
        po = P.Orbit.cartesian(*row[:6], epoch_p, P.Frames.EME2000)
        for name in names:
            a, b = getattr(po, name), getattr(ro, name)
            assert _close(a, b, angle=name.endswith("_deg")) <= F64, (name, a, b)
        other_r = R.Orbit.cartesian(*y[i - 1, :6], epoch_r, R.Frames.EME2000)
        other_p = P.Orbit.cartesian(*y[i - 1, :6], epoch_p, P.Frames.EME2000)
        dr, dp = ro.ric_difference(other_r), po.ric_difference(other_p)
        assert _close(dp.r_km, dr.r_km) <= F64 and _close(dp.v_km_s, dr.v_km_s) <= F64
        assert str(po) == str(ro)
        rsc = R.Spacecraft.new(ro, 150.0, 15.0, srp_area_m2=3.0, drag_area_m2=3.0, cr=1.8, cd=2.2)
        psc = P.Spacecraft.new(po, 150.0, 15.0, srp_area_m2=3.0, drag_area_m2=3.0, cr=1.8, cd=2.2)
        assert str(psc) == str(rsc)
        assert _close(psc.value_of("aol"), rsc.value_of("aol"), angle=True) <= F64


def test_epoch_iso_strings_match_reference():
    """isoformat in every scale equals the reference's string; from_str of
    the reference's strings (with and without a scale, with T or a space,
    Z) gives the reference's epoch exactly; leap-second neighbours too."""
    rng = np.random.default_rng(5)
    tai = np.concatenate([rng.uniform(-9.5e8, 9.5e8, 300),
                          R.Epoch.from_gregorian_utc(2017, 1, 1).to_tai_seconds() + np.arange(-3, 4) * 0.75])
    for s in tai:
        ep_r, ep_p = R.Epoch.from_tai_seconds_j2000(float(s)), P.Epoch.from_tai_seconds_j2000(float(s))
        for scale in ("UTC", "TAI", "TT", "TDB", "GPS"):
            text = ep_r.isoformat(scale)
            assert ep_p.isoformat(scale) == text
            assert _ep(P.Epoch.from_str(text)) == _ep(R.Epoch.from_str(text))
        assert str(ep_p) == str(ep_r)
        assert ep_p.to_gregorian("TDB") == ep_r.to_gregorian("TDB")
        date = ep_r.isoformat("UTC").split(" ")[0]
        for text in (date, date + "Z", date.replace("T", " ") + " TAI"):
            assert _ep(P.Epoch.from_str(text)) == _ep(R.Epoch.from_str(text))
        # the string keeps microseconds, and seconds since 1970 carry ~2.4e-7 s
        back = P.Epoch.from_str(ep_p.isoformat("TAI"))
        assert abs((back - ep_p).to_seconds()) <= 1e-6
    with pytest.raises(ConfigError):
        P.Epoch.from_str("2024-02-30 noon")


# -------------------------------------------------------------- trajectory


@pytest.fixture(scope="module")
def nodes():
    """Two periods of an 8,000 km, e = 0.1 orbit by the reference's RK89 at
    1e-12 with capture, its propellant falling linearly: (epoch0 TAI s, ts,
    ys) of every accepted step and the start."""
    epoch = R.Epoch.from_gregorian_utc(2020, 1, 1)
    orbit = R.Orbit.keplerian(8000.0, 0.1, 30.0, 10.0, 20.0, 90.0, epoch, R.Frames.EME2000)
    y0 = np.concatenate([orbit.r_km, orbit.v_km_s, [1.8, 2.2, 50.0]])

    def eom(t, y):
        r = y[..., 0:3]
        rmag = jnp.linalg.norm(r, axis=-1, keepdims=True)
        mdot = jnp.full_like(y[..., 8:9], -1e-4)
        return jnp.concatenate([y[..., 3:6], -MU * r / rmag**3, jnp.zeros_like(y[..., 6:8]), mdot], -1)

    res = rpropagate(eom, y0[None], 2.0 * orbit.period_s, RIntegratorOptions(), n_capture=2048)
    n = int(res.traj_len[0])
    ts = np.concatenate([[0.0], np.asarray(res.traj_t[0, :n])])
    ys = np.concatenate([y0[None], np.asarray(res.traj_y[0, :n])])
    return epoch.to_tai_seconds(), ts, ys


def _pair(nodes):
    """The same nodes as a reference Trajectory and a port Trajectory."""
    tai0, ts, ys = nodes
    port = interop.trajectory_from_numpy(tai0, ts, ys, P.Frames.EME2000, dry_mass_kg=100.0)
    template = R.Spacecraft.from_orbit(R.Orbit.cartesian(*ys[0, :6], R.Epoch.from_tai_seconds_j2000(tai0),
                                                         R.Frames.EME2000))
    template = R.Spacecraft.new(template.orbit, 100.0, 0.0, 0.0, 0.0, 1.8, 2.2)
    template = template.set_vector(template.epoch, ys[0, :9])
    return RTrajectory(template.epoch, ts.copy(), ys.copy(), template), port


def _same_states(port_states, ref_states):
    pv = np.stack([s.to_vector() for s in port_states])
    rv = np.stack([s.to_vector() for s in ref_states])
    assert pv.shape == rv.shape
    assert [_ep(s.epoch) for s in port_states] == [_ep(s.epoch) for s in ref_states]
    return _close(pv[:, :3], rv[:, :3]) <= F64 and _close(pv[:, 3:6], rv[:, 3:6]) <= F64 \
        and _close(pv[:, 6:], rv[:, 6:]) <= F64


def test_trajectory_queries_match_reference(nodes):
    """first/last, epochs, str, interpolation, every, every_between,
    sample_values, resample, rebuild and both filters on one set of nodes
    in both packages: 1e-12 relative, node times exactly equal."""
    ref, port = _pair(nodes)
    assert len(port) == len(ref) > 100
    assert _ep(port.start_epoch) == _ep(ref.start_epoch) and _ep(port.end_epoch) == _ep(ref.end_epoch)
    assert str(port) == str(ref)
    assert _same_states([port.first, port.last], [ref.first, ref.last])
    t_rel = np.random.default_rng(6).uniform(ref.ts[0], ref.ts[-1], 40)
    assert _same_states([port.at(port.epoch0 + float(t)) for t in t_rel],
                        [ref.at(ref.epoch0 + float(t)) for t in t_rel])
    assert _same_states(list(port.every(600.0)), list(ref.every(600.0)))
    a, b = port.epoch0 + 1000.0, port.epoch0 + 5000.0
    assert _same_states(list(port.every_between(P.Duration(300.0), a, b)),
                        list(ref.every_between(R.Duration(300.0), ref.epoch0 + 1000.0, ref.epoch0 + 5000.0)))
    for name in ("rmag", "ta", "prop_mass"):
        (tp, vp), (tr, vr) = port.sample_values(name, 120.0), ref.sample_values(name, 120.0)
        assert np.array_equal(tp, tr)
        assert _close(vp, vr, angle=name == "ta") <= F64, name
    rp, rr = port.resample(90.0), ref.resample(90.0)
    assert np.array_equal(rp.ts, rr.ts) and _close(rp.ys, rr.ys) <= F64
    epochs = [float(t) for t in np.sort(np.random.default_rng(7).uniform(ref.ts[0], ref.ts[-1], 25))]
    bp, br = port.rebuild([port.epoch0 + t for t in epochs]), ref.rebuild([ref.epoch0 + t for t in epochs])
    assert np.array_equal(bp.ts, br.ts) and _close(bp.ys, br.ys) <= F64
    fp = port.filter_by_epoch(port.epoch0 + 2000.0, port.epoch0 + 6000.0)
    fr = ref.filter_by_epoch(ref.epoch0 + 2000.0, ref.epoch0 + 6000.0)
    assert np.array_equal(fp.ts, fr.ts) and np.array_equal(fp.ys, fr.ys)
    op, orr = port.filter_by_offset(P.Duration(500.0), 4000.0), ref.filter_by_offset(R.Duration(500.0), 4000.0)
    assert np.array_equal(op.ts, orr.ts) and np.array_equal(op.ys, orr.ys)
    assert np.array_equal(port.filter_by_offset(3000.0).ts, ref.filter_by_offset(3000.0).ts)


def test_find_events_and_minmax_match_reference(nodes):
    """Apoapsis, periapsis, an rmag crossing and an argument-of-latitude
    crossing: the same number of events, each epoch within the event's
    epoch_precision_s of the reference's (the gap printed); find_nth_event;
    find_minmax of rmag and vmag at the same node, value 1e-12 relative."""
    ref, port = _pair(nodes)
    cases = [(events.Event.apoapsis(), revents.Event.apoapsis()),
             (events.Event.periapsis(), revents.Event.periapsis()),
             (events.Event("rmag", 7500.0), revents.Event("rmag", 7500.0)),
             (events.Event("aol", 45.0, epoch_precision_s=0.01), revents.Event("aol", 45.0, epoch_precision_s=0.01))]
    for ev_p, ev_r in cases:
        found_p, found_r = events.find_events(port, ev_p), revents.find_events(ref, ev_r)
        gaps = [_gap_s(a.epoch, b.epoch) for a, b in zip(found_p, found_r)]
        print(f"{ev_p}: {len(found_p)} events, max epoch gap {max(gaps):.3e} s")
        assert len(found_p) == len(found_r) >= 2
        assert max(gaps) <= ev_p.epoch_precision_s
        assert str(ev_p) == str(ev_r)
    nth_p = events.find_nth_event(port, events.Event.apoapsis(), 1)
    nth_r = revents.find_nth_event(ref, revents.Event.apoapsis(), 1)
    assert _gap_s(nth_p.epoch, nth_r.epoch) <= 0.1
    assert events.find_nth_event(port, events.Event.apoapsis(), 5) is None
    for name in ("rmag", "vmag"):
        for kind in ("min", "max"):
            sp, vp, ep = events.find_minmax(port, name, kind)
            sr, vr, er = revents.find_minmax(ref, name, kind)
            assert _ep(ep) == _ep(er) and _close(vp, vr) <= F64 and _same_states([sp], [sr])


def test_exports_match_reference(nodes, tmp_path):
    """to_parquet: the reference's columns, values within 1e-12 relative
    (angles modulo 360), UTC strings equal, for the default fields and for a
    resampled, bounded selection; to_oem: the text equal line for line but
    CREATION_DATE and ORIGINATOR; read_oem gives back the same nodes."""
    import pyarrow.parquet as pq

    ref, port = _pair(nodes)
    cfg_kw = dict(fields=("rmag", "ta", "aol", "hmag", "ecc", "prop_mass"), step=120.0,
                  metadata={"mission": "test"})
    for cfg_p, cfg_r, bounds in ((None, None, None),
                                 (export.ExportCfg(**cfg_kw), rexport.ExportCfg(**cfg_kw), (1000.0, 7000.0))):
        if bounds is not None:
            cfg_p.start_epoch, cfg_p.end_epoch = (port.epoch0 + b for b in bounds)
            cfg_r.start_epoch, cfg_r.end_epoch = (ref.epoch0 + b for b in bounds)
        port.to_parquet(tmp_path / "p.parquet", cfg_p)
        ref.to_parquet(tmp_path / "r.parquet", cfg_r)
        tp, tr = pq.read_table(tmp_path / "p.parquet"), pq.read_table(tmp_path / "r.parquet")
        assert tp.column_names == tr.column_names
        assert set(tp.schema.metadata) == set(tr.schema.metadata)
        assert tp["epoch_utc"].to_pylist() == tr["epoch_utc"].to_pylist()
        for name in tp.column_names[2:] + ["epoch_tai_s"]:
            angle = name in rparam.StateParameter.ANGLES_DEG
            assert _close(tp[name].to_numpy(), tr[name].to_numpy(), angle) <= F64, name
    port.to_oem(tmp_path / "p.oem")
    ref.to_oem(tmp_path / "r.oem")
    lp = (tmp_path / "p.oem").read_text().splitlines()
    lr = (tmp_path / "r.oem").read_text().splitlines()
    skip = ("CREATION_DATE", "ORIGINATOR")
    assert [x for x in lp if not x.startswith(skip)] == [x for x in lr if not x.startswith(skip)]
    assert len(lp) == len(lr) and len(lp) > len(port)
    back_p = export.read_oem(tmp_path / "p.oem", port.template)
    back_r = rexport.read_oem(tmp_path / "r.oem", ref.template)
    assert np.array_equal(back_p.ts, back_r.ts) and np.array_equal(back_p.ys, back_r.ys)
    assert np.abs(back_p.ys[:, :6] - port.ys[:, :6]).max() < 1e-5


# -------------------------------------------------------- propagation stops


def test_until_event_periapsis():
    """The port's counterpart of tests/test_propagators_gmat.py:117-143:
    until_event stops at periapsis (rmag a(1 - e) within 1e-3 km, ta within
    0.05 deg of 0), the second crossing comes one period later (1 s); an
    event the arc does not hold raises EventError."""
    eme2k = P.Frames.EME2000
    epoch = P.Epoch.from_gregorian_utc(2020, 1, 1, 0, 0, 0)
    orbit = P.Orbit.keplerian(8000.0, 0.1, 30.0, 0.0, 0.0, 90.0, epoch, eme2k)
    sc = P.Spacecraft.from_orbit(orbit)
    dyn = SpacecraftDynamics.new(OrbitalDynamics.two_body(eme2k))
    inst = Propagator.rk89(dyn, IntegratorOptions()).with_state(sc, device="cpu")
    period = orbit.period_s

    state, traj = inst.until_event(2.0 * period, events.Event.periapsis())
    assert abs(state.orbit.rmag_km - 8000.0 * 0.9) < 1e-3
    ta = state.orbit.ta_deg
    assert min(ta, 360.0 - ta) < 0.05
    assert inst.state is state and traj.end_epoch == epoch + 2.0 * period

    inst2 = Propagator.rk89(dyn, IntegratorOptions()).with_state(sc, device="cpu")
    state2, _ = inst2.until_nth_event(3.0 * period, events.Event.periapsis(), 1)
    gap = (state2.epoch - state.epoch).to_seconds()
    assert abs(gap - period) < 1.0
    with pytest.raises(EventError):
        Propagator.rk89(dyn).with_state(sc, device="cpu").until_event(0.25 * period, events.Event.periapsis())
    until = Propagator.rk89(dyn).with_state(sc, device="cpu")
    _, traj_e = until.until_epoch_with_traj(epoch + 600.0)
    assert until.until_epoch(epoch + 1200.0).epoch == epoch + 1200.0
    assert traj_e.end_epoch == epoch + 600.0 and until.latest_details()["step"] is None


def test_nan_lane_raises_arithmetic_error():
    """A zero position under two-body turns the state to NaN: both packages
    raise ArithmeticError, and the port's error is a PropagationError."""
    ref_epoch, epoch = R.Epoch.from_gregorian_utc(2020, 1, 1), P.Epoch.from_gregorian_utc(2020, 1, 1)
    ref_sc = R.Spacecraft.from_orbit(R.Orbit.cartesian(0, 0, 0, 7.5, 0, 0, ref_epoch, R.Frames.EME2000))
    sc = P.Spacecraft.from_orbit(P.Orbit.cartesian(0, 0, 0, 7.5, 0, 0, epoch, P.Frames.EME2000))
    ref_dyn = RSpacecraftDynamics.new(ROrbitalDynamics.two_body(R.Frames.EME2000))
    dyn = SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000))
    with pytest.raises(ArithmeticError):
        RPropagator.rk89(ref_dyn).with_state(ref_sc).for_duration(60.0)
    with pytest.raises(ArithmeticError) as caught:
        Propagator.rk89(dyn).with_state(sc, device="cpu").for_duration(60.0)
    assert isinstance(caught.value, PropagationError)


def test_simulator_takes_almanac(nodes):
    """build_schedule and generate_measurements accept `almanac` as the
    reference's do, and give the same arc with it as without it."""
    _, port = _pair(nodes)
    stations = [GroundStation.dss65_madrid(10.0), GroundStation.dss34_canberra(10.0),
                GroundStation.dss13_goldstone(10.0)]
    cfg = {g.name: TrkConfig(sampling_s=60.0, scheduler=Scheduler(min_samples=5)) for g in stations}

    def sim():
        return TrackingArcSim.with_seed(stations, port, cfg, seed=0, device="cpu")

    plain = sim().generate_measurements()
    assert len(plain) > 0
    with_none = sim().generate_measurements(almanac=None)
    s = sim()
    sched = s.build_schedule(almanac=Almanac())
    assert [(x.device, x.start_idx, x.end_idx) for x in sched] == \
        [(x.device, x.start_idx, x.end_idx) for x in sim().build_schedule()]
    with_alm = s.generate_measurements(almanac=Almanac())
    for arc in (with_none, with_alm):
        assert arc.trackers == plain.trackers
        assert np.array_equal(arc.epochs_tai_s, plain.epochs_tai_s)
        assert np.array_equal(arc.values, plain.values, equal_nan=True)


# ------------------------------------------------------------- the slice


def _ex01(M, D, Alm, G, srp=None, **with_state):
    """examples/01_orbit_prop.py:50-81 in package M: (instance, epoch);
    `srp` replaces the example's SRP model."""
    epoch = M.Epoch.from_gregorian_utc(*EX01_EPOCH)
    orbit = M.Orbit.keplerian(7136.6, 2e-4, 98.7, 30.0, 65.0, 80.0, epoch, M.Frames.EME2000)
    sc = M.Spacecraft.new(orbit, 150.0, 15.0, srp_area_m2=3.0, drag_area_m2=3.0, cr=1.8, cd=2.2)
    stor = G.from_cof(JGM3, 21, 21, True, M.Frames.IAU_EARTH)
    dynamics = D["SpacecraftDynamics"](
        D["OrbitalDynamics"].from_models(
            [D["Harmonics"].from_stor(stor), D["PointMasses"]((NAIF.SUN, NAIF.MOON))], M.Frames.EME2000),
        (srp or D["SolarPressure"].default(), D["Drag"].earth_exp()),
    )
    return M.Propagator.rk89(dynamics, M.IntegratorOptions()).with_state(sc, Alm(), **with_state), epoch


R_EX01 = (R, dict(SpacecraftDynamics=RSpacecraftDynamics, OrbitalDynamics=ROrbitalDynamics, Harmonics=RHarmonics,
                  PointMasses=RPointMasses, SolarPressure=RSolarPressure, Drag=RDrag), RAlmanac, RGravityFieldData)
P_EX01 = (P, dict(SpacecraftDynamics=SpacecraftDynamics, OrbitalDynamics=OrbitalDynamics, Harmonics=Harmonics,
                  PointMasses=PointMasses, SolarPressure=SolarPressure, Drag=Drag), Almanac, GravityFieldData)


def test_ex01_slice_matches_reference(tmp_path):
    """ex01's scene (21x21 JGM3 at f64, Sun and Moon, SRP, drag, RK89 at
    1e-12) over its first 3,600 s in both packages, then apoapsis events and
    both exports through the port. Final position within 1e-6 km; one
    apoapsis in each, epochs within 0.1 s, rmag within 1e-6 km.

    Node counts are held within 25 %, not a few nodes: both packages
    evaluate SRP and drag in float32, and at the Earth shadow's entry
    (~1,330 s) the float32 shadow fraction's rounding drives RK89 at 1e-12
    to ~170 steps of a fraction of a second, whose sizes follow the last
    bits of that rounding, which XLA's fused code and eager torch do
    differently (the port takes 251 nodes here, the reference 212) while
    the final state and the event agree. The next test is the witness:
    without that float32 shadow the counts agree within 2."""
    ref_inst, ref_epoch = _ex01(*R_EX01)
    inst, epoch = _ex01(*P_EX01, device="cpu")
    ref_final, ref_traj = ref_inst.for_duration_with_traj(EX01_SECONDS, n_capture=32768)
    final, traj = inst.for_duration_with_traj(EX01_SECONDS, n_capture=32768)
    d_km = float(np.linalg.norm(final.orbit.r_km - ref_final.orbit.r_km))
    ap = events.find_events(traj, events.Event.apoapsis(), max_events=20)
    ap_r = revents.find_events(ref_traj, revents.Event.apoapsis(), max_events=20)
    assert len(ap) == len(ap_r) == 1
    gap = _gap_s(ap[0].epoch, ap_r[0].epoch)
    d_rmag = abs(ap[0].state.orbit.rmag_km - ap_r[0].state.orbit.rmag_km)
    print(f"ex01 {EX01_SECONDS} s: final position {d_km:.3e} km apart, nodes {len(traj)} (port) vs "
          f"{len(ref_traj)}; apoapsis {(ap[0].epoch - epoch).to_seconds():.4f} s after the start, "
          f"{gap:.3e} s and {d_rmag:.3e} km apart")
    assert final.epoch == epoch + EX01_SECONDS
    assert d_km < 1e-6
    assert abs(len(traj) - len(ref_traj)) <= 0.25 * len(ref_traj)
    assert gap < 0.1 and d_rmag < 1e-6

    import pyarrow.parquet as pq

    traj.to_parquet(tmp_path / "ex01_traj.parquet")
    traj.to_oem(tmp_path / "ex01_traj.oem")
    table = pq.read_table(tmp_path / "ex01_traj.parquet")
    assert table.equals(export.traj_table(traj, export.ExportCfg()))
    assert table.num_rows == len(traj)
    back = export.read_oem(tmp_path / "ex01_traj.oem", traj.template)
    assert len(back) == len(traj) and np.abs(back.ys[:, :6] - traj.ys[:, :6]).max() < 1e-5


class _F64(types.ModuleType):
    """A stand-in for a module whose `float32` is its `float64`."""

    def __init__(self, module):
        super().__init__(module.__name__)
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, "float64" if name == "float32" else name)


@pytest.mark.parametrize("scene", ["srp_without_shadow", "forces_at_f64"])
def test_ex01_node_counts_match_without_f32_shadow(scene, monkeypatch):
    """The witness for the node envelope above: ex01's first 3,600 s in both
    packages without the float32 shadow fraction, either with SRP's shadow
    removed (`shadow_bodies=()`) or with SRP and drag evaluated at float64
    in both packages (each EOM module's float32 read as float64). Node
    counts within 2, final positions within 1e-6 km."""
    if scene == "srp_without_shadow":
        ref_srp, srp = RSolarPressure(shadow_bodies=()), SolarPressure(shadow_bodies=())
    else:
        ref_srp = srp = None
        monkeypatch.setattr(rspacecraft_dyn, "jnp", _F64(jnp))
        monkeypatch.setattr(spacecraft_dyn, "torch", _F64(torch))
    ref_inst, _ = _ex01(*R_EX01, srp=ref_srp)
    inst, _ = _ex01(*P_EX01, srp=srp, device="cpu")
    ref_final, ref_traj = ref_inst.for_duration_with_traj(EX01_SECONDS, n_capture=32768)
    final, traj = inst.for_duration_with_traj(EX01_SECONDS, n_capture=32768)
    d_km = float(np.linalg.norm(final.orbit.r_km - ref_final.orbit.r_km))
    print(f"ex01 {scene} {EX01_SECONDS} s: nodes {len(traj)} (port) vs {len(ref_traj)}; final position "
          f"{d_km:.3e} km apart")
    assert abs(len(traj) - len(ref_traj)) <= 2
    assert d_km < 1e-6
