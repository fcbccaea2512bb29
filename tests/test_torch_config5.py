"""Config 5 parity: lunar orbit determination (examples/04_lro_od.py) through
the port against nyx_tpu, and the frames and transforms it needs.

The slice: the IAU Moon, Mars and Sun orientation models and the frames
about the Moon, Mars, the Sun, the Earth-Moon and solar-system barycentres;
`Orbit.keplerian_apsis_radii`; a lunar field carried across by
`interop.harmonics_from_tables`; `EphemTable.posvel`, `Almanac.state` and
`translate_to`; `IntegratorOptions.integration_frame`; `Trajectory.to_frame`,
`groundtrack`, `ric_diff` and `ric_diff_to_parquet`; and ex04's scene at a
small size (degree 12, 2 h): the truth, the six polar stations' two-way
arc and the segmented EKF with SNC and the 3-sigma gate.

Inputs come from numpy seeds and reach both packages unchanged: epochs and
positions as arrays, the reference's truth, arc and estimate through
`nyx_tpu_torch.interop`, the field's coefficients from
`chip_smoke.kaula_moon_field` (held equal to the example's own). JAX runs
on the CPU in float64; the port runs on the CPU. Each tolerance is stated
at its test. Everything of the slice lives in this one file because every
test worker pays both the JAX and the torch import.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import nyx_tpu as R
from nyx_tpu.cosmic import rotations as r_rotations
from nyx_tpu.dynamics import Harmonics as RHarmonics
from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
from nyx_tpu.ephem.almanac import Almanac as RAlmanac
from nyx_tpu.errors import ConfigError as RConfigError
from nyx_tpu.errors import PropagationError as RPropagationError
from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
from nyx_tpu.od import GroundStation as RGroundStation
from nyx_tpu.od import MeasurementType as RMeasurementType
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

import chip_smoke
import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.constants import NAIF
from nyx_tpu_torch.cosmic import rotations
from nyx_tpu_torch.cosmic.frames import Frame, iau_orient
from nyx_tpu_torch.dynamics import Harmonics, OrbitalDynamics, SpacecraftDynamics, gravity_pines
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.errors import ConfigError, PropagationError
from nyx_tpu_torch.od import GroundStation, TrackingArcSim
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

ROOT = Path(__file__).parents[1]
EX04 = ROOT / "examples" / "04_lro_od.py"
EX04_EPOCH = (2024, 1, 1, 0, 0, 0)
# ex04 at a small size: the field's degree and the arc (h)
DEGREE = 12
HOURS = 2.0
# Rows of the small arc whose range gets a 50 m (25-sigma) error, so that
# the gate rejects them.
OUTLIER_ROWS = [5, 12]
# The reference's own f32 bound for two f32 evaluations of the recursion
# (tests/test_dynamics.py:399,415), per-lane relative norm; the 70x70 split
# bound of test_torch_gravity.py.
F32_REL = 2e-5
# Lunar radii of ex04's orbit, km (its perilune and apolune).
LUNAR_RADII_KM = (1787.4, 1847.4)
DAY_S = 86_400.0
# The split-field truth's envelope, as a multiple of the witness gap (the
# reference's own split-field truth against its f64 one).
WITNESS_MULTIPLE = 10.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _epochs(n, seed, years=50.0):
    """n TDB epochs (s past J2000) spread over +-`years`."""
    return np.random.default_rng(seed).uniform(-years, years, n) * 365.25 * DAY_S


def _lunar_positions(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    return r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(*LUNAR_RADII_KM, (n, 1))


def _ref_stor(stor):
    return RGravityFieldData(stor.c_nm, stor.s_nm, stor.mu_km3_s2, stor.radius_km, R.Frames.IAU_MOON)


# ---------------------------------------------------------------- rotations
BODY_DCMS = {
    "moon": (r_rotations.iau_moon_dcm, rotations.iau_moon_dcm),
    "mars": (r_rotations.iau_mars_dcm, rotations.iau_mars_dcm),
    "sun": (r_rotations.iau_sun_dcm, rotations.iau_sun_dcm),
}


def _ref_dcm_and_rate(ref_fn, t):
    """The reference's DCMs and their jvp at epochs `t`, one epoch at a time:
    the reference's iau_sun_dcm stacks its constant angles with the batched
    one and takes scalar epochs only."""
    out = [jax.jvp(ref_fn, (jnp.float64(x),), (jnp.float64(1.0),)) for x in t]
    return np.stack([np.asarray(d) for d, _ in out]), np.stack([np.asarray(r) for _, r in out])


@pytest.mark.parametrize("body", sorted(BODY_DCMS))
def test_body_dcm_and_rate_match_reference(body):
    """The IAU Moon (13-term series), Mars and Sun DCMs at 64 epochs over
    +-50 years of J2000, and their time derivatives from jvp (jax.jvp /
    torch.func.jvp), each entry to 1e-14. The port's run batched over the
    epochs in f64; the Moon's and Mars' also batched in the reference."""
    ref_fn, fn = BODY_DCMS[body]
    t = _epochs(64, {"moon": 1, "mars": 2, "sun": 3}[body])
    if body == "sun":
        dcm_ref, dot_ref = _ref_dcm_and_rate(ref_fn, t)
    else:
        dcm_ref, dot_ref = jax.jvp(ref_fn, (jnp.asarray(t),), (jnp.ones(len(t)),))
    tt = torch.tensor(t, dtype=torch.float64)
    dcm, dot = torch.func.jvp(fn, (tt,), (torch.ones_like(tt),))
    assert dcm.shape == (64, 3, 3) and dcm.dtype == torch.float64
    np.testing.assert_allclose(dcm.numpy(), np.asarray(dcm_ref), rtol=0, atol=1e-14)
    np.testing.assert_allclose(dot.numpy(), np.asarray(dot_ref), rtol=0, atol=1e-14)
    # orthonormal, and the rate is the body's spin (not zero)
    np.testing.assert_allclose((dcm @ dcm.transpose(1, 2)).numpy(), np.broadcast_to(np.eye(3), (64, 3, 3)),
                               atol=1e-14)
    assert np.abs(dot.numpy()).max() > 1e-7


def test_moon_angles_match_reference():
    """iau_moon_angles (RA, Dec, W in degrees) at the same epochs: 1e-11 deg
    (the angles reach ~1e5 deg over 50 years before the DCM reduces W)."""
    t = _epochs(64, 4)
    for a, a_ref in zip(rotations.iau_moon_angles(torch.tensor(t)),
                        r_rotations.iau_moon_angles(jnp.asarray(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=0, atol=1e-11)


# ---------------------------------------------------------------- frames
FRAME_NAMES = ("EME2000", "EARTH_J2000", "MOON_J2000", "SUN_J2000", "MARS_J2000", "EMB_J2000",
               "SSB_J2000", "IAU_EARTH", "IAU_MOON", "IAU_MARS", "IAU_SUN", "EARTH_ITRF93")


def test_frames_match_reference():
    """Every frame of the reference's Frames: centre, orientation, GM,
    radius, flattening and name equal; `with_mu_km3_s2` changes only the
    GM; each IAU frame's DCM at 8 epochs to 1e-14. ITRF93 (it needs a
    binary PCK) and an orientation without a model raise ConfigError in
    both packages."""
    t = _epochs(8, 5)
    for name in FRAME_NAMES:
        f, f_ref = getattr(P.Frames, name), getattr(R.Frames, name)
        assert (f.center, f.orientation, f.mu_km3_s2, f.radius_km, f.flattening) == \
            (f_ref.center, f_ref.orientation, f_ref.mu_km3_s2, f_ref.radius_km, f_ref.flattening), name
        assert str(f) == str(f_ref), name
        assert f.is_inertial == f_ref.is_inertial
        if name == "EARTH_ITRF93":
            with pytest.raises(ConfigError):
                f.dcm_from_j2000(torch.tensor(t))
            with pytest.raises(RConfigError):
                f_ref.dcm_from_j2000(jnp.asarray(t))
        else:
            dcm_ref = (_ref_dcm_and_rate(f_ref.dcm_from_j2000, t)[0] if name == "IAU_SUN"
                       else np.asarray(f_ref.dcm_from_j2000(jnp.asarray(t))))
            np.testing.assert_allclose(f.dcm_from_j2000(torch.tensor(t)).numpy(), dcm_ref, rtol=0, atol=1e-14)
    assert P.Frames.MARS_J2000.center == NAIF.MARS_BARYCENTER and P.Frames.SSB_J2000.mu_km3_s2 == 0.0
    moon = P.Frames.MOON_J2000.with_mu_km3_s2(4902.800066)
    moon_ref = R.Frames.MOON_J2000.with_mu_km3_s2(4902.800066)
    assert (moon.mu_km3_s2, moon.center, moon.orientation, moon.radius_km) == \
        (moon_ref.mu_km3_s2, moon_ref.center, moon_ref.orientation, moon_ref.radius_km)
    assert P.Frames.MOON_J2000.mu_km3_s2 != moon.mu_km3_s2
    venus, venus_ref = Frame(299, iau_orient(299)), R.cosmic.frames.Frame(299, 10_299)
    with pytest.raises(ConfigError):
        venus.dcm_from_j2000(torch.tensor(t))
    with pytest.raises(RConfigError):
        venus_ref.dcm_from_j2000(jnp.asarray(t))


def test_keplerian_apsis_radii_matches_reference():
    """ex04's orbit (apsis radii 1,847.4 / 1,787.4 km, i 89.7 deg, RAAN 270,
    AOP 30) in MOON_J2000 at its GM, and a Mars orbit: 1e-12 km and km/s."""
    for ra, rp, frame in ((1847.4, 1787.4, "MOON_J2000"), (20_000.0, 4_000.0, "MARS_J2000")):
        args = (ra, rp, 89.7, 270.0, 30.0, 10.0)
        o_ref = R.Orbit.keplerian_apsis_radii(*args, R.Epoch.from_gregorian_utc(*EX04_EPOCH),
                                              getattr(R.Frames, frame).with_mu_km3_s2(4902.800066))
        o = P.Orbit.keplerian_apsis_radii(*args, P.Epoch.from_gregorian_utc(*EX04_EPOCH),
                                          getattr(P.Frames, frame).with_mu_km3_s2(4902.800066))
        np.testing.assert_allclose(o.r_km, o_ref.r_km, rtol=0, atol=1e-12)
        np.testing.assert_allclose(o.v_km_s, o_ref.v_km_s, rtol=0, atol=1e-12)
        assert o.frame.mu_km3_s2 == 4902.800066
        assert abs(o.periapsis_km - rp) < 1e-9 and abs(o.apoapsis_km - ra) < 1e-9


# ---------------------------------------------------------------- the lunar field
def test_kaula_copy_matches_example():
    """chip_smoke.kaula_moon_field is examples/04_lro_od.py::kaula_moon_field
    array for array (the example's function, taken from its source and run
    with the reference's GravityFieldData, at degrees 80 and 12)."""
    tree = ast.parse(EX04.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "kaula_moon_field")
    namespace = {"np": np, "GravityFieldData": RGravityFieldData, "Frames": R.Frames}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(EX04), "exec"), namespace)
    for degree in (80, DEGREE):
        ref = namespace["kaula_moon_field"](degree)
        port = chip_smoke.kaula_moon_field(degree)
        np.testing.assert_array_equal(port.c_nm, ref.c_nm)
        np.testing.assert_array_equal(port.s_nm, ref.s_nm)
        assert (port.mu_km3_s2, port.radius_km) == (ref.mu_km3_s2, ref.radius_km)
        assert (port.frame.center, port.frame.orientation) == (ref.frame.center, ref.frame.orientation)


@pytest.fixture(scope="module")
def field80():
    """(reference split Harmonics, port Harmonics carried over by
    interop.harmonics_from_tables, the port's own from_stor) of the 80x80
    lunar field."""
    stor = chip_smoke.kaula_moon_field(80)
    ref = RHarmonics.from_stor(_ref_stor(stor), precision="split")
    port = interop.harmonics_from_tables(*ref._tables, ref.mu_km3_s2, ref.radius_km, "split",
                                         ref.j2, ref.j3, frame=P.Frames.IAU_MOON)
    return ref, port, Harmonics.from_stor(stor, "split")


def test_lunar_field_tables_and_constants(field80):
    """The port's GravityFieldData / from_stor builds the example's field as
    the reference does (every recursion row and J2, J3 equal); interop
    carries its GM, radius and IAU_MOON frame as they are; the launch plan
    at 80 degree steps streams the table."""
    ref, port, own = field80
    for key, rows in ref._tables[0].items():
        np.testing.assert_array_equal(own._tables[0][key], rows, err_msg=key)
    assert (own.j2, own.j3) == (ref.j2, ref.j3)
    assert (port.mu_km3_s2, port.radius_km) == (ref.mu_km3_s2, ref.radius_km) == (4902.800066, 1737.4)
    assert port.frame == P.Frames.IAU_MOON and own.frame == P.Frames.IAU_MOON
    tab = port.packed_table(0, torch.float32, "cpu")
    plan = gravity_pines.pines_launch_plan(tab.shape[0], tab.shape[2])
    assert tab.shape[0] == 80 and not plan.whole


@pytest.mark.parametrize("q_lo", [0, 3])
def test_lunar_field_f32_twin_matches_reference(field80, q_lo):
    """The 80x80 lunar field at lunar radii: the f32 twin from the carried
    tables against the reference's f32 scan recursion, within the f32
    bound (F32_REL, as test_torch_gravity.py holds 70x70 split)."""
    ref, port, _ = field80
    r = _lunar_positions(32, 7 + q_lo)
    a_ref = np.asarray(ref._accel_scan(jnp.asarray(r, jnp.float32), q_lo))
    a = port._accel_any(torch.tensor(r, dtype=torch.float32), q_lo)
    assert a.dtype == torch.float32 and np.isfinite(a.numpy()).all()
    assert _rel(a.numpy(), a_ref) < F32_REL


def test_lunar_field_f64_twin_matches_reference():
    """The same field at f64 (its f64 tables, carried over): the twin
    against the reference's f64 scan to 1e-11 relative."""
    stor = chip_smoke.kaula_moon_field(80)
    ref = RHarmonics.from_stor(_ref_stor(stor), precision="f64")
    port = interop.harmonics_from_tables(*ref._tables, ref.mu_km3_s2, ref.radius_km, "f64",
                                         ref.j2, ref.j3, frame=P.Frames.IAU_MOON)
    r = _lunar_positions(32, 11)
    a_ref = np.asarray(ref._accel_scan(jnp.asarray(r), 0))
    a = port.accel_body_fixed(torch.tensor(r, dtype=torch.float64))
    assert _rel(a.numpy(), a_ref) < 1e-11


def test_lunar_split_accel_with_rotation(field80):
    """Harmonics.accel at split precision in IAU_MOON, the generic branch
    (pole = the f64 DCM's third row, the f32 DCM cast from it): J2+J3 to
    1e-12 relative, the f32 remainder within F32_REL."""
    from nyx_tpu.dynamics.gravity import _j2j3_accel as r_j2j3
    from nyx_tpu_torch.dynamics.gravity import _j2j3_accel

    ref, port, _ = field80
    r = _lunar_positions(32, 13)
    t = 7.57e8 + np.random.default_rng(14).uniform(0.0, DAY_S, 32)
    a_ref = np.asarray(ref.accel(None, jnp.asarray(t), jnp.asarray(r), None))
    a = port.accel(None, torch.tensor(t), torch.tensor(r), None).numpy()
    pole_ref = np.asarray(R.Frames.IAU_MOON.dcm_from_j2000(jnp.asarray(t)))[:, 2, :]
    low_ref = np.asarray(r_j2j3(ref.mu_km3_s2, ref.radius_km, ref.j2, ref.j3, jnp.asarray(r),
                                jnp.asarray(pole_ref)))
    pole = P.Frames.IAU_MOON.dcm_from_j2000(torch.tensor(t))[:, 2, :]
    low = _j2j3_accel(port.mu_km3_s2, port.radius_km, port.j2, port.j3, torch.tensor(r), pole).numpy()
    assert _rel(low, low_ref) < 1e-12
    assert _rel(a - low_ref, a_ref - low_ref) < F32_REL


# ---------------------------------------------------------------- ephemerides
def test_ephem_posvel_state_translate_match_reference():
    """EphemTable.posvel (the Chebyshev derivative) on the reference's
    Moon and Sun table about the Earth carried over; Almanac.state for
    body pairs through the Moon, Earth, Sun, EMB, Mars and the SSB (on the
    analytic series, velocity by central differences with h = 2 s); and
    translate_to EME2000 -> MOON_J2000: 1e-9 km, 1e-12 km/s. translate_to
    with a rotating frame raises in both; with the same centre it only
    relabels."""
    alm_ref, alm = RAlmanac(), Almanac()
    start = R.Epoch.from_gregorian_utc(*EX04_EPOCH)
    tab_ref = alm_ref.build_table([NAIF.MOON, NAIF.SUN], NAIF.EARTH, start, start + 10 * DAY_S)
    tab = interop.ephem_table_from_numpy(tab_ref.t0, tab_ref.intlen, tab_ref.coeffs, tab_ref.bodies,
                                         device="cpu")
    t = start.to_tdb_seconds() + np.random.default_rng(15).uniform(-DAY_S, 11 * DAY_S, 40)
    for idx in range(2):
        p_ref, v_ref = tab_ref.posvel(idx, jnp.asarray(t))
        p, v = tab.posvel(idx, torch.tensor(t))
        np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=1e-9)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=0, atol=1e-12)
    epoch, epoch_ref = P.Epoch.from_gregorian_utc(*EX04_EPOCH), start
    pairs = [(NAIF.MOON, NAIF.EARTH), (NAIF.EARTH, NAIF.MOON), (NAIF.SUN, NAIF.MOON),
             (NAIF.EARTH_MOON_BARYCENTER, NAIF.SUN), (NAIF.MARS_BARYCENTER, NAIF.EARTH), (NAIF.SSB, NAIF.MOON)]
    for target, center in pairs:
        r_ref, v_ref = alm_ref.state(target, center, epoch_ref)
        r, v = alm.state(target, center, epoch)
        np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-9)
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-12)
    o_ref = R.Orbit.keplerian(400_000.0, 0.05, 20.0, 10.0, 5.0, 40.0, epoch_ref, R.Frames.EME2000)
    o = interop.spacecraft_from_numpy(np.concatenate([o_ref.r_km, o_ref.v_km_s, np.zeros(3)]),
                                      epoch_ref.to_tai_seconds()).orbit
    m_ref = alm_ref.translate_to(o_ref, R.Frames.MOON_J2000)
    m = alm.translate_to(o, P.Frames.MOON_J2000)
    assert m.frame == P.Frames.MOON_J2000
    np.testing.assert_allclose(m.r_km, m_ref.r_km, rtol=0, atol=1e-9)
    np.testing.assert_allclose(m.v_km_s, m_ref.v_km_s, rtol=0, atol=1e-12)
    same = alm.translate_to(o, P.Frames.EARTH_J2000.with_mu_km3_s2(398_600.0))
    assert same.frame.mu_km3_s2 == 398_600.0 and np.array_equal(same.r_km, o.r_km)
    with pytest.raises(ConfigError):
        alm.translate_to(o, P.Frames.IAU_MOON)
    with pytest.raises(RConfigError):
        alm_ref.translate_to(o_ref, R.Frames.IAU_MOON)


# ---------------------------------------------------------------- integration frame
def test_integration_frame_matches_reference():
    """IntegratorOptions.integration_frame (the reference's test_propagators_
    gmat.py:146 scene): an EME2000-expressed lunar orbit propagated over 1 h
    with two-body lunar dynamics and integration_frame=MOON_J2000, translated
    once through the almanac; the final state in MOON_J2000, to 1e-6 km (and
    the port's to 1e-9 km of its own run started in MOON_J2000). Without an
    almanac it raises PropagationError in both; with the same centre the
    state is only relabelled."""
    from dataclasses import replace

    states = {}
    for M, Opts, Prop, SD, OD, alm in ((R, RIntegratorOptions, RPropagator, RSpacecraftDynamics,
                                         ROrbitalDynamics, RAlmanac()),
                                        (P, IntegratorOptions, Propagator, SpacecraftDynamics,
                                         OrbitalDynamics, Almanac())):
        epoch = M.Epoch.from_gregorian_utc(2022, 5, 1)
        moon = M.Frames.MOON_J2000
        orbit_moon = M.Orbit.keplerian(1837.4, 0.01, 25.0, 10.0, 5.0, 0.0, epoch, moon)
        r_m, v_m = R.ephem.almanac.Almanac().state(301, 399, R.Epoch.from_gregorian_utc(2022, 5, 1))
        orbit_eme = M.Orbit.cartesian(*(np.asarray(orbit_moon.r_km) + r_m),
                                      *(np.asarray(orbit_moon.v_km_s) + v_m), epoch, M.Frames.EME2000)
        dyn = SD.new(OD.two_body(moon))
        kw = {} if M is R else dict(device="cpu")
        prop = Prop.rk89(dyn, replace(Opts(), integration_frame=moon))
        via = prop.with_state(M.Spacecraft.from_orbit(orbit_eme), alm, **kw).for_duration(3600.0)
        direct = Prop.rk89(dyn, Opts()).with_state(M.Spacecraft.from_orbit(orbit_moon), alm, **kw) \
            .for_duration(3600.0)
        assert via.frame.center == 301
        states[M] = (via.to_vector(), direct.to_vector())
        err = RPropagationError if M is R else PropagationError
        with pytest.raises(err):
            prop.with_state(M.Spacecraft.from_orbit(orbit_eme), None, **kw)
        relabel = prop.with_state(M.Spacecraft.from_orbit(
            replace(orbit_moon, frame=moon.with_mu_km3_s2(4902.8))), None, **kw)
        assert relabel.state.frame == moon
    (via, direct), (via_ref, _) = states[P], states[R]
    print(f"\nintegration frame: port vs reference {np.linalg.norm(via[:3] - via_ref[:3]):.3e} km, "
          f"port via vs direct {np.linalg.norm(via[:3] - direct[:3]):.3e} km")
    assert np.linalg.norm(via[:3] - via_ref[:3]) < 1e-6
    assert np.linalg.norm(via[:3] - direct[:3]) < 1e-9


# ---------------------------------------------------------------- ex04's scene, small
def _ref_scene(stor, precision):
    """examples/04_lro_od.py:81-238 through the reference at `stor`:
    (truth spacecraft, propagator, stations)."""
    epoch = R.Epoch.from_gregorian_utc(*EX04_EPOCH)
    orbit = R.Orbit.keplerian_apsis_radii(1847.4, 1787.4, 89.7, 270.0, 30.0, 0.0, epoch,
                                          R.Frames.MOON_J2000.with_mu_km3_s2(4902.800066))
    dyn = RSpacecraftDynamics.new(ROrbitalDynamics.from_model(
        RHarmonics.from_stor(_ref_stor(stor), precision=precision), R.Frames.MOON_J2000))
    prop = RPropagator.rk89(dyn, RIntegratorOptions(max_step_s=60.0, tolerance=1e-10))

    def station(name, lat, lon):
        gs = RGroundStation(name, lat, lon, 0.0, frame=R.Frames.IAU_MOON, elevation_mask_deg=5.0,
                            integration_time_s=60.0)
        gs.stochastic_noises = {RMeasurementType.RANGE_KM: RStochasticNoise(RWhiteNoise(2.0e-3)),
                                RMeasurementType.DOPPLER_KM_S: RStochasticNoise(RWhiteNoise(3.0e-6))}
        return gs

    stations = [station("Shackleton", -89.5, 0.0), station("Malapert", -86.0, 2.9),
                station("Peary", 88.6, 33.0), station("Amundsen", -84.5, 69.9),
                station("Whipple", 89.1, 120.0), station("Cabeus", -85.3, -42.1)]
    return R.Spacecraft.from_orbit(orbit), prop, stations


@pytest.fixture(scope="module")
def ex04_ref():
    """The reference's ex04 at degree 12 over 2 h with the f64 field: the
    truth, its two-way arc (simulator seed 4; the same with outliers) and
    the dispersed estimate (numpy default_rng(42))."""
    stor = chip_smoke.kaula_moon_field(DEGREE)
    truth, prop, stations = _ref_scene(stor, "f64")
    alm = RAlmanac()
    _, traj = prop.with_state(truth, alm).for_duration_with_traj(HOURS * 3600.0)
    cfg = RTrkConfig(sampling_s=60.0, scheduler=RScheduler(min_samples=3))
    arc = RTrackingArcSim.with_seed(stations, traj, {g.name: cfg for g in stations},
                                    seed=4).generate_measurements(alm)
    est = RSpacecraftUncertainty(nominal=truth, frame="ric", x_km=0.1, y_km=0.1, z_km=0.1,
                                 vx_km_s=1e-5, vy_km_s=1e-5, vz_km_s=1e-5).to_estimate()
    draw = np.random.default_rng(42).multivariate_normal(np.zeros(9), est.covar)
    est.nominal = truth.set_vector(truth.epoch, truth.to_vector() + draw)
    values = arc.values.copy()
    values[OUTLIER_ROWS, 0] += 0.05
    import dataclasses

    arc_out = dataclasses.replace(arc, values=values)
    od = RScanKalmanOD(prop, stations, types=(RMeasurementType.RANGE_KM, RMeasurementType.DOPPLER_KM_S),
                       variant="ekf", process_noise=(RProcessNoise.from_diag([1e-16] * 3, 3600.0),),
                       resid_rejection_sigmas=3.0, almanac=alm, stm_jvp_degree=8)
    sol = od.process_arc(est, arc_out)
    return dict(stor=stor, truth=truth, traj=traj, arc=arc, arc_out=arc_out, est=est, sol=sol)


def _port_traj(traj, frame=P.Frames.MOON_J2000):
    return interop.trajectory_from_numpy(traj.epoch0.to_tai_seconds(), traj.ts, traj.ys, frame)


def test_ex04_truth_matches_reference(ex04_ref):
    """The port's ex04 scene (chip_smoke.ex04_scene: the same initial state,
    the same draw and covariance) and its truth over 2 h. With the f64
    field: node counts within 2 of the reference's, final position within
    1e-6 km. With the split field (the f32 twin for degrees 4-12): the
    final position within WITNESS_MULTIPLE times the reference's own
    split-vs-f64 gap of the reference's f64 truth (the f32 rounding steers
    the step at 1e-10, so the split runs' step sequences are their own;
    node counts printed)."""
    ref = ex04_ref
    scene = chip_smoke.ex04_scene(ref["stor"], "f64", device="cpu")
    np.testing.assert_array_equal(scene.truth.to_vector(), ref["truth"].to_vector())
    np.testing.assert_array_equal(scene.est0.covar, ref["est"].covar)
    np.testing.assert_array_equal(scene.est0.nominal.to_vector(), ref["est"].nominal.to_vector())
    end_ref = ref["traj"].ys[-1, :3]
    trajs = {}
    for precision in ("f64", "split"):
        scene = chip_smoke.ex04_scene(ref["stor"], precision, device="cpu")
        trajs[precision] = scene.propagator("auto").with_state(scene.truth, scene.almanac, device="cpu") \
            .for_duration_with_traj(HOURS * 3600.0)[1]
    truth, prop, _ = _ref_scene(ref["stor"], "split")
    split_ref = prop.with_state(truth, RAlmanac()).for_duration_with_traj(HOURS * 3600.0)[1]
    d = float(np.linalg.norm(trajs["f64"].ys[-1, :3] - end_ref))
    d_split = float(np.linalg.norm(trajs["split"].ys[-1, :3] - end_ref))
    witness = float(np.linalg.norm(split_ref.ys[-1, :3] - end_ref))
    print(f"\nex04 truth, degree {DEGREE}, {HOURS:g} h, f64 field: nodes {len(trajs['f64'])} vs "
          f"{len(ref['traj'])}, final position {d:.3e} km; split field: nodes {len(trajs['split'])} vs "
          f"{len(split_ref)}, final position {d_split:.3e} km from the reference's f64 truth (the "
          f"reference's split run: {witness:.3e} km)")
    assert abs(len(trajs["f64"]) - len(ref["traj"])) <= 2
    assert trajs["f64"].ts[-1] == ref["traj"].ts[-1] == HOURS * 3600.0
    assert d < 1e-6
    assert 0.0 < d_split < WITNESS_MULTIPLE * witness


def test_ex04_measurements_match_reference(ex04_ref):
    """The port's simulator on the reference's truth with the six polar
    IAU_MOON stations (two-way, 60 s, min_samples 3, seed 4): the same rows
    (epochs, trackers) and values to 1e-9."""
    ref = ex04_ref
    scene = chip_smoke.ex04_scene(ref["stor"], "f64", device="cpu")
    arc = TrackingArcSim.with_seed(scene.stations, _port_traj(ref["traj"]),
                                   {g.name: scene.cfg for g in scene.stations}, seed=4,
                                   device="cpu").generate_measurements(scene.almanac)
    arc_ref = ref["arc"]
    print(f"\nex04 arc: {len(arc)} rows from {len(set(arc.tracker_idx.tolist()))} stations")
    assert len(arc) == len(arc_ref) > 10
    assert arc.trackers == tuple(arc_ref.trackers) and arc.types == tuple(arc_ref.types)
    np.testing.assert_array_equal(arc.epochs_tai_s, arc_ref.epochs_tai_s)
    np.testing.assert_array_equal(arc.tracker_idx, arc_ref.tracker_idx)
    np.testing.assert_allclose(arc.values, arc_ref.values, rtol=0, atol=1e-9)


def _port_inputs(ref, arc_key="arc_out"):
    arc = ref[arc_key]
    est = ref["est"]
    return (interop.kf_estimate_from_numpy(est.nominal.to_vector(), est.covar, est.epoch.to_tai_seconds(),
                                           P.Frames.MOON_J2000),
            interop.tracking_arc_from_numpy(arc.trackers, arc.types, arc.epochs_tai_s, arc.tracker_idx,
                                            arc.values))


def test_ex04_ekf_matches_reference(ex04_ref):
    """The segmented EKF (SNC, 3-sigma gate, stm_jvp_degree 8) on the
    reference's arc with two 25-sigma range outliers, from the dispersed
    estimate, with the f64 field in both: every row's estimate within
    1e-6 km and the same rejections, the outliers among them (with an f64
    field the flagship leg's EKF parity scene measures 5.2e-7 km)."""
    ref = ex04_ref
    sol_ref = ref["sol"]
    est, arc = _port_inputs(ref)
    od = chip_smoke.ex04_scene(ref["stor"], "f64", device="cpu").od("auto")
    sol = od.process_arc(est, arc)
    assert sol.y_est.shape == sol_ref.y_est.shape
    gap = float(np.linalg.norm(sol.y_est[:, :3] - sol_ref.y_est[:, :3], axis=1).max())
    print(f"\nex04 EKF: {od.stage_walls_s['segments']} segments, {int(sol.rejected.sum())} rejections, "
          f"estimates {gap:.3e} km from the reference's")
    np.testing.assert_array_equal(sol.rejected, sol_ref.rejected)
    assert sol_ref.rejected[OUTLIER_ROWS].all()
    assert od.stage_walls_s["segments"] > 1 and gap < 1e-6


# ---------------------------------------------------------------- trajectory transforms
def test_trajectory_to_frame_groundtrack_ric_match_reference(ex04_ref, tmp_path):
    """On the reference's ex04 truth (MOON_J2000), carried over:
    to_frame(IAU_MOON) (the rotation, the transport term from the DCM's
    jvp), to_frame(EME2000) with an almanac (the Moon's position, velocity
    by h = 16 s central differences) and back through it to IAU_MOON,
    groundtrack in IAU_MOON (the port's default for a lunar trajectory),
    ric_diff against a perturbed copy and ric_diff_to_parquet's columns:
    1e-9 km (km/s) and 1e-9 deg."""
    traj_ref = ref_traj = ex04_ref["traj"]
    traj = _port_traj(ref_traj)
    alm_ref, alm = RAlmanac(), Almanac()
    body = traj.to_frame(P.Frames.IAU_MOON, device="cpu")
    body_ref = traj_ref.to_frame(R.Frames.IAU_MOON)
    np.testing.assert_allclose(body.ys[:, :6], np.asarray(body_ref.ys)[:, :6], rtol=0, atol=1e-9)
    assert body.template.frame == P.Frames.IAU_MOON
    # the transport term, -w x r, is the Moon's spin at ~1,800 km (~5 m/s)
    dcm = P.Frames.IAU_MOON.dcm_from_j2000(torch.tensor(traj.epoch0.to_tdb_seconds() + traj.ts))
    naive = rotations.apply_dcm(dcm, torch.tensor(traj.ys[:, 3:6])).numpy()
    assert 3e-3 < np.linalg.norm(body.ys[:, 3:6] - naive, axis=1).max() < 6e-3
    eme = traj.to_frame(P.Frames.EME2000, alm, device="cpu")
    eme_ref = traj_ref.to_frame(R.Frames.EME2000, alm_ref)
    np.testing.assert_allclose(eme.ys[:, :6], np.asarray(eme_ref.ys)[:, :6], rtol=0, atol=1e-9)
    back = eme.to_frame(P.Frames.IAU_MOON, alm, device="cpu")
    back_ref = eme_ref.to_frame(R.Frames.IAU_MOON, alm_ref)
    np.testing.assert_allclose(back.ys[:, :6], np.asarray(back_ref.ys)[:, :6], rtol=0, atol=1e-9)
    with pytest.raises(P.errors.TrajError):
        traj.to_frame(P.Frames.EME2000, device="cpu")

    ts, lat, lon, alt = traj.groundtrack(step=120.0, device="cpu")
    ts_ref, lat_ref, lon_ref, alt_ref = traj_ref.groundtrack(R.Frames.IAU_MOON, step=120.0)
    np.testing.assert_array_equal(ts, ts_ref)
    for a, b in ((lat, lat_ref), (lon, lon_ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    np.testing.assert_allclose(alt, alt_ref, rtol=0, atol=1e-9)
    assert 40.0 < alt.min() and alt.max() < 120.0  # the 50 x 110 km orbit
    with pytest.raises(ConfigError):
        traj.groundtrack(P.Frames.IAU_EARTH, device="cpu")

    other_ys = np.asarray(ref_traj.ys).copy()
    other_ys[:, 0:3] += np.array([1e-3, -2e-3, 5e-4])
    other_ys[:, 3:6] += np.array([1e-6, 0.0, -2e-6])
    other_ref = R.md.trajectory.Trajectory(ref_traj.epoch0 + 30.0, ref_traj.ts - 30.0, other_ys,
                                           ref_traj.template)
    other = interop.trajectory_from_numpy(other_ref.epoch0.to_tai_seconds(), other_ref.ts, other_ys,
                                          P.Frames.MOON_J2000)
    ts, dr, dv = traj.ric_diff(other, step=90.0)
    ts_ref, dr_ref, dv_ref = traj_ref.ric_diff(other_ref, step=90.0)
    np.testing.assert_array_equal(ts, ts_ref)
    np.testing.assert_allclose(dr, dr_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(dv, dv_ref, rtol=0, atol=1e-9)
    path, path_ref = tmp_path / "ric.parquet", tmp_path / "ric_ref.parquet"
    traj.ric_diff_to_parquet(other, path, step=90.0)
    traj_ref.ric_diff_to_parquet(other_ref, path_ref, step=90.0)
    tab, tab_ref = pq.read_table(path), pq.read_table(path_ref)
    assert tab.column_names == tab_ref.column_names
    for name in tab.column_names:
        np.testing.assert_allclose(np.asarray(tab[name]), np.asarray(tab_ref[name]), rtol=0, atol=1e-9)


# ---------------------------------------------------------------- a hidden Earth
def test_stations_about_another_body_are_refused(ex04_ref):
    """The geometry subtracts a station's position about its own body from
    a spacecraft state about the trajectory's: Earth stations against the
    lunar truth, or lunar stations against an Earth-centred estimate, are
    refused with ConfigError (the reference computes such geometry without
    a word unless the stations carry with_target_frame, which is not
    ported). The DSN constructors keep their IAU_EARTH default."""
    ref = ex04_ref
    scene = chip_smoke.ex04_scene(ref["stor"], "f64", device="cpu")
    earth = [GroundStation.dss65_madrid(10.0)]
    assert earth[0].frame == P.Frames.IAU_EARTH and scene.stations[0].frame == P.Frames.IAU_MOON
    with pytest.raises(ConfigError):
        TrackingArcSim.with_seed(earth, _port_traj(ref["traj"]), {}, seed=4, device="cpu")
    est, arc = _port_inputs(ref)
    est_earth = interop.kf_estimate_from_numpy(est.nominal.to_vector(), est.covar, est.epoch.to_tai_seconds(),
                                               P.Frames.EME2000)
    with pytest.raises(ConfigError):
        scene.od("auto").process_arc(est_earth, arc)
    # IAU_MOON stations sit on the Moon's mean sphere
    from nyx_tpu_torch.od.ground_station import geodetic_to_body_fixed

    f = P.Frames.IAU_MOON
    r = geodetic_to_body_fixed(*(torch.tensor(x, dtype=torch.float64) for x in (-89.5, 0.0, 0.0)),
                               f.radius_km, f.flattening)
    assert f.flattening == 0.0 and abs(float(r.norm()) - 1737.4) < 1e-9
