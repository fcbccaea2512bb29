"""Guided-spacecraft parity: the port's Ruggiero law, point masses, thrust and
mass flow, the guidance-mode column and per-lane guidance parameters against
nyx_tpu, along Config 4's station-keeping path (examples/03_geo_analysis.py:
248-350: GEO, 8x8 JGM3, Sun and Moon point masses, SRP with an Earth
shadow, a 0.472 N / 4,435 s thruster, Ruggiero on sma, ecc and inc with a
20 % eclipse gate, RK89 at 1e-10 with a 30 s step floor).

Inputs come from numpy seeds and reach both packages unchanged: states as
arrays, the reference's spacecraft and ephemeris tables through
`nyx_tpu_torch.interop`. JAX runs on the CPU in float64.

Tolerances, each stated at its test: 1e-12 where both packages compute the
same float64 formulas; 1e-7 relative on the acceleration where the split
field's float32 recursion enters (its f32 part is held to 2e-5 relative,
tests/test_dynamics.py:399, and is under 5e-3 of the total here); and for
whole propagations an envelope measured on this scene and printed (`-s`).
The equatorial, near-circular GEO start sits on the `equa` branch of the
Keplerian conversion in both packages; the branch thresholds are the same,
so a lane an ulp from a threshold could take the other branch in one
package, which is why whole runs are held by an envelope, not bit for bit.
"""

from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nyx_tpu as R
from nyx_tpu.constants import NAIF, STD_GRAVITY_M_S2
from nyx_tpu.cosmic.spacecraft import GuidanceMode as RGuidanceMode
from nyx_tpu.cosmic.spacecraft import Thruster as RThruster
from nyx_tpu.dynamics import Harmonics as RHarmonics
from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
from nyx_tpu.dynamics import PointMasses as RPointMasses
from nyx_tpu.dynamics import Ruggiero as RRuggiero
from nyx_tpu.dynamics import SolarPressure as RSolarPressure
from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
from nyx_tpu.dynamics.orbital import EomContext as REomContext
from nyx_tpu.ephem.almanac import Almanac as RAlmanac
from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
from nyx_tpu.mc import MonteCarlo as RMonteCarlo
from nyx_tpu.mc import MvnSpacecraft as RMvnSpacecraft
from nyx_tpu.mc import StateDispersion as RStateDispersion
from nyx_tpu.md.objective import Objective as RObjective
from nyx_tpu.md.param import StateParameter as RStateParameter
from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
from nyx_tpu.propagators import Propagator as RPropagator

import nyx_tpu_torch as P
from nyx_tpu_torch import interop
from nyx_tpu_torch.cosmic.eclipse import occultation_percentage
from nyx_tpu_torch.cosmic.frames import Frame
from nyx_tpu_torch.cosmic.orbit import cartesian_from_keplerian
from nyx_tpu_torch.cosmic.spacecraft import GuidanceMode, Thruster
from nyx_tpu_torch.dynamics import (
    Harmonics,
    OrbitalDynamics,
    PointMasses,
    Ruggiero,
    SolarPressure,
    SpacecraftDynamics,
)
from nyx_tpu_torch.dynamics.orbital import EomContext
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.errors import ConfigError, GuidanceConfigError
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, Results, StateDispersion
from nyx_tpu_torch.md.objective import Objective
from nyx_tpu_torch.md.param import StateParameter
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

JGM3 = Path(__file__).parents[1] / "data/JGM3.cof.gz"
F64 = 1e-12
EPOCH = (2024, 2, 29, 12, 13, 14)
THRUSTER = (0.472, 4435.0)  # NEXT-STEP class, N and s
MU = R.Frames.EME2000.mu


def _rel(a, b):
    """Max over lanes of |a - b| / |b|, norms over the last axis."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _j(x):
    return jnp.asarray(np.asarray(x), jnp.float64)


def _cart(el):
    """[n, 6] Cartesian states from [n, 6] Keplerian elements (km, deg)."""
    el = np.asarray(el, np.float64)
    r, v = cartesian_from_keplerian(*(_t(el[:, k] if k < 2 else np.radians(el[:, k])) for k in range(6)),
                                    MU)
    return np.concatenate([r.numpy(), v.numpy()], axis=1)


def _objectives(M, kinds):
    """Objectives on sma, ecc, inc (Config 4's), raan and aop."""
    Obj, SP = (RObjective, RStateParameter) if M is R else (Objective, StateParameter)
    table = {
        "sma": Obj.within_tolerance(SP.SMA, 42_165.0, 20.0),
        "ecc": Obj.within_tolerance(SP.ECC, 0.001, 5e-5),
        "inc": Obj.within_tolerance(SP.INC, 0.05, 1e-2),
        "raan": Obj.within_tolerance(SP.RAAN, 10.0, 0.1),
        "aop": Obj.within_tolerance(SP.AOP, 30.0, 0.1),
    }
    return [table[k] for k in kinds]


def _spacecraft(kep, mode=RGuidanceMode.Thrust, thruster=THRUSTER, dry=1000.0, prop=1000.0):
    """(reference, port) spacecraft with a thruster from Keplerian elements
    at Config 4's epoch; the port's is carried over by interop."""
    epoch = R.Epoch.from_gregorian_utc(*EPOCH)
    orbit = R.Orbit.keplerian(*kep, epoch, R.Frames.EME2000)
    ref = R.Spacecraft.from_thruster(orbit, dry, prop, RThruster(*thruster), mode).with_srp(18.0, 1.8)
    port = interop.spacecraft_from_numpy(ref.to_vector(), epoch.to_tai_seconds(), dry_mass_kg=dry,
                                         srp_area_m2=18.0, thruster=thruster, mode=mode)
    return ref, port


GEO_KEP = (42_164.0, 1e-5, 0.0, 163.0, 75.0, 0.0)  # examples/03_geo_analysis.py:262
GTO_KEP = (24_505.9, 0.725, 7.05, 0.0, 0.0, 0.0)  # :131


def _sk_dynamics(precision, sc_ref, sc):
    """(reference, port) dynamics of examples/03_geo_analysis.py:270-291."""
    out = []
    for M, Stor, H, PM, OD, SRP, SD, Rug in (
        (R, RGravityFieldData, RHarmonics, RPointMasses, ROrbitalDynamics, RSolarPressure,
         RSpacecraftDynamics, RRuggiero),
        (P, GravityFieldData, Harmonics, PointMasses, OrbitalDynamics, SolarPressure,
         SpacecraftDynamics, Ruggiero),
    ):
        law = Rug.from_max_eclipse(_objectives(M, ("sma", "ecc", "inc")), sc_ref if M is R else sc, 0.2)
        stor = Stor.from_cof(JGM3, 8, 8, True, M.Frames.IAU_EARTH)
        orbital = OD.from_models((H.from_stor(stor, precision=precision), PM((NAIF.MOON, NAIF.SUN))),
                                 M.Frames.EME2000)
        out.append(SD(orbital, (SRP.default(),), guidance=law))
    return out


def _lanes(n_gto, n_geo, seed):
    """[n, 6] states: GTO lanes around the raise's start and GEO lanes
    around the station-keeping orbit (some exactly equatorial), angles
    spread over the whole orbit."""
    rng = np.random.default_rng(seed)
    gto = np.column_stack([
        24_505.9 + rng.normal(0, 50, n_gto), rng.uniform(0.6, 0.75, n_gto), rng.uniform(1, 10, n_gto),
        rng.uniform(0, 360, n_gto), rng.uniform(0, 360, n_gto), rng.uniform(0, 360, n_gto)])
    inc = rng.uniform(0.0, 0.1, n_geo)
    inc[::3] = 0.0
    geo = np.column_stack([
        42_164.0 + rng.normal(0, 3, n_geo), rng.uniform(1e-5, 2e-3, n_geo), inc,
        rng.uniform(0, 360, n_geo), rng.uniform(0, 360, n_geo), rng.uniform(0, 360, n_geo)])
    return _cart(np.concatenate([gto, geo]))


def test_ruggiero_direction_vs_reference_numbers():
    """The reference's ruggiero_weight unit test (ruggiero.rs:456-510, the
    numbers of tests/test_propulsion.py:33-62): an SMA + ECC raise's
    steering to 1e-12, full throttle, nothing while coasting."""
    eme = Frame(NAIF.EARTH, mu_km3_s2=398_600.433)
    epoch = P.Epoch.from_gregorian_utc(2020, 1, 1)
    sc = P.Spacecraft.from_orbit(P.Orbit.keplerian(7378.1363, 0.01, 0.05, 0.0, 0.0, 1.0, epoch, eme))
    law = Ruggiero.simple([Objective.within_tolerance(StateParameter.SMA, 42164.0, 1.0),
                           Objective.within_tolerance(StateParameter.ECC, 0.01, 5e-5)], sc)
    osc = [7_303.253_461_441_64, 127.478_714_816_381_75, 0.111_246_193_227_445_4,
           -0.128_284_025_765_195_6, 7.422_889_151_816_439, 0.006_477_694_429_837_2]
    y9 = _t([osc + [1.8, 2.2, 1.0]])
    ctx = SimpleNamespace(frame=eme)
    u, throttle = law.direction_and_throttle(ctx, torch.zeros(1), y9, torch.full((1,), 1.0))
    expected = np.array([-0.017_279_636_133_108_3, 0.999_850_315_226_803, 0.000_872_534_222_883_2])
    assert np.linalg.norm(u[0].numpy() - expected) < F64
    assert float(throttle[0]) == 1.0
    u0, t0 = law.direction_and_throttle(ctx, torch.zeros(1), y9, torch.full((1,), 0.0))
    assert float(u0.norm()) == 0.0 and float(t0[0]) == 0.0


@pytest.mark.parametrize("kinds", [("sma",), ("ecc",), ("inc",), ("raan",), ("aop",),
                                   ("sma", "ecc", "inc"), "per-lane thresholds"])
def test_direction_and_throttle_matches_reference(kinds):
    """Ruggiero's steering and throttle on 16 seeded GTO and 16 GEO lanes
    (a third of them exactly equatorial) for each objective kind alone,
    Config 4's three together, and the three with per-lane efficiency
    thresholds from the context ([B, 3], from_ctx_thresholds): unit vectors
    to 1e-12, throttles equal. Every fourth lane coasts."""
    per_lane = kinds == "per-lane thresholds"
    if per_lane:
        kinds = ("sma", "ecc", "inc")
    sc_ref, sc = _spacecraft(GTO_KEP)
    y6 = _lanes(16, 16, seed=11)
    n = len(y6)
    y9 = np.concatenate([y6, np.tile([1.8, 2.2, 900.0], (n, 1))], axis=1)
    mode = np.where(np.arange(n) % 4 == 3, 0.0, 1.0)
    thr = np.random.default_rng(12).uniform(0.0, 0.9, (n, 3))
    if per_lane:
        law_ref = RRuggiero.from_ctx_thresholds(_objectives(R, kinds), sc_ref)
        law = Ruggiero.from_ctx_thresholds(_objectives(P, kinds), sc)
    else:
        law_ref = RRuggiero.simple(_objectives(R, kinds), sc_ref)
        law = Ruggiero.simple(_objectives(P, kinds), sc)
    np.testing.assert_allclose(law.init_values, law_ref.init_values, rtol=F64)
    ctx_ref = SimpleNamespace(frame=R.Frames.EME2000, guidance_params=_j(thr) if per_lane else None)
    ctx = SimpleNamespace(frame=P.Frames.EME2000, guidance_params=_t(thr) if per_lane else None)
    u_ref, th_ref = law_ref.direction_and_throttle(ctx_ref, _j(np.zeros(n)), _j(y9), _j(mode))
    u, th = law.direction_and_throttle(ctx, _t(np.zeros(n)), _t(y9), _t(mode))
    assert np.abs(u.numpy() - np.asarray(u_ref)).max() < F64
    np.testing.assert_array_equal(th.numpy(), np.asarray(th_ref))
    assert (th.numpy()[mode == 1.0] == 1.0).any() and (th.numpy()[mode == 0.0] == 0.0).all()


def _sun_table(epoch_ref, seconds):
    """The reference's Sun/Moon table over the arc, and the same arrays
    carried into the port."""
    tab_ref = RAlmanac().build_table([NAIF.MOON, NAIF.SUN], NAIF.EARTH, epoch_ref, epoch_ref + seconds)
    tab = interop.ephem_table_from_numpy(float(tab_ref.t0), float(tab_ref.intlen),
                                         np.asarray(tab_ref.coeffs), tab_ref.bodies, device="cpu")
    return tab_ref, tab


def test_next_mode_matches_reference():
    """next_mode with Config 4's eclipse gate (coast above 20 % occultation)
    on equatorial GEO lanes swept through the Earth's shadow at the epoch
    (sunlit, penumbral on both sides of the gate, umbral), lanes whose
    objectives are achieved, and Inhibit lanes: identical modes, and the
    modes the law prescribes. The occultation is taken at f64."""
    sc_ref, sc = _spacecraft(GEO_KEP)
    law_ref = RRuggiero.from_max_eclipse(_objectives(R, ("sma", "ecc", "inc")), sc_ref, 0.2)
    law = Ruggiero.from_max_eclipse(_objectives(P, ("sma", "ecc", "inc")), sc, 0.2)
    tab_ref, tab = _sun_table(sc_ref.epoch, 3600.0)
    t0 = sc_ref.epoch.to_tdb_seconds()
    sun = tab.position(tab.index_of(NAIF.SUN), _t([t0]))[0].numpy()
    anti = np.degrees(np.arctan2(-sun[1], -sun[0]))
    lon = np.concatenate([anti + np.linspace(-9.0, 9.0, 73), anti + [90.0, 180.0, 270.0]])
    k = len(lon)
    # not achieved (ecc 1e-5), achieved (sma, ecc and inc on target), and
    # not achieved but inhibited, at every longitude
    el = np.concatenate([
        np.column_stack([np.full(k, 42_164.0), np.full(k, 1e-5), np.zeros(k), np.zeros(k), np.zeros(k), lon]),
        np.column_stack([np.full(k, 42_165.0), np.full(k, 1e-3), np.full(k, 0.05), np.zeros(k),
                         np.zeros(k), lon]),
        np.column_stack([np.full(k, 42_164.0), np.full(k, 1e-5), np.zeros(k), np.zeros(k), np.zeros(k), lon]),
    ])
    y6 = _cart(el)
    n = len(y6)
    y9 = np.concatenate([y6, np.tile([1.8, 2.2, 1000.0], (n, 1))], axis=1)
    mode = np.concatenate([np.ones(k), np.where(np.arange(k) % 2, 0.0, 1.0), np.full(k, 2.0)])
    t = np.full(n, t0)
    pct = occultation_percentage(tab.position(tab.index_of(NAIF.SUN), _t(t)) - _t(y6[:, :3]),
                                 -_t(y6[:, :3]), 6378.1363).numpy()
    shadow = pct[:k]
    assert (shadow == 0).any() and (shadow == 1).any()
    assert ((shadow > 0) & (shadow < 0.2)).any() and ((shadow > 0.2) & (shadow < 1)).any()
    assert np.abs(pct - 0.2).min() > 1e-6  # no lane on the gate itself

    ctx_ref = REomContext(epoch0_tdb=jnp.float64(0.0), table=tab_ref, frame=R.Frames.EME2000)
    ctx = EomContext(epoch0_tdb=0.0, table=tab, frame=P.Frames.EME2000)
    m_ref = np.asarray(law_ref.next_mode(ctx_ref, _j(t), _j(y9), _j(mode)))
    m = law.next_mode(ctx, _t(t), _t(y9), _t(mode)).numpy()
    np.testing.assert_array_equal(m, m_ref)
    achieved = np.repeat([False, True, False], k)
    want = np.where(mode == 2.0, 2.0, np.where(achieved | (pct > 0.2), 0.0, 1.0))
    np.testing.assert_array_equal(m, want)


@pytest.mark.parametrize("light_time", [False, True])
def test_point_masses_matches_reference(light_time):
    """PointMasses((SUN, MOON)) on lanes from LEO to beyond GEO over a day,
    with and without light time, on the reference's table carried across:
    1e-12 relative. (The Sun's term is the difference of two nearly equal
    accelerations, about 2,000 times the result at GEO and 10,000 times in
    LEO, so a norm summed in another order than jnp.linalg.norm's puts
    1.4e-12 between the packages.)"""
    epoch = R.Epoch.from_gregorian_utc(*EPOCH)
    tab_ref, tab = _sun_table(epoch, 86_400.0)
    rng = np.random.default_rng(21)
    r = rng.normal(size=(32, 3))
    r = r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(6_700.0, 45_000.0, (32, 1))
    t = epoch.to_tdb_seconds() + rng.uniform(0.0, 86_400.0, 32)
    ctx_ref = REomContext(epoch0_tdb=jnp.float64(0.0), table=tab_ref, frame=R.Frames.EME2000)
    ctx = EomContext(epoch0_tdb=0.0, table=tab, frame=P.Frames.EME2000)
    bodies = (NAIF.SUN, NAIF.MOON)
    a_ref = RPointMasses(bodies, light_time).accel(ctx_ref, _j(t), _j(r), _j(r))
    a = PointMasses(bodies, light_time).accel(ctx, _t(t), _t(r), _t(r))
    assert a.dtype == torch.float64
    assert _rel(a.numpy(), a_ref) < F64
    if light_time:  # the option changes the answer
        assert _rel(a.numpy(), PointMasses(bodies).accel(ctx, _t(t), _t(r), _t(r)).numpy()) > 1e-9


@pytest.mark.parametrize("precision", ["f64", "split"])
def test_guided_eom_and_finally_match_reference(precision):
    """One guided EOM call on [B, 10] states (Config 4's dynamics, Thrust and
    Coast lanes, the thrust acceleration and the mass flow) against the
    reference's make_eom(thruster=...), and the post-step hook (Cr clamp,
    next mode). Velocities and the mode column are equal; accelerations
    to 1e-12 relative with the f64 field and 1e-7 with the split field
    (the f32 recursion's 2e-5 on under 5e-3 of the total); the mass flow
    to 1e-12; the hook's output equal."""
    sc_ref, sc = _spacecraft(GEO_KEP)
    dyn_ref, dyn = _sk_dynamics(precision, sc_ref, sc)
    ctx_ref = dyn_ref.build_context(sc_ref.epoch, 86_400.0, RAlmanac())
    ctx = dyn.build_context(sc.epoch, 86_400.0, Almanac(), device="cpu")
    assert dyn.required_bodies() == dyn_ref.required_bodies() == [NAIF.MOON, NAIF.SUN]
    np.testing.assert_array_equal(ctx.table.coeffs.numpy(), np.asarray(ctx_ref.table.coeffs))
    y6 = _lanes(8, 24, seed=31)
    n = len(y6)
    rng = np.random.default_rng(32)
    y = np.concatenate([y6, np.column_stack([rng.uniform(-0.5, 2.5, n), np.full(n, 2.2),
                                             rng.uniform(100.0, 1000.0, n),
                                             np.where(np.arange(n) % 3 == 2, 0.0, 1.0)])], axis=1)
    t = np.linspace(0.0, 86_400.0, n)
    p = dict(dry_mass_kg=1000.0, srp_area_m2=18.0, drag_area_m2=0.0)
    d_ref = np.asarray(dyn_ref.make_eom(thruster=sc_ref.thruster)(_j(t), _j(y), ctx_ref, p))
    d = dyn.make_eom(thruster=sc.thruster)(_t(t), _t(y), ctx, p).numpy()
    assert d.shape == (n, 10) == d_ref.shape
    np.testing.assert_array_equal(d[:, [0, 1, 2, 6, 7, 9]], d_ref[:, [0, 1, 2, 6, 7, 9]])
    assert _rel(d[:, 3:6], d_ref[:, 3:6]) < (F64 if precision == "f64" else 1e-7)
    np.testing.assert_allclose(d[:, 8], d_ref[:, 8], rtol=F64, atol=0)
    mdot = -THRUSTER[0] / (THRUSTER[1] * STD_GRAVITY_M_S2)
    assert (d[y[:, 9] == 1.0, 8] == mdot).all() and (d[y[:, 9] == 0.0, 8] == 0.0).all()

    fin_ref = np.asarray(dyn_ref.make_finally()(_j(t), _j(y), ctx_ref, p))
    fin = dyn.make_finally()(_t(t), _t(y), ctx, p).numpy()
    np.testing.assert_array_equal(fin, fin_ref)


def _geo_y0(n, seed, kep=GEO_KEP):
    """[n, 9] states: the station-keeping template (from `kep`) with sma
    dispersed at 3 km 1-sigma (a circular orbit's r and v scaled)."""
    sc_ref, _ = _spacecraft(kep)
    y = np.tile(sc_ref.to_vector(), (n, 1))
    a = kep[0] + np.random.default_rng(seed).normal(0.0, 3.0, n)
    y[:, 0:3] *= (a / kep[0])[:, None]
    y[:, 3:6] *= np.sqrt(kep[0] / a)[:, None]
    return y


# An inclined GEO start whose node is well defined (inc 1 deg, the inc
# steering's sign fixed over the first hour: aop + ta runs from 120 to 135
# deg) for Config 4's dynamics, where the two packages take the same steps.
GEO_KEP_INCLINED = (42_164.0, 1e-5, 1.0, 163.0, 120.0, 0.0)
# The equatorial runs' envelope, as a multiple of the witness gap (the port
# against itself at tolerance 1e-10 and 0.99e-10 over the same 4 h).
WITNESS_MULTIPLE = 10.0


@pytest.fixture(scope="module")
def sk_runs():
    """Config 4's station-keeping Monte Carlo, 4 lanes from the same initial
    states (sma dispersed) through both packages with an f64 8x8 field
    (which keeps the split field's twin-vs-XLA f32 rounding out), one
    propagator each (the reference compiles once): from the exactly
    equatorial template over its first 4 h and 6 h; the port's 4 h again at
    tolerance 0.99e-10 (the witness); and from the inclined start over its
    first hour. Returns ({hours: (reference Results, port Results)}, the
    equatorial initial states, the port's dynamics, the witness Results,
    (reference, port) Results of the inclined hour)."""
    sc_ref, sc = _spacecraft(GEO_KEP)
    dyn_ref, dyn = _sk_dynamics("f64", sc_ref, sc)
    mc_ref = RMonteCarlo(RMvnSpacecraft(sc_ref, [RStateDispersion.zero_mean("sma", 3.0)]), seed=3)
    mc = MonteCarlo(MvnSpacecraft(sc, [StateDispersion.zero_mean("sma", 3.0)]), seed=3)
    prop_ref = RPropagator.rk89(dyn_ref, RIntegratorOptions(min_step_s=30.0, tolerance=1e-10))

    def run(y0, hours, tolerance=1e-10, reference=True):
        end = hours * 3600.0
        prop = Propagator.rk89(dyn, IntegratorOptions(min_step_s=30.0, tolerance=tolerance))
        res = mc.run_until_epoch(prop, Almanac(), sc.epoch + end, 4, device="cpu", _y0=y0)
        if not reference:
            return res
        return mc_ref.run_until_epoch(prop_ref, RAlmanac(), sc_ref.epoch + end, 4, _y0=_j(y0)), res

    y0 = _geo_y0(4, seed=41)
    runs = {hours: run(y0, hours) for hours in (4, 6)}
    witness = run(y0, 4, tolerance=0.99e-10, reference=False)
    inclined = run(_geo_y0(4, 41, GEO_KEP_INCLINED), 1)
    return runs, y0, dyn, witness, inclined


def _gaps(res_ref, res):
    yf, yf_ref = res.y_final, np.asarray(res_ref.y_final)
    return (np.linalg.norm(yf[:, :3] - yf_ref[:, :3], axis=1).max(),
            np.linalg.norm(yf[:, 3:6] - yf_ref[:, 3:6], axis=1).max(),
            np.abs(yf[:, 8] - yf_ref[:, 8]).max())


def test_station_keeping_run_matches_reference(sk_runs):
    """The 4-lane station-keeping runs, every lane done in both packages,
    starting in the template's mode (Thrust).

    On the inclined start over its first hour every lane thrusts
    throughout and both packages take the same steps (accepted and
    rejected counts equal, printed): positions within 1e-6 km, velocities
    1e-9 km/s, propellant 1e-12 kg.

    On the exactly equatorial template the step sequences part from the
    second step on: the orbit's node, and with it the sign of Ruggiero's
    inc steering, rests on differences of near-zero angular-momentum
    components, where the two packages' roundings differ (XLA contracts
    multiply-adds, torch does not), and so does each host's. Two runs on
    different step sequences differ by the integration error at 1e-10,
    which the witness measures: the port against itself at tolerance 1e-10
    and 0.99e-10 over the same 4 h. Over 4 h, before any lane meets its
    objectives, every lane thrusts throughout in both packages: final
    modes identical (Thrust), positions and velocities within
    WITNESS_MULTIPLE times the witness's gaps, propellant 1e-12 kg (the
    mass flow is constant while thrusting).

    By 6 h the lanes have met sma, ecc and inc (at ~4.3-4.5 h) and coast,
    thrusting for one 30 s floor step whenever ecc or inc drifts back out
    of its tolerance, so the final mode of a lane is the law's verdict on
    a state that sits on a tolerance edge. There each package's final mode
    is its own law's verdict on its final state, and the states agree
    within an envelope: positions 0.1 km, velocities 1e-5 km/s and
    propellant 1e-3 kg (a switch one floor step apart moves 3.3e-4 kg and
    ~0.02 km). Propellant was burned, within F t / (Isp g0). The measured
    gaps are printed."""
    runs, y0, dyn, witness, (inc_ref, inc) = sk_runs
    d_r, d_v, d_m = _gaps(inc_ref, inc)
    print(f"\ninclined start, 1 h, port vs reference: positions {d_r:.3e} km, velocities {d_v:.3e} km/s, "
          f"prop {d_m:.3e} kg; accepted steps {inc.n_accepted.tolist()} vs "
          f"{np.asarray(inc_ref.n_accepted).tolist()}, rejected {inc.n_rejected.tolist()} vs "
          f"{np.asarray(inc_ref.n_rejected).tolist()}")
    assert inc.n_ok == inc_ref.n_ok == 4
    np.testing.assert_array_equal(inc.n_accepted, np.asarray(inc_ref.n_accepted))
    np.testing.assert_array_equal(inc.n_rejected, np.asarray(inc_ref.n_rejected))
    assert d_r < 1e-6 and d_v < 1e-9 and d_m < 1e-12
    assert (inc.y_final[:, 9] == GuidanceMode.Thrust).all()
    np.testing.assert_array_equal(inc.y_final[:, 9], np.asarray(inc_ref.y_final)[:, 9])

    for hours, (res_ref, res) in runs.items():
        assert res.n_ok == res_ref.n_ok == 4
        assert res.y_final.shape == np.asarray(res_ref.y_final).shape == (4, 10)
        np.testing.assert_array_equal(res.y_initial[:, :9], y0)
        assert (res.y_initial[:, 9] == GuidanceMode.Thrust).all()
        d_r, d_v, d_m = _gaps(res_ref, res)
        print(f"{hours} h station keeping, port vs reference: positions {d_r:.3e} km, velocities "
              f"{d_v:.3e} km/s, prop {d_m:.3e} kg; accepted steps {res.n_accepted.tolist()} vs "
              f"{np.asarray(res_ref.n_accepted).tolist()}; final modes {res.y_final[:, 9].tolist()} vs "
              f"{np.asarray(res_ref.y_final)[:, 9].tolist()}")
        used = 1000.0 - res.y_final[:, 8]
        assert (used > 0.0).all()
        assert (used <= THRUSTER[0] / (THRUSTER[1] * STD_GRAVITY_M_S2) * hours * 3600.0 * (1 + 1e-12)).all()

    res_ref, res = runs[4]
    w_r, w_v, _ = _gaps(witness, res)
    d_r, d_v, d_m = _gaps(res_ref, res)
    print(f"4 h witness, the port at 1e-10 vs 0.99e-10: positions {w_r:.3e} km, velocities {w_v:.3e} km/s; "
          f"accepted steps {witness.n_accepted.tolist()}; port vs reference / witness: positions "
          f"{d_r / w_r:.2f}, velocities {d_v / w_v:.2f}")
    assert witness.n_ok == 4 and not np.array_equal(witness.n_accepted + witness.n_rejected,
                                                    res.n_accepted + res.n_rejected)
    assert d_r < WITNESS_MULTIPLE * w_r and d_v < WITNESS_MULTIPLE * w_v and d_m < 1e-12
    assert (res.y_final[:, 9] == GuidanceMode.Thrust).all()
    np.testing.assert_array_equal(res.y_final[:, 9], np.asarray(res_ref.y_final)[:, 9])

    res_ref, res = runs[6]
    d_r, d_v, d_m = _gaps(res_ref, res)
    assert d_r < 0.1 and d_v < 1e-5 and d_m < 1e-3
    ctx = dyn.build_context(res.end_epoch, 0.0, Almanac(), device="cpu")
    for r in (res, res_ref):
        y = _t(np.asarray(r.y_final))
        verdict = dyn.guidance.next_mode(ctx, torch.zeros(4, dtype=torch.float64), y[:, :9], y[:, 9])
        np.testing.assert_array_equal(verdict.numpy(), y[:, 9].numpy())


def test_results_final_values_of(sk_runs):
    """Results.final_values_of and dispersion_values_of for sma, ecc and inc
    on the reference's final states: 1e-12 relative."""
    res_ref, res = sk_runs[0][6]
    yf_ref = np.asarray(res_ref.y_final)
    port = Results(res.epoch0, res.end_epoch, res.template, yf_ref, res.status, res.n_accepted,
                   res.n_rejected, device="cpu")
    for p in ("sma", "ecc", "inc"):
        np.testing.assert_allclose(port.final_values_of(p), np.asarray(res_ref.final_values_of(p)),
                                   rtol=F64, atol=1e-15)
        np.testing.assert_allclose(port.dispersion_values_of(p), res_ref.dispersion_values_of(p),
                                   rtol=1e-9, atol=1e-15)


def _leo_guided(M, per_lane):
    """(spacecraft, propagator) of tests/test_propulsion.py:232-283: a LEO
    raise with sma and inc objectives on two-body dynamics."""
    epoch = M.Epoch.from_gregorian_utc(2020, 1, 1)
    eme = M.Frames.EME2000.with_mu_km3_s2(398_600.433) if M is R else \
        Frame(NAIF.EARTH, mu_km3_s2=398_600.433)
    orbit = M.Orbit.keplerian(7378.1363, 0.05, 28.5, 30.0, 40.0, 1.0, epoch, eme)
    Thr, GM = (RThruster, RGuidanceMode) if M is R else (Thruster, GuidanceMode)
    sc = M.Spacecraft.from_thruster(orbit, 250.0, 50.0, Thr(5.0, 1650.0), GM.Thrust)
    Obj, SP = (RObjective, RStateParameter) if M is R else (Objective, StateParameter)
    objs = [Obj.within_tolerance(SP.SMA, 7500.0, 1.0), Obj.within_tolerance(SP.INC, 27.0, 0.01)]
    Rug, OD, SD, Prop, Opt = ((RRuggiero, ROrbitalDynamics, RSpacecraftDynamics, RPropagator,
                               RIntegratorOptions) if M is R else
                              (Ruggiero, OrbitalDynamics, SpacecraftDynamics, Propagator, IntegratorOptions))
    law = Rug.from_ctx_thresholds(objs, sc) if per_lane is None else Rug.from_thresholds(objs, per_lane, sc)
    dyn = SD.from_guidance_law(OD.two_body(eme), law)
    return sc, Prop.rk89(dyn, Opt(max_step_s=60.0))


def test_per_lane_guidance_params():
    """Per-lane efficiency thresholds through `guidance_params` [3, 2]: each
    lane equals the static-threshold law run alone (1e-9 km, the
    reference's own bound, tests/test_propulsion.py:274-277), the lanes
    differ, and the batch matches the reference's batch: propellant to
    1e-12 kg, the same modes, positions to 1e-5 km. (A lane's steering
    jumps where an efficiency crosses its threshold; each package's step
    controller resolves the jump with its own step boundaries, about a
    millisecond apart, which at 1.7e-5 km/s^2 of thrust moves the final
    position by millimetres.) A shared [2] row runs too."""
    thr = np.array([[0.0, 0.0], [0.3, 0.5], [0.9, 0.2]])
    end_s = 1800.0
    sc, prop = _leo_guided(P, None)
    mvn = MvnSpacecraft(sc, [StateDispersion.zero_mean("sma", 0.0)])
    y0 = np.tile(sc.to_vector(), (3, 1))
    res = MonteCarlo(mvn, seed=1).run_until_epoch(prop, Almanac(), sc.epoch + end_s, 3, device="cpu",
                                                  guidance_params=thr, _y0=y0)
    assert res.n_ok == 3
    for k in range(3):
        sc_k, prop_k = _leo_guided(P, list(thr[k]))
        res_k = MonteCarlo(mvn, seed=1).run_until_epoch(prop_k, Almanac(), sc.epoch + end_s, 1,
                                                        device="cpu", _y0=y0[:1])
        np.testing.assert_allclose(res.y_final[k], res_k.y_final[0], rtol=0, atol=1e-9)
    assert not np.allclose(res.y_final[0], res.y_final[2], atol=1e-6)

    sc_ref, prop_ref = _leo_guided(R, None)
    res_ref = RMonteCarlo(RMvnSpacecraft(sc_ref, [RStateDispersion.zero_mean("sma", 0.0)]), seed=1) \
        .run_until_epoch(prop_ref, RAlmanac(), sc_ref.epoch + end_s, 3, _y0=_j(y0), guidance_params=thr)
    yf_ref = np.asarray(res_ref.y_final)
    d_r = np.linalg.norm(res.y_final[:, :3] - yf_ref[:, :3], axis=1).max()
    d_m = np.abs(res.y_final[:, 8] - yf_ref[:, 8]).max()
    print(f"\nper-lane thresholds, port vs reference: positions {d_r:.3e} km, prop {d_m:.3e} kg, "
          f"accepted steps {res.n_accepted.tolist()} vs {np.asarray(res_ref.n_accepted).tolist()}")
    assert d_r < 1e-5 and d_m < 1e-12
    np.testing.assert_array_equal(res.y_final[:, 9], yf_ref[:, 9])

    shared = MonteCarlo(mvn, seed=1).run_until_epoch(prop, Almanac(), sc.epoch + 600.0, 3, device="cpu",
                                                     guidance_params=thr[1], _y0=y0)
    assert shared.n_ok == 3 and np.isfinite(shared.y_final).all()


def test_guided_propagator_sma_raise():
    """A closed-loop sma raise through Propagator.with_state(...).for_duration
    (tests/test_propulsion.py:66-90 scaled down: +20 km with 5 N on 300 kg,
    about 600 s of thrust, over 30 min): the objective is met and the mode
    is Coast, propellant burned within F t / (Isp g0), and the final state
    matches the reference's run of the same scene: the same mode,
    positions to 1e-5 km, propellant to 1e-6 kg. (The throttle drops from
    1 to 0 where the smooth gate reaches zero; each package's controller
    resolves that cut with its own step boundaries, which moves the burn's
    end by microseconds: 45 us and 1e-6 km on this scene.)"""
    out = []
    for M, Thr, GM, Obj, SP, Rug, OD, SD, Prop, Opt in (
        (R, RThruster, RGuidanceMode, RObjective, RStateParameter, RRuggiero, ROrbitalDynamics,
         RSpacecraftDynamics, RPropagator, RIntegratorOptions),
        (P, Thruster, GuidanceMode, Objective, StateParameter, Ruggiero, OrbitalDynamics,
         SpacecraftDynamics, Propagator, IntegratorOptions),
    ):
        epoch = M.Epoch.from_gregorian_utc(2020, 1, 1)
        eme = M.Frames.EME2000.with_mu_km3_s2(398_600.433) if M is R else \
            Frame(NAIF.EARTH, mu_km3_s2=398_600.433)
        orbit = M.Orbit.keplerian(7378.1363, 0.01, 28.5, 0.0, 0.0, 1.0, epoch, eme)
        sc = M.Spacecraft.from_thruster(orbit, 250.0, 50.0, Thr(5.0, 1650.0), GM.Thrust)
        law = Rug.simple([Obj.within_tolerance(SP.SMA, 7400.0, 1.0)], sc)
        prop = Prop.rk89(SD.from_guidance_law(OD.two_body(eme), law), Opt(max_step_s=60.0))
        inst = prop.with_state(sc) if M is R else prop.with_state(sc, device="cpu")
        out.append((sc, inst.for_duration(1800.0)))
    (sc_ref, fin_ref), (sc, fin) = out
    assert abs(fin.orbit.sma_km - 7400.0) < 2.0, fin.orbit.sma_km
    assert fin.mode == GuidanceMode.Coast == fin_ref.mode
    burned = sc.prop_mass_kg - fin.prop_mass_kg
    assert 0.0 < burned < 5.0 / (1650.0 * STD_GRAVITY_M_S2) * 1800.0
    d_r = np.linalg.norm(fin.orbit.r_km - fin_ref.orbit.r_km)
    d_m = abs(fin.prop_mass_kg - fin_ref.prop_mass_kg)
    print(f"\nsma raise, port vs reference: position {d_r:.3e} km, prop {d_m:.3e} kg")
    assert d_r < 1e-5 and d_m < 1e-6
    assert fin.thruster == sc.thruster and fin.epoch == sc.epoch + 1800.0


def test_guidance_configuration_errors():
    """The law's and the dynamics' configuration checks."""
    _, sc = _spacecraft(GEO_KEP)
    with pytest.raises(GuidanceConfigError):
        Ruggiero.simple([], sc)
    with pytest.raises(GuidanceConfigError):
        Ruggiero.simple([Objective.within_tolerance(StateParameter.TA, 10.0, 1.0)], sc)
    law = Ruggiero.from_ctx_thresholds(_objectives(P, ("sma",)), sc)
    dyn = SpacecraftDynamics.from_guidance_law(OrbitalDynamics.two_body(), law)
    with pytest.raises(ConfigError):  # guided, with the STM or without, needs the thruster
        dyn.make_eom(with_stm=True)
    with pytest.raises(ConfigError):
        dyn.make_eom()
    y = _t([np.concatenate([sc.to_vector(), [1.0]])])
    with pytest.raises(GuidanceConfigError):
        dyn.make_eom(thruster=sc.thruster)(torch.zeros(1), y, SimpleNamespace(
            frame=P.Frames.EME2000, guidance_params=None, epoch0_tdb=0.0), {
            "dry_mass_kg": 1000.0, "srp_area_m2": 0.0, "drag_area_m2": 0.0})


def test_spacecraft_orbit_and_dynamics_accessors():
    """Spacecraft.value_of (mode, masses, thruster, elements), Orbit.ecc /
    inc_deg / value against the reference (1e-12), the Objective's angle
    wrap, and the guided dynamics' shape queries."""
    sc_ref, sc = _spacecraft(GTO_KEP, mode=RGuidanceMode.Inhibit)
    for p in ("guidance_mode", "dry_mass", "total_mass", "isp_s", "thrust_n", "sma", "ecc", "inc",
              "raan", "aop", "prop_mass"):
        assert sc.value_of(p) == pytest.approx(sc_ref.value_of(p), rel=F64, abs=1e-15), p
    assert sc.total_mass_kg == 2000.0 and sc.value_of("guidance_mode") == 2.0
    assert sc.thruster.exhaust_velocity_m_s == pytest.approx(4435.0 * STD_GRAVITY_M_S2)
    assert sc.orbit.ecc == pytest.approx(sc_ref.orbit.ecc, rel=F64)
    assert sc.orbit.inc_deg == pytest.approx(sc_ref.orbit.inc_deg, rel=F64)
    assert sc.orbit.value("aop") == pytest.approx(sc_ref.orbit.value("aop"), rel=F64)
    obj, obj_ref = (Objective.within_tolerance(StateParameter.RAAN, 359.95, 0.1),
                    RObjective.within_tolerance(RStateParameter.RAAN, 359.95, 0.1))
    for achieved in (0.02, 359.0, 10.0):
        ok, err = obj.assess_raw(achieved)
        ok_ref, err_ref = obj_ref.assess_raw(achieved)
        assert ok == ok_ref and err == pytest.approx(err_ref, abs=1e-12)
    assert obj.assess_raw(0.02)[0]
    _, dyn = _sk_dynamics("split", *_spacecraft(GEO_KEP))
    assert dyn.has_guidance and dyn.state_dim() == 10 and dyn.state_dim(True) == 91
    assert not dyn.with_guidance_law(None).has_guidance
    assert dyn.with_guidance_law(None).state_dim() == 9


@pytest.mark.parametrize("kep", [GEO_KEP, (42_165.0, 1e-3, 0.05, 163.0, 75.0, 0.0)])
def test_ruggiero_achieved_and_status(kep):
    """The host-side verdicts on Config 4's objectives, at its start (not
    achieved) and on target: the same flag and status lines as the
    reference's."""
    sc_ref, sc = _spacecraft(kep)
    law_ref = RRuggiero.from_max_eclipse(_objectives(R, ("sma", "ecc", "inc")), sc_ref, 0.2)
    law = Ruggiero.from_max_eclipse(_objectives(P, ("sma", "ecc", "inc")), sc, 0.2)
    assert law.achieved(sc) == law_ref.achieved(sc_ref) == (kep != GEO_KEP)
    assert law.status(sc) == law_ref.status(sc_ref)
