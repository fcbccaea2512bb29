"""Mission-design parity: the port's state-carried STM, finite burns and the
Kluever, replay and parametric laws, the guided EOM with the STM, the
B-plane, Brouwer's mean elements, the targeter in its FD, dual and
finite-burn modes, multiple shooting, the impulsive-to-finite conversion,
mission sequences and Lambert porkchops against nyx_tpu.

The scenes are the reference's own tests' (tests/test_targeting.py,
test_lambert.py, test_sequence.py, test_propulsion.py:93-230). Inputs come
from numpy (seeded where random) and reach both packages unchanged; JAX runs
on the CPU in float64, the port on CPU tensors (`device="cpu"`).

Tolerances, each stated at its test: 1e-12 where both packages evaluate the
same float64 formulas once (guidance laws, the guided STM EOM); 1e-10
relative for the closed forms with more rounding (Brouwer's mapping, the
B-plane, Lambert's Householder iterations); whole propagations and the
solves built on them are held to the envelope measured here and printed
with `-s`: both packages take the same steps on these two-body scenes, so
the gaps sit near rounding, but a step taken at a burn's edge (found by
rejecting steps) may differ, which is why corrections are compared within a
tolerance and not by iteration path.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nyx_tpu as R
import nyx_tpu.cosmic.bplane as RB
import nyx_tpu.dynamics as RD
import nyx_tpu.dynamics.guidance as RGd
import nyx_tpu.md.opti as RO
import nyx_tpu.md.opti.multishoot as RMS
import nyx_tpu.tools as RT
from nyx_tpu.constants import NAIF, STD_GRAVITY_M_S2
from nyx_tpu.cosmic.orbit import keplerian_propagate as r_keplerian_propagate
from nyx_tpu.cosmic.spacecraft import GuidanceMode as RGuidanceMode
from nyx_tpu.cosmic.spacecraft import Thruster as RThruster
from nyx_tpu.dynamics.orbital import EomContext as REomContext
from nyx_tpu.ephem.almanac import Almanac as RAlmanac
from nyx_tpu.md.objective import Objective as RObjective
from nyx_tpu.md.param import value as r_value
from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
from nyx_tpu.propagators import Propagator as RPropagator

import nyx_tpu_torch as P
import nyx_tpu_torch.cosmic.bplane as PB
import nyx_tpu_torch.dynamics as PD
import nyx_tpu_torch.md.opti as PO
import nyx_tpu_torch.md.opti.multishoot as PMS
import nyx_tpu_torch.tools as PT
from nyx_tpu_torch.cosmic.orbit import keplerian_propagate
from nyx_tpu_torch.cosmic.spacecraft import GuidanceMode, Thruster
from nyx_tpu_torch.dynamics.orbital import EomContext
from nyx_tpu_torch.ephem import Almanac
from nyx_tpu_torch.errors import ConfigError, LambertError, StateError, TargetingError
from nyx_tpu_torch.md.objective import Objective
from nyx_tpu_torch.md.param import value
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator, integrator

EPOCH = (2020, 1, 1)
MU = R.Frames.EME2000.mu
BROUWER = ("sma", "ecc", "inc", "raan", "aop", "ma")


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _j(x):
    return jnp.asarray(np.asarray(x), jnp.float64)


def _epoch(M):
    return M.Epoch.from_gregorian_utc(*EPOCH)


def _two_body(M, **opts):
    dyn = (RD if M is R else PD).SpacecraftDynamics.new((RD if M is R else PD).OrbitalDynamics.two_body(
        M.Frames.EME2000))
    return (RPropagator if M is R else Propagator).rk89(
        dyn, (RIntegratorOptions if M is R else IntegratorOptions)(**opts))


def _with(prop, M, sc):
    return prop.with_state(sc) if M is R else prop.with_state(sc, device="cpu")


def _close(a, b, rtol, atol=0.0):
    """Max |a - b| / (|b| + atol / rtol) <= rtol, NaN cells equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    np.testing.assert_allclose(a[ok], b[ok], rtol=rtol, atol=atol)


# ------------------------------------------------------------------ states
def _states(kind, n=6, seed=0):
    """[n, 9] states from Keplerian elements drawn from a seed: LEO, GEO, or
    hyperbolic (e 1.2-3, sma < 0)."""
    rng = np.random.default_rng(seed)
    if kind == "leo":
        el = [rng.uniform(6800, 7500, n), rng.uniform(1e-3, 0.05, n), rng.uniform(10, 98, n)]
    elif kind == "geo":
        el = [np.full(n, 42_164.0), rng.uniform(1e-5, 1e-3, n), rng.uniform(0.1, 5.0, n)]
    else:
        e = rng.uniform(1.2, 3.0, n)
        el = [-rng.uniform(8_000, 50_000, n), e, rng.uniform(10, 80, n)]
    el += [rng.uniform(0, 360, n), rng.uniform(0, 360, n)]
    el.append(rng.uniform(-60, 60, n) if kind == "hyp" else rng.uniform(0, 360, n))
    from nyx_tpu_torch.cosmic.orbit import cartesian_from_keplerian

    r, v = cartesian_from_keplerian(*(_t(el[k] if k < 2 else np.radians(el[k])) for k in range(6)), MU)
    return np.concatenate([r.numpy(), v.numpy(), np.zeros((n, 3))], axis=1)


@pytest.mark.parametrize("kind", ["leo", "geo", "hyp"])
def test_brouwer_and_bplane_parameters_match_reference(kind):
    """param.value of the six Brouwer mean-short elements and B.R, B.T and
    the linearized time of flight, lane by lane, at 1e-10 relative (NaN where
    both are undefined: Brouwer on a hyperbola, the B-plane on an ellipse;
    the linearized time of flight, B.S / |v|, is zero up to rounding, so it
    is held to 1e-10 s absolute); their Jacobians by torch.func.jacfwd
    against jax.jacfwd at 1e-8."""
    y = _states(kind)
    params = [f"brouwer_mean_short_{k}" for k in BROUWER] + ["bdot_r", "bdot_t", "b_ltof"]
    for p in params:
        got = value(p, _t(y), MU, 6378.1363).numpy()
        ref = np.asarray(r_value(p, _j(y), MU, 6378.1363))
        _close(got, ref, 1e-10, atol=1e-10 if p == "b_ltof" else 1e-12)
    defined = params[:6] if kind != "hyp" else params[6:8]
    jac = torch.func.jacfwd(lambda yy: torch.stack([value(p, yy, MU, 6378.1363) for p in defined]))(_t(y[0]))
    rjac = jax.jit(jax.jacfwd(lambda yy: jnp.stack([r_value(p, yy, MU, 6378.1363) for p in defined])))(_j(y[0]))
    for row, rrow in zip(jac.numpy(), np.asarray(rjac)):
        np.testing.assert_allclose(row, rrow, rtol=1e-8, atol=1e-12 * np.abs(rrow).max())


def test_orbit_at_epoch_and_anomalies_match_reference():
    """`Orbit.at_epoch` (20 fixed Newton iterations of Kepler's equation)
    and `keplerian_propagate` over elliptic orbits up to e = 0.9 and spans of
    a minute to ten days, at 1e-9 km and 1e-12 km/s."""
    rng = np.random.default_rng(3)
    y = np.concatenate([_states("leo", 4, 1), _states("geo", 2, 2)])
    y[0, 3:6] *= 1.35  # e ~ 0.8
    dts = rng.uniform(60.0, 864_000.0, len(y))
    r, v = keplerian_propagate(_t(y[:, 0:3]), _t(y[:, 3:6]), MU, _t(dts))
    rr, rv = r_keplerian_propagate(_j(y[:, 0:3]), _j(y[:, 3:6]), MU, _j(dts))
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0, atol=1e-12)
    e0 = _epoch(P)
    for row, dt in zip(y, dts):
        got = P.Orbit(row[0:3], row[3:6], e0, P.Frames.EME2000).at_epoch(e0 + float(dt))
        ref = R.Orbit(row[0:3], row[3:6], _epoch(R), R.Frames.EME2000).at_epoch(_epoch(R) + float(dt))
        assert np.abs(got.r_km - ref.r_km).max() < 1e-9
        assert got.epoch.to_tai_seconds() == ref.epoch.to_tai_seconds()


# ------------------------------------------------------------------ B-plane
DAVIS = (546507.344255845, -527978.380486028, 531109.066836708,
         -4.9220589268733, 5.36316523097915, -5.22166308425181)


def test_bplane_davis_matches_reference():
    """Davis' case (tests/test_targeting.py:24-52): B.T, B.R, the frame and
    the Jacobian's B.R and B.T rows at 1e-10 relative, the linearized time
    of flight and its row (zero up to rounding) at 1e-10 absolute, and the
    targeting delta-v and achieved plane at 1e-12 of the reference's."""
    orbits = [M.Orbit.cartesian(*DAVIS, M.Epoch.from_gregorian_utc(2016, 1, 1), M.Frames.EME2000) for M in (R, P)]
    ref, got = RB.BPlane.from_orbit(orbits[0]), PB.BPlane.from_orbit(orbits[1])
    assert abs(got.b_t_km - 45892.323790) < 1e-4 and abs(got.b_r_km - 10606.210428) < 1e-4
    for k in ("b_r_km", "b_t_km", "str_dcm"):
        _close(getattr(got, k), getattr(ref, k), 1e-10, atol=1e-14)
    _close(got.jacobian_rv[:2], ref.jacobian_rv[:2], 1e-10, atol=1e-10 * np.abs(ref.jacobian_rv).max())
    # the linearized time of flight, B.S / |v|, and its row are zero up to rounding
    _close([got.ltof_s, *got.jacobian_rv[2]], [ref.ltof_s, *ref.jacobian_rv[2]], 0.0, atol=1e-10)
    target = (13135.7982982557, 5022.26511510685)
    dv_r, bp_r = RB.try_achieve_b_plane(orbits[0], RB.BPlaneTarget.from_bt_br(*target))
    dv_p, bp_p = PB.try_achieve_b_plane(orbits[1], PB.BPlaneTarget.from_bt_br(*target))
    np.testing.assert_allclose(dv_p, dv_r, rtol=0, atol=1e-12)
    assert abs(bp_p.b_t_km - bp_r.b_t_km) < 1e-9 and abs(bp_p.b_r_km - bp_r.b_r_km) < 1e-9
    with pytest.raises(StateError):
        PB.BPlane.from_orbit(P.Orbit.keplerian(7000.0, 0.01, 30.0, 0, 0, 0, _epoch(P), P.Frames.EME2000))


# ------------------------------------------------------------------ guidance
def _laws(M):
    """Every new law, built alike in both packages; the burns straddle the
    lanes' times (see _lane_inputs)."""
    D = RD if M is R else PD
    Obj = RObjective if M is R else Objective
    e0 = _epoch(M)
    LF = D.LocalFrame
    fixed = D.Maneuver.from_time_invariant(e0 + 100.0, e0 + 400.0, 0.7, [0.3, 0.9, -0.2], LF.VNC)
    angles = D.Maneuver(e0 + 50.0, e0 + 300.0, 0.9, azimuth_poly=np.array([2e-6, 0.001, 0.1]),
                        elevation_poly=np.array([-0.0005, 0.05]), frame=LF.RCN)
    rate = D.Maneuver(e0 + 0.0, e0 + 500.0, 1.0, vector=np.array([1.0, 0.1, 0.0]),
                      vector_rate=np.array([1e-4, -2e-4, 3e-4]), vector_accel=np.array([0.0, 1e-7, -1e-7]),
                      frame=LF.RIC)
    seq = D.ManeuverSequence((
        D.Maneuver.from_time_invariant(e0 + 300.0, e0 + 450.0, 0.5, [0.0, 1.0, 0.0], LF.VNC),
        D.Maneuver.from_time_invariant(e0 + 100.0, e0 + 250.0, 1.0, [1.0, 0.0, 0.0], LF.VNC),
    ))
    kluever = D.Kluever.new([Obj.within_tolerance("sma", 7200.0, 1.0), Obj.within_tolerance("ecc", 0.01, 1e-4),
                             Obj.within_tolerance("inc", 40.0, 0.01), Obj.within_tolerance("raan", 50.0, 0.1)],
                            [1.0, 0.5, 0.8, 0.3])
    ts = [e0 + float(k) for k in (0.0, 120.0, 250.0, 260.0, 490.0)]
    dirs = np.array([[1, 0, 0], [0.6, 0.8, 0], [0, 1, 0], [0, 0.6, 0.8], [0, 0, 1.0]])
    replay = D.ThrustDirectionReplay.from_samples(ts, dirs, [1.0, 0.5, 0.5, 0.8, 0.2])
    return dict(fixed=fixed, angles=angles, rate=rate, seq=seq, kluever=kluever, replay=replay,
                parametric=(RGd if M is R else PD).ParametricManeuver(frame=LF.VNC))


def _lane_inputs(B=16, seed=5):
    """(y9 [B, 9], t_tdb [B], mode [B], per-lane parametric parameters
    [B, 12]): LEO states, times 0-600 s past the epoch (so across every
    burn's edges, both exactly), every mode, and parameters that differ
    lane by lane."""
    rng = np.random.default_rng(seed)
    y9 = _states("leo", B, seed)
    y9[:, 8] = rng.uniform(10, 100, B)
    t0 = R.Epoch.from_gregorian_utc(*EPOCH).to_tdb_seconds()
    t = t0 + rng.uniform(0.0, 600.0, B)
    t[:4] = t0 + np.array([100.0, 400.0, 300.0, 250.0])  # burn edges
    mode = rng.integers(0, 3, B).astype(np.float64)
    params = np.concatenate([
        t0 + rng.uniform(0, 200, (B, 1)), t0 + rng.uniform(300, 600, (B, 1)), rng.uniform(0.1, 1.0, (B, 1)),
        rng.normal(size=(B, 3)), rng.normal(size=(B, 3)) * 1e-3, rng.normal(size=(B, 3)) * 1e-6,
    ], axis=1)
    return y9, t, mode, params


@pytest.mark.parametrize("law", ["fixed", "angles", "rate", "seq", "kluever", "replay", "parametric"])
def test_guidance_law_hooks_match_reference(law):
    """direction_and_throttle and next_mode of every new law on 16 lanes, at
    burn edges and with every mode, at 1e-12 (the same float64 formulas);
    the parametric law with parameters that differ lane by lane. The
    reference's vector-rate Maneuver broadcasts its rate against the lane
    axis, so that law is compared lane by lane (B = 1)."""
    y9, t, mode, params = _lane_inputs()
    ref_law, law_p = _laws(R)[law], _laws(P)[law]
    ctx_r = REomContext(epoch0_tdb=0.0, table=None, frame=R.Frames.EME2000, guidance_params=_j(params))
    ctx_p = EomContext(epoch0_tdb=0.0, table=None, frame=P.Frames.EME2000, guidance_params=_t(params))
    lanes = [slice(i, i + 1) for i in range(len(t))] if law == "rate" else [slice(None)]
    for sl in lanes:
        cr = replace(ctx_r, guidance_params=ctx_r.guidance_params[sl])
        cp = replace(ctx_p, guidance_params=ctx_p.guidance_params[sl])
        u_r, thr_r = ref_law.direction_and_throttle(cr, _j(t[sl]), _j(y9[sl]), _j(mode[sl]))
        u_p, thr_p = law_p.direction_and_throttle(cp, _t(t[sl]), _t(y9[sl]), _t(mode[sl]))
        np.testing.assert_allclose(u_p.numpy(), np.asarray(u_r), rtol=0, atol=1e-12)
        np.testing.assert_allclose(thr_p.numpy(), np.asarray(thr_r), rtol=0, atol=1e-12)
        m_r = ref_law.next_mode(cr, _j(t[sl]), _j(y9[sl]), _j(mode[sl]))
        m_p = law_p.next_mode(cp, _t(t[sl]), _t(y9[sl]), _t(mode[sl]))
        np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_r))
    if law == "parametric":
        assert len(set(np.round(thr_p.numpy(), 12))) > 4  # the lanes' levels differ


def test_impulsive_maneuver_matches_reference():
    """ImpulsiveManeuver.apply in each local frame, at 1e-15 km/s."""
    y = _states("leo", 1, 9)[0]
    for frame in ("vnc", "ric", "rcn", "inertial"):
        out = []
        for M, D in ((R, RD), (P, PD)):
            sc = M.Spacecraft.from_orbit(M.Orbit(y[0:3], y[3:6], _epoch(M), M.Frames.EME2000))
            out.append(D.ImpulsiveManeuver(np.array([0.1, -0.02, 0.03]), frame).apply(sc).orbit.v_km_s)
        np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-15)


@pytest.mark.parametrize("law", ["parametric", "kluever", "fixed"])
def test_guided_stm_eom_matches_reference(law):
    """The guided EOM with the STM ([B, 91]: state, Phi, mode) against the
    reference's at 1e-12 relative to each block's scale, on lanes with
    different guidance parameters, modes and times; and against the same
    EOM one lane at a time, which holds the folded tangents' lane order
    (tiled, not interleaved) bit for bit."""
    y9, t, mode, params = _lane_inputs(B=6, seed=11)
    rng = np.random.default_rng(12)
    phi = np.eye(9)[None] + 0.01 * rng.normal(size=(6, 9, 9))
    y = np.concatenate([y9, phi.reshape(6, 81), mode[:, None]], axis=1)
    sc_p = dict(dry_mass_kg=500.0, srp_area_m2=0.0, drag_area_m2=0.0)
    out = {}
    for M, D, Ctx, conv in ((R, RD, REomContext, _j), (P, PD, EomContext, _t)):
        dyn = D.SpacecraftDynamics.from_guidance_law(D.OrbitalDynamics.two_body(M.Frames.EME2000), _laws(M)[law])
        thr = (RThruster if M is R else Thruster)(thrust_N=20.0, isp_s=300.0)
        eom = dyn.make_eom(True, thruster=thr)
        if M is R:
            eom = jax.jit(eom)
        ctx = Ctx(epoch0_tdb=0.0, table=None, frame=M.Frames.EME2000, guidance_params=conv(params))
        out[M] = np.asarray(eom(conv(t), conv(y), ctx, sc_p))
        if M is P:
            lanes = [eom(conv(t[i:i + 1]), conv(y[i:i + 1]), replace(ctx, guidance_params=conv(params[i:i + 1])),
                         sc_p).numpy() for i in range(6)]
    got, ref = out[P], out[R]
    assert got.shape == (6, 91)
    for blk in (slice(0, 9), slice(9, 90)):
        scale = np.abs(ref[:, blk]).max(axis=1, keepdims=True)
        assert (np.abs(got[:, blk] - ref[:, blk]) / scale).max() < 1e-12
    np.testing.assert_array_equal(got, np.concatenate(lanes))
    assert not np.allclose(got[0, 9:90], got[1, 9:90])


# ------------------------------------------------------------------ propagation
def _thruster_sc(M, orbit_el, dry, prop, thrust, isp, mode, epoch_offset=0.0):
    e0 = _epoch(M) + epoch_offset
    orbit = M.Orbit.keplerian(*orbit_el, e0, M.Frames.EME2000)
    thr = (RThruster if M is R else Thruster)(thrust_N=thrust, isp_s=isp)
    return M.Spacecraft.from_thruster(orbit, dry, prop, thr, mode=mode)


def test_finite_burn_rocket_equation_matches_reference():
    """test_propulsion.py:93-125: a 600 s prograde VNC burn at 10 N / 300 s
    meets the rocket equation within 1e-6 kg in both packages, the port's
    final state within 1e-9 km of the reference's; after the window the mode
    is Coast and the mass constant."""
    fin = {}
    for M, D in ((R, RD), (P, PD)):
        sc = _thruster_sc(M, (8000.0, 0.0, 0.0, 0.0, 0.0, 0.0), 500.0, 100.0, 10.0, 300.0,
                          (RGuidanceMode if M is R else GuidanceMode).Coast)
        mnvr = D.Maneuver.from_time_invariant(sc.epoch, sc.epoch + 600.0, 1.0, [1.0, 0.0, 0.0], D.LocalFrame.VNC)
        dyn = D.SpacecraftDynamics.from_guidance_law(D.OrbitalDynamics.two_body(M.Frames.EME2000), mnvr)
        opts = (RIntegratorOptions if M is R else IntegratorOptions)(max_step_s=30.0)
        inst = _with((RPropagator if M is R else Propagator).rk89(dyn, opts), M, sc)
        f1 = inst.for_duration(600.0)
        f2 = inst.for_duration(600.0)
        expected = sc.total_mass_kg - 10.0 / (300.0 * STD_GRAVITY_M_S2) * 600.0
        assert abs(f1.total_mass_kg - expected) < 1e-6
        assert f2.mode == GuidanceMode.Coast and abs(f2.total_mass_kg - f1.total_mass_kg) < 1e-12
        fin[M] = f2
    d = np.abs(fin[P].orbit.r_km - fin[R].orbit.r_km).max()
    print(f"\nrocket equation run, port vs reference: {d:.3e} km")
    assert d < 1e-9


def test_kluever_closed_loop_matches_reference():
    """test_propulsion.py:170-184: Kluever on inclination alone lowers it
    over an hour of thrust; the port's final state within 1e-5 km (measured
    2.4e-6 km: the law's sign switches at the nodes fall mid-step) and its
    mass within 1e-9 kg of the reference's."""
    fin = {}
    for M, D in ((R, RD), (P, PD)):
        Obj = RObjective if M is R else Objective
        sc = _thruster_sc(M, (8000.0, 0.001, 28.5, 10.0, 0.0, 0.0), 300.0, 100.0, 10.0, 1500.0,
                          (RGuidanceMode if M is R else GuidanceMode).Thrust)
        law = D.Kluever.new([Obj.within_tolerance("inc", 28.0, 0.01)], [1.0])
        dyn = D.SpacecraftDynamics.from_guidance_law(D.OrbitalDynamics.two_body(M.Frames.EME2000), law)
        opts = (RIntegratorOptions if M is R else IntegratorOptions)(max_step_s=60.0)
        fin[M] = _with((RPropagator if M is R else Propagator).rk89(dyn, opts), M, sc).for_duration(3600.0)
        assert fin[M].orbit.inc_deg < sc.orbit.inc_deg - 0.05
    d = np.abs(fin[P].orbit.r_km - fin[R].orbit.r_km).max()
    dm = abs(fin[P].prop_mass_kg - fin[R].prop_mass_kg)
    print(f"\nKluever hour, port vs reference: {d:.3e} km, {dm:.3e} kg")
    assert d < 1e-5 and dm < 1e-9


def test_stm_over_one_orbit_matches_reference_and_central_differences():
    """`with_stm()` over one orbit of the targeter's LEO under a 4x4 JGM3
    field at f64: the port's STM within 1e-9 relative of the reference's
    (the same steps), and within 1e-5 relative of central differences of the
    same propagation (steps 1e-2 km, 1e-5 km/s) on the entries of at least a
    tenth of the largest; Cr, Cd and the mass keep their identity rows."""
    from nyx_tpu.io.gravity import GravityFieldData as RG
    from nyx_tpu_torch.io.gravity import GravityFieldData as PG

    jgm3 = "data/JGM3.cof.gz"
    out = {}
    for M, D, G in ((R, RD, RG), (P, PD, PG)):
        field = D.Harmonics.from_stor(G.from_cof(jgm3, 4, 4, True, M.Frames.IAU_EARTH))
        dyn = D.SpacecraftDynamics.new(D.OrbitalDynamics.from_model(field, M.Frames.EME2000))
        prop = (RPropagator if M is R else Propagator).rk89(
            dyn, (RIntegratorOptions if M is R else IntegratorOptions)(tolerance=1e-10))
        leo = M.Spacecraft.from_orbit(M.Orbit.keplerian(7378.1363, 0.01, 28.5, 10.0, 5.0, 0.0, _epoch(M),
                                                        M.Frames.EME2000))
        out[M] = (_with(prop, M, leo.with_stm()).for_duration(leo.orbit.period_s), prop, leo)
    phi, ref = out[P][0].stm, out[R][0].stm
    assert (np.abs(phi - ref) / np.abs(ref).max()).max() < 1e-9
    np.testing.assert_array_equal(phi[6:, 6:], np.eye(3))
    _, prop, leo = out[P]
    steps = np.array([1e-2] * 3 + [1e-5] * 3)
    y = leo.to_vector()
    # the 12 perturbed states as lanes of one propagation
    rows = np.stack([y + s * steps[j] * np.eye(9)[j] for j in range(6) for s in (1.0, -1.0)])
    dyn = prop.dynamics
    ends = integrator.propagate(dyn.make_eom(), _t(rows), leo.orbit.period_s, prop.opts, prop.method,
                                finally_fn=dyn.make_finally(),
                                eom_args=(dyn.build_context(leo.epoch, leo.orbit.period_s, None, device="cpu"),
                                          dict(dry_mass_kg=0.0, srp_area_m2=0.0, drag_area_m2=0.0))).y.numpy()
    jac = np.stack([(ends[2 * j] - ends[2 * j + 1]) / (2 * steps[j]) for j in range(6)], axis=1)[:6]
    block = phi[:6, :6]
    big = np.abs(block) >= 0.1 * np.abs(block).max()
    d = (np.abs(block - jac)[big] / np.abs(block)[big]).max()
    print(f"\nSTM over one orbit: {np.abs(phi - ref).max():.3e} from the reference, {d:.3e} relative from "
          f"central differences")
    assert d < 1e-5


# ------------------------------------------------------------------ targeting
@pytest.fixture(scope="module")
def leo_pair():
    return {M: M.Spacecraft.from_orbit(M.Orbit.keplerian(7378.1363, 0.01, 28.5, 10.0, 5.0, 0.0, _epoch(M),
                                                         M.Frames.EME2000)) for M in (R, P)}


def ref_objectives(name):
    return {"vnc": [Objective("sma", 7500.0, 1e-3), Objective("ecc", 0.05, 1e-6)],
            "position": [Objective("apoapsis_radius", 7465.0, 1e-3)]}.get(name, [Objective("sma", 8000.0, 1e-3)])


def _targeter_scene(M, name, leo):
    O, Tg = (RObjective, RO.Targeter) if M is R else (Objective, PO.Targeter)
    e0 = _epoch(M)
    prop = _two_body(M)
    kw = {} if M is R else dict(device="cpu")
    if name in ("sma_fd", "sma_dual"):
        method = name.split("_")[1]
        return Tg.delta_v(prop, [O.within_tolerance("sma", 8000.0, 1e-3)]).try_achieve_from(
            leo, e0, e0 + leo.orbit.period_s / 2.0, method, **kw)
    if name == "vnc":
        objs = [O.within_tolerance("sma", 7500.0, 1e-3), O.within_tolerance("ecc", 0.05, 1e-6)]
        return Tg.vnc(prop, objs).try_achieve_from(leo, e0, e0 + 2000.0, **kw)
    return Tg.delta_r(prop, [O.within_tolerance("apoapsis_radius", 7465.0, 1e-3)]).try_achieve_from(
        leo, e0, e0 + 1000.0, **kw)


# (bound on the corrections, km/s or km; on the achieved states, km): ~30x
# the gaps measured here. The FD Jacobian divides the packages' rounding
# gaps (~1e-15 relative) by its perturbation, 1e-6 km/s or 1e-4 km; the VNC
# pair's normal component starts from zero, so its sign is set by rounding
# (both signs solve the pair): it is compared by magnitude.
TARGETER_BOUNDS = {"sma_fd": (1e-8, 1e-4), "sma_dual": (1e-12, 1e-9), "vnc": (1e-4, None),
                   "position": (1e-6, 1e-4)}


@pytest.mark.parametrize("name", ["sma_fd", "sma_dual", "vnc", "position"])
def test_targeter_matches_reference(name, leo_pair):
    """tests/test_targeting.py:80-141 in two-body: the same Newton
    iterations, the corrections and achieved states within TARGETER_BOUNDS
    of the reference's (measured: sma FD 3.7e-10 km/s, dual 2.2e-15, VNC
    2.3e-6 in magnitude, position 2.9e-8 km), errors within the objectives'
    tolerances; the dual correction within 1e-6 km/s of the FD one (the
    reference test's bound)."""
    ref = _targeter_scene(R, name, leo_pair[R])
    got = _targeter_scene(P, name, leo_pair[P])
    d = np.abs(np.abs(got.correction) - np.abs(ref.correction)).max() if name == "vnc" else \
        np.abs(got.correction - ref.correction).max()
    print(f"\n{name}: {got.iterations} vs {ref.iterations} iterations, corrections {d:.3e} apart")
    bound, bound_state = TARGETER_BOUNDS[name]
    assert got.converged and got.iterations == ref.iterations and d < bound
    assert all(abs(e) <= o.tolerance for e, o in zip(got.achieved_errors, ref_objectives(name)))
    if bound_state is not None:
        d_state = np.abs(got.achieved_state.to_vector() - ref.achieved_state.to_vector()).max()
        assert d_state < bound_state, d_state
    if name == "sma_dual":
        fd = _targeter_scene(P, "sma_fd", leo_pair[P])
        assert np.abs(fd.correction - got.correction).max() < 1e-6


def _finite_scene(M, name):
    D, O, Tg = (RD, RObjective, RO.Targeter) if M is R else (PD, Objective, PO.Targeter)
    e0 = _epoch(M)
    kw = {} if M is R else dict(device="cpu")
    sc = replace(M.Spacecraft.new(M.Orbit.keplerian(7000.0, 0.001, 28.5, 0.0, 0.0, 0.0, e0, M.Frames.EME2000),
                                  900.0, 100.0, 0.0, 0.0, 1.8, 2.2),
                 thruster=(RThruster if M is R else Thruster)(thrust_N=400.0, isp_s=300.0))
    prop = _two_body(M)
    if name == "convert":
        sc = replace(sc, orbit=M.Orbit.keplerian(7000.0, 0.001, 28.5, 0.0, 0.0, 0.0, e0 + 3600.0, M.Frames.EME2000))
        dv = 0.025 * sc.orbit.v_km_s / np.linalg.norm(sc.orbit.v_km_s)
        return (RO if M is R else PO).convert_impulsive_mnvr(sc, dv, prop, **kw)
    a0 = sc.orbit.sma_km
    mnvr0 = D.Maneuver.from_time_invariant(e0, e0 + 300.0, 1.0, [1.0, 0.0, 0.0], D.LocalFrame.VNC)
    if name == "thrust_dir":
        tgt = Tg.thrust_dir(prop, [O("sma", a0 + 150.0, 0.5)], mnvr0)
    else:
        tgt = Tg.thrust_dir_rate(prop, [O("sma", a0 + 120.0, 0.5), O("inc", 28.55, 5e-4)], mnvr0)
    return tgt.try_achieve_from(sc, e0, e0 + 3000.0, **kw)


@pytest.mark.parametrize("name", ["thrust_dir", "thrust_dir_rate", "convert"])
def test_finite_burn_targeters_match_reference(name):
    """thrust_dir, thrust_dir_rate (tests/test_targeting.py:184-262) and
    convert_impulsive_mnvr (:263-303): both converge, with the same Newton
    iterations and errors within the objectives' tolerances. The burn's
    edges fall mid-step and each package's controller finds them by
    rejecting steps, whose sequence rounding sets (the nominal lanes end
    1.7e-4 km apart after 3,000 s); the FD Jacobians and so the Newton
    paths part with it, inside the solution set. So the corrected maneuvers
    are held within bounds of ~3x the gaps measured here: throttle 2e-3
    (6e-4), direction 3e-2 (1.1e-2), rate 5e-7 /s (1.0e-7); the start and
    end epochs within 1e-6 s, and the conversion, which meets its
    tolerances at its initial guess in both, exactly."""
    ref, got = _finite_scene(R, name), _finite_scene(P, name)
    mr, mp = ref.to_mnvr(), got.to_mnvr()
    print(f"\n{name}: {got.iterations} vs {ref.iterations} iterations; correction "
          f"{np.abs(got.correction - ref.correction).max():.3e} apart")
    assert got.converged and ref.converged and got.iterations == ref.iterations
    for t_p, t_r in ((mp.start, mr.start), (mp.end, mr.end)):
        assert abs(t_p.to_tai_seconds() - t_r.to_tai_seconds()) < 1e-6
    assert abs(mp.thrust_prct - mr.thrust_prct) < 2e-3
    np.testing.assert_allclose(mp.vector, mr.vector, rtol=0, atol=3e-2)
    if mr.vector_rate is not None:
        np.testing.assert_allclose(mp.vector_rate, mr.vector_rate, rtol=0, atol=5e-7)
    if name == "convert":
        np.testing.assert_array_equal(got.correction, ref.correction)
    tols = {1: [0.5], 2: [0.5, 5e-4], 6: [0.01] * 3 + [1e-5] * 3}[len(got.achieved_errors)]
    assert all(abs(e) <= t for e, t in zip(got.achieved_errors, tols))


def test_multiple_shooting_matches_reference():
    """tests/test_targeting.py:147-182's minimum-fuel transfer cut to two
    nodes (each outer iteration then runs 8 segment solves, not 15): the
    same outer iterations, total delta-v within 1e-9 km/s and node
    positions within 1e-6 km of the reference's, every node hit within
    2e-3 km, the end node fixed."""
    out = {}
    for M, MS in ((R, RMS), (P, PMS)):
        e0 = _epoch(M)
        x0 = M.Spacecraft.from_orbit(M.Orbit.keplerian(7378.0, 0.01, 28.5, 0.0, 0.0, 0.0, e0, M.Frames.EME2000))
        xf = M.Orbit.keplerian(7900.0, 0.01, 28.5, 0.0, 0.0, 25.0, e0 + 450.0, M.Frames.EME2000)
        ms = MS.MultipleShooting(_two_body(M), x0, xf, MS.equidistant_nodes(x0, xf, 2, tolerance_km=1e-3))
        out[M] = (ms.solve(MS.CostFunction.MinimumFuel, **({} if M is R else dict(device="cpu"))), xf)
    (ref, _), (got, xf) = out[R], out[P]
    d_dv = abs(got.total_dv_km_s() - ref.total_dv_km_s())
    d_nodes = max(np.abs(a.position() - b.position()).max() for a, b in zip(got.nodes, ref.nodes))
    print(f"\nmultiple shooting: {got}; {d_dv:.3e} km/s, nodes {d_nodes:.3e} km from the reference; "
          f"{got.solves} solves, {got.prop_iterations} propagator iterations")
    assert got.iterations == ref.iterations and d_dv < 1e-9 and d_nodes < 1e-6
    assert got.total_dv_km_s() < 2.0
    for node, seg in zip(got.nodes, got.solutions):
        assert seg.converged and np.linalg.norm(seg.achieved_state.orbit.r_km - node.position()) < 2e-3
    assert np.linalg.norm(got.nodes[-1].position() - xf.r_km) < 1e-9
    with pytest.raises(TargetingError):
        PMS.equidistant_nodes(got.x0, xf, 1)


# ------------------------------------------------------------------ Lambert
LAMBERT_R1 = [15945.34, 0.0, 0.0]
LAMBERT_R2 = [12214.83899, 10249.46731, 0.0]


def _lambert_input(M, tof_min):
    frame = M.Frames.EME2000.with_mu_km3_s2(3.98600433e5)
    t0 = M.Epoch.from_gregorian_utc(2025, 1, 1)
    s0 = M.Orbit.cartesian(*LAMBERT_R1, 0, 0, 0, t0, frame)
    s1 = M.Orbit.cartesian(*LAMBERT_R2, 0, 0, 0, t0 + tof_min * 60.0, frame)
    return (RT if M is R else PT).LambertInput.from_planetary_states(s0, s1)


@pytest.mark.parametrize("case", ["short", "long", "auto", "gooding_short", "gooding_long", "left", "right"])
def test_lambert_matches_reference(case):
    """Vallado's example (test_lambert.py): Izzo short way, long way and
    auto, Gooding both ways, and the one-revolution transfer on both
    branches (10 h), velocities at 1e-10 relative and the turn angle at
    1e-12; Vallado's own values at 1e-6."""
    sols = []
    for M, T in ((R, RT), (P, PT)):
        tof = 600.0 if case in ("left", "right") else 76.0
        inp = _lambert_input(M, tof)
        if case.startswith("gooding"):
            kind = T.TransferKind.ShortWay if case.endswith("short") else T.TransferKind.LongWay
            sols.append(T.gooding(inp, kind))
        elif case in ("left", "right"):
            sols.append(T.izzo(inp, T.TransferKind.n_revs(1), branch=case))
        else:
            kind = {"short": T.TransferKind.ShortWay, "long": T.TransferKind.LongWay, "auto": T.TransferKind.Auto}[case]
            sols.append(T.izzo(inp, kind))
    ref, got = sols
    for k in ("v_init_km_s", "v_final_km_s"):
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k), rtol=1e-10, atol=1e-12)
    assert abs(got.phi_rad - ref.phi_rad) < 1e-12
    vallado = {"short": [2.058913, 2.915965, 0.0], "long": [-3.811158, -2.003854, 0.0]}
    key = "long" if case.endswith("long") else "short" if case in ("short", "auto", "gooding_short") else None
    if key:
        assert np.linalg.norm(got.v_init_km_s - vallado[key]) < 1e-6
    if case in ("left", "right"):
        arrived = got.transfer_orbit().at_epoch(got.input.final_state.epoch)
        assert np.linalg.norm(arrived.r_km - LAMBERT_R2) < 1e-4


def test_lambert_errors_match_reference():
    """Below the one-revolution minimum there is no solution, and Gooding
    stays zero-rev, as in the reference."""
    with pytest.raises(LambertError):
        PT.izzo(_lambert_input(P, 76.0), PT.TransferKind.n_revs(1))
    with pytest.raises(LambertError):
        PT.gooding(_lambert_input(P, 600.0), PT.TransferKind.n_revs(1))


def test_batched_lambert_matches_reference_vmap():
    """`lambert_izzo_rv` over a batch (a TOF sweep, both ways per cell)
    against the reference's vmapped solver, at 1e-10 relative."""
    tofs = np.linspace(40.0, 150.0, 56) * 60.0
    long_way = np.arange(56) % 2 == 1
    r1, r2 = np.tile(LAMBERT_R1, (56, 1)), np.tile(LAMBERT_R2, (56, 1))
    mu = 3.98600433e5
    v1, v2 = PT.lambert_izzo_rv(_t(r1), _t(r2), _t(tofs), mu, long_way=torch.as_tensor(long_way))
    rv1, rv2 = jax.vmap(lambda a, b, t, lw: RT.lambert_izzo_rv(a, b, t, mu, long_way=lw))(
        _j(r1), _j(r2), _j(tofs), jnp.asarray(long_way))
    np.testing.assert_allclose(v1.numpy(), np.asarray(rv1), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v2.numpy(), np.asarray(rv2), rtol=1e-10, atol=1e-12)


def test_porkchop_grid_matches_reference():
    """test_lambert.py:118-140's 12 x 12 Earth -> Mars barycenter grid:
    every cell's C3, arrival v-infinity and total within 1e-10 relative of
    the reference's; the window's minimum C3 in 8-25 km^2/s^2 after
    2020-07-01; a grid with non-positive times of flight is NaN there."""
    out = {}
    for M, T, A in ((R, RT, RAlmanac), (P, PT, Almanac)):
        dep0, arr0 = M.Epoch.from_gregorian_utc(2020, 6, 20), M.Epoch.from_gregorian_utc(2020, 12, 1)
        deps = [dep0 + k * 5 * 86400.0 for k in range(12)]
        arrs = [arr0 + k * 10 * 86400.0 for k in range(12)]
        kw = {} if M is R else dict(device="cpu")
        out[M] = T.porkchop(A(), NAIF.EARTH, NAIF.MARS_BARYCENTER, deps, arrs, **kw)
    for k in ("c3_km2_s2", "vinf_arrival_km_s", "dv_total_km_s", "tof_days"):
        _close(getattr(out[P], k), getattr(out[R], k), 1e-10)
    dep, _, c3min = out[P].best()
    assert 8.0 < c3min < 25.0
    assert dep.to_tai_seconds() > P.Epoch.from_gregorian_utc(2020, 7, 1).to_tai_seconds()
    e0 = P.Epoch.from_gregorian_utc(2020, 6, 1)
    pc = PT.porkchop(Almanac(), NAIF.EARTH, NAIF.MARS_BARYCENTER, [e0 + 86400.0 * k for k in range(3)],
                     [e0 + 86400.0 * k for k in range(3)], device="cpu")
    assert np.array_equal(np.isnan(pc.c3_km2_s2), pc.tof_days <= 0)


# ------------------------------------------------------------------ sequence
def _sequence(M, D):
    e0 = _epoch(M)
    t1, t2 = e0 + 1800.0, e0 + 2400.0
    burn = D.Maneuver.from_time_invariant(t1, t2, 1.0, [1.0, 0.0, 0.0], D.LocalFrame.VNC)
    return D.SpacecraftSequence(
        seq={
            e0: D.Phase.Activity("coast", "two_body"),
            t1: D.Phase.Activity("burn", "two_body", guidance={"law": burn, "thruster_model": "main"},
                                 on_entry=D.DiscreteEvent("staging",
                                                          properties=D.PhysicalProperties(dry_mass_kg=20.0))),
            t2: D.Phase.Activity("coast2", "two_body"),
            e0 + 3000.0: D.Phase.Terminate(),
        },
        thruster_sets={"main": (RThruster if M is R else Thruster)(thrust_N=50.0, isp_s=300.0)},
        propagators={"two_body": D.PropagatorConfig(D.DynamicsConfig(frame=M.Frames.EME2000))},
    )


def test_sequence_matches_reference():
    """test_sequence.py:26-48's timeline (coast, a staging event and a
    50 N burn, coast, Terminate): per phase, the masses at 1e-12 kg and the
    final states within 1e-9 km of the reference's; the burn meets the
    rocket equation within 1e-6 kg; until_phase stops before the burn;
    validation refuses a timeline without a Terminate or with an unknown
    propagator; a configuration with solid tides builds the reference's
    models."""
    trajs = {}
    for M, D in ((R, RD), (P, PD)):
        orbit = M.Orbit.keplerian(8000.0, 0.01, 30.0, 0, 0, 0, _epoch(M), M.Frames.EME2000)
        sc = M.Spacecraft(orbit=orbit, dry_mass_kg=120.0, prop_mass_kg=80.0)
        kw = {} if M is R else dict(device="cpu")
        trajs[M] = _sequence(M, D).propagate(sc, **kw)
        assert len(_sequence(M, D).propagate(sc, until_phase="burn", **kw)) == 1
    assert len(trajs[P]) == len(trajs[R]) == 3
    for tp, tr in zip(trajs[P], trajs[R]):
        for a, b in ((tp.first, tr.first), (tp.last, tr.last)):
            assert abs(a.dry_mass_kg - b.dry_mass_kg) < 1e-12 and abs(a.prop_mass_kg - b.prop_mass_kg) < 1e-12
            assert np.abs(a.orbit.r_km - b.orbit.r_km).max() < 1e-9
            assert a.epoch.to_tai_seconds() == b.epoch.to_tai_seconds()
    burned = trajs[P][1].first.prop_mass_kg - trajs[P][1].last.prop_mass_kg
    assert abs(burned - 50.0 / (300.0 * STD_GRAVITY_M_S2) * 600.0) < 1e-6
    assert abs(trajs[P][1].first.dry_mass_kg - 100.0) < 1e-12
    e0 = _epoch(P)
    two = PD.PropagatorConfig(PD.DynamicsConfig())
    with pytest.raises(ConfigError, match="Terminate"):
        PD.SpacecraftSequence(seq={e0: PD.Phase.Activity("a", "two_body")}, propagators={"two_body": two}).validate()
    with pytest.raises(ConfigError, match="no propagator"):
        PD.SpacecraftSequence(seq={e0: PD.Phase.Activity("a", "nope"), e0 + 1.0: PD.Phase.Terminate()}).validate()
    tides = PD.DynamicsConfig(solid_tides=True).build().orbital_dyn.models
    assert [type(m).__name__ for m in tides] == [type(m).__name__ for m in
                                                 RD.DynamicsConfig(solid_tides=True).build().orbital_dyn.models]
