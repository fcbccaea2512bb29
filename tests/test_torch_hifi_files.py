"""The file-driven high-fidelity Earth dynamics: the PyTorch port against nyx_tpu.

The constant and 1976 standard atmospheres, the SHADR and EGM2008 field
files, `from_j2` and `truncated`, solid tides (value and forward-mode
tangent), the f32 perturbation stack (`pert_precision="f32"`) with its
Pines call held against the reference's Pallas kernel in interpret mode,
chip_smoke.py's phase 6m scene over an hour at both precisions, DAF, SPK and
binary PCK files written by each package and read by both, the Almanac on
SPK kernels, `default_almanac`, BSP and parquet trajectories,
`ODSolution.to_ephemeris`, `DynamicsConfig` and the scan filter's stage-2
dynamics. Every file is written by the test; inputs come from numpy seeds;
JAX runs on the CPU in float64.

Tolerances: 1e-12 relative where both packages compute in float64 with the
same formulas; where a value rounds in float32 the bound is stated at the
test.

The test marked `cuda` needs only the port. A machine with a card but no
JAX runs it alone with

    python -m pytest --noconftest -m cuda tests/test_torch_hifi_files.py
"""

import gzip
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

try:
    import jax
    import jax.numpy as jnp
    import nyx_tpu as R
    import nyx_tpu.ephem.almanac as r_almanac
    from nyx_tpu.dynamics import Drag as RDrag
    from nyx_tpu.dynamics import Harmonics as RHarmonics
    from nyx_tpu.dynamics import OrbitalDynamics as ROrbitalDynamics
    from nyx_tpu.dynamics import PointMasses as RPointMasses
    from nyx_tpu.dynamics import SolarPressure as RSolarPressure
    from nyx_tpu.dynamics import SolidTides as RSolidTides
    from nyx_tpu.dynamics import SpacecraftDynamics as RSpacecraftDynamics
    from nyx_tpu.dynamics.drag import AtmDensity as RAtmDensity
    from nyx_tpu.dynamics.sequence import DynamicsConfig as RDynamicsConfig
    from nyx_tpu.dynamics.solid_tides import TidalPerturber as RTidalPerturber
    from nyx_tpu.ephem.daf import BPC as RBPC
    from nyx_tpu.ephem.daf import SPK as RSPK
    from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
    from nyx_tpu.io.spk import write_spk_type3 as r_write_spk_type3
    from nyx_tpu.mc import MonteCarlo as RMonteCarlo
    from nyx_tpu.mc import MvnSpacecraft as RMvnSpacecraft
    from nyx_tpu.mc import StateDispersion as RStateDispersion
    from nyx_tpu.md.trajectory import Trajectory as RTrajectory
    from nyx_tpu.propagators import IntegratorOptions as RIntegratorOptions
    from nyx_tpu.propagators import Propagator as RPropagator
except ModuleNotFoundError:  # no JAX: only the port-only `cuda` test can run
    R = None

import chip_smoke
import nyx_tpu_torch as P
import nyx_tpu_torch.ephem.almanac as p_almanac
from nyx_tpu_torch.constants import NAIF
from nyx_tpu_torch.cosmic.eclipse import ShadowModel
from nyx_tpu_torch.dynamics import (
    AtmDensity,
    Drag,
    DynamicsConfig,
    Harmonics,
    OrbitalDynamics,
    PointMasses,
    SolarPressure,
    SolidTides,
    SpacecraftDynamics,
    TidalPerturber,
)
from nyx_tpu_torch.ephem import BPC, SPK, Almanac, default_almanac
from nyx_tpu_torch.interop import states_from_numpy
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.io.spk import write_spk_type3
from nyx_tpu_torch.mc import MonteCarlo, MvnSpacecraft, StateDispersion
from nyx_tpu_torch.md.trajectory import Trajectory
from nyx_tpu_torch.od import KfEstimate, ODSolution
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator

needs_jax = pytest.mark.skipif(R is None, reason="needs JAX and nyx_tpu (the reference)")

ROOT = Path(__file__).parents[1]
JGM3 = ROOT / "data/JGM3.cof.gz"
F64_REL = 1e-12
# the reference's own bound between two f32 evaluations of the recursion
# (tests/test_dynamics.py:399,415), per-lane relative norm
KERNEL_REL_TOL = 2e-5
HOUR = 3600.0


def _rel(a, b):
    """Max over lanes of |a - b| / |b|, norms over the last axis."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _j(x, dtype=None):
    return jnp.asarray(np.asarray(x), dtype or jnp.float64)


def _epoch(M):
    return M.Epoch.from_gregorian_utc(2021, 3, 4)


def _spacecraft(M):
    o = M.Orbit.keplerian(7136.6, 2e-4, 51.6, 30.0, 65.0, 80.0, _epoch(M), M.Frames.EME2000)
    return M.Spacecraft.new(o, 100.0, 0.0, 2.0, 2.0, 1.8, 2.2)


def _lanes(n, seed, radius_km=7136.6):
    """[n, 9] states about the Config 2 orbit's radius, spread over the
    sphere, with Cr 1.8, Cd 2.2 and no propellant."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = np.cross(u, rng.normal(size=(n, 3)))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    y = np.zeros((n, 9))
    y[:, 0:3] = u * radius_km * rng.uniform(0.999, 1.001, (n, 1))
    y[:, 3:6] = w * np.sqrt(398_600.4418 / radius_km)
    y[:, 6], y[:, 7] = 1.8, 2.2
    return y


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Phase 6m's files (chip_smoke.hifi_files, the port's writers): the
    EGM2008 text of JGM3's 21x21 and the Moon's and the Sun's SPKs."""
    out = tmp_path_factory.mktemp("hifi")
    stor21 = GravityFieldData.from_cof(JGM3, 21, 21, True, P.Frames.IAU_EARTH)
    egm, spks = chip_smoke.hifi_files(out, stor21, _epoch(P))
    return dict(egm=egm, spks=spks, stor21=stor21)


# ------------------------------------------------------------- atmospheres
@needs_jax
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_densities_and_drag(dtype):
    """The constant, exponential and 1976 densities at 100-1,500 km (above
    and below the 1976 fit's 1,000 km limit), and the 1976 and constant
    drag forces per unit mass. At f64 1e-12 relative; at f32 1e-5, and for
    the drag on a lane whose f32 |r| the two packages round apart (by an
    ulp, 4.9e-4 km at 100 km: their norms sum otherwise) also that
    altitude difference times the density's log slope (at 100 km the 1976
    fit's scale height is ~6 km, so an ulp moves the force 1.4e-4)."""
    jdt, tdt, tol = ((jnp.float64, torch.float64, F64_REL) if dtype == "f64"
                     else (jnp.float32, torch.float32, 1e-5))
    alt = np.linspace(100.0, 1_500.0, 57)
    for ref, port in ((RAtmDensity.constant(2.5e-12), AtmDensity.constant(2.5e-12)),
                      (RAtmDensity.earth_exponential(), AtmDensity.earth_exponential()),
                      (RAtmDensity.std_atm1976(), AtmDensity.std_atm1976()),
                      (RAtmDensity.std_atm1976(600_000.0), AtmDensity.std_atm1976(600_000.0))):
        rho_ref = np.asarray(ref.density(_j(alt, jdt)))
        rho = port.density(_t(alt, tdt))
        assert rho.dtype == tdt
        assert _rel(rho.numpy()[:, None], rho_ref[:, None]) < tol, port
    y = _lanes(32, 1)
    y[:, 0:3] *= np.linspace(6_478.0, 7_878.0, 32)[:, None] / np.linalg.norm(y[:, 0:3], axis=1, keepdims=True)
    for ref, port in ((RDrag.std_atm1976(), Drag.std_atm1976()),
                      (RDrag(RAtmDensity.constant(3e-12)), Drag(AtmDensity.constant(3e-12)))):
        sc_ref = dict(cd=_j(y[:, 7], jdt), drag_area_m2=2.0, mass_kg=_j(100.0 + y[:, 8], jdt))
        sc = dict(cd=_t(y[:, 7], tdt), drag_area_m2=2.0, mass_kg=_t(100.0 + y[:, 8], tdt))
        a_ref = np.asarray(ref.force_per_mass(None, None, _j(y[:, :3], jdt), _j(y[:, 3:6], jdt), sc_ref))
        a = port.force_per_mass(None, None, _t(y[:, :3], tdt), _t(y[:, 3:6], tdt), sc)
        assert a.dtype == tdt
        d_alt = np.abs(P.xmath.norm(_t(y[:, :3], tdt)).numpy().astype(np.float64)
                       - np.asarray(jnp.linalg.norm(_j(y[:, :3], jdt), axis=-1), np.float64))
        alt_km = np.linalg.norm(y[:, :3], axis=1) - 6_378.1363
        rho = [np.asarray(ref.density.density(_j(alt_km + h))) for h in (-1e-3, 1e-3)]
        slope = np.abs(np.log(rho[1]) - np.log(rho[0])) / 2e-3  # 1/km
        rel = np.linalg.norm(a.numpy() - a_ref, axis=1) / np.linalg.norm(a_ref, axis=1)
        assert (rel < tol + 1.01 * slope * d_alt).all(), (rel, d_alt)


# ------------------------------------------------------------- field files
@needs_jax
def test_field_files_and_constructors(tmp_path, files):
    """SHADR (m and m^3/s^2 headers, D exponents, gzip) and EGM2008 (its own
    constants, or a frame's) files written here, `from_j2` and `truncated`:
    the port's arrays and constants equal the reference's."""
    stor = files["stor21"]
    rng = np.random.default_rng(2)
    lines = ["   1.7380000000000000D+06,   4.9028001000000000D+12,   0.0D+00,    5,    5,    1,"
             "   0.0D+00,   0.0D+00"]
    for n in range(2, 6):
        for m in range(n + 1):
            c, s = rng.normal(size=2) * 1e-5
            lines.append(f"{n:5d},{m:5d}, {c:.16E}, {s:.16E}, 1.0D-10, 1.0D-10".replace("E", "D"))
    shadr = tmp_path / "jggrx_0005.tab.gz"
    with gzip.open(shadr, "wt") as f:
        f.write("\n".join(lines) + "\n")
    pairs = [
        (RGravityFieldData.from_shadr(shadr, 4, 3, True, R.Frames.IAU_MOON),
         GravityFieldData.from_shadr(shadr, 4, 3, True, P.Frames.IAU_MOON)),
        (RGravityFieldData.from_shadr(shadr), GravityFieldData.from_shadr(shadr)),
        (RGravityFieldData.from_egm2008(files["egm"]), GravityFieldData.from_egm2008(files["egm"])),
        (RGravityFieldData.from_egm2008(files["egm"], 12, 8, frame=R.Frames.IAU_EARTH),
         GravityFieldData.from_egm2008(files["egm"], 12, 8, frame=P.Frames.IAU_EARTH)),
        (RGravityFieldData.from_j2(-4.84165e-4, R.Frames.IAU_EARTH),
         GravityFieldData.from_j2(-4.84165e-4, P.Frames.IAU_EARTH)),
        (RGravityFieldData.from_j2(1e-3, mu_km3_s2=1.0, radius_km=2.0),
         GravityFieldData.from_j2(1e-3, mu_km3_s2=1.0, radius_km=2.0)),
    ]
    r_stor = RGravityFieldData.from_cof(JGM3, 21, 21, True, R.Frames.IAU_EARTH)
    pairs.append((r_stor.truncated(9, 4), stor.truncated(9, 4)))
    for ref, port in pairs:
        np.testing.assert_array_equal(port.c_nm, ref.c_nm)
        np.testing.assert_array_equal(port.s_nm, ref.s_nm)
        assert (port.mu_km3_s2, port.radius_km) == (ref.mu_km3_s2, ref.radius_km)
        assert (port.frame is None) == (ref.frame is None)
    shadr_port = pairs[1][1]
    assert (shadr_port.radius_km, shadr_port.mu_km3_s2, shadr_port.max_degree) == (1738.0, 4902.8001, 5)
    egm = GravityFieldData.from_egm2008(files["egm"], frame=P.Frames.IAU_EARTH)
    np.testing.assert_array_equal(egm.c_nm, stor.c_nm)  # the 17-digit text reads back to the bit
    np.testing.assert_array_equal(egm.s_nm, stor.s_nm)
    assert (pairs[2][1].mu_km3_s2, pairs[2][1].radius_km) == (398_600.4415, 6_378.1363)
    assert stor.truncated(9, 4).c_nm.shape == (10, 5)


# ------------------------------------------------------------- solid tides
def _tides_pair(degree3):
    if degree3:
        return RSolidTides.earth_moon_system(R.Frames.IAU_EARTH), SolidTides.earth_moon_system(P.Frames.IAU_EARTH)
    pert = ((NAIF.MOON, False), (NAIF.SUN, False))
    return (RSolidTides(R.Frames.IAU_EARTH, perturbers=tuple(RTidalPerturber(*p) for p in pert)),
            SolidTides(P.Frames.IAU_EARTH, perturbers=tuple(TidalPerturber(*p) for p in pert)))


def _contexts(ref_model, port_model, seconds=HOUR):
    ctx_ref = RSpacecraftDynamics(ROrbitalDynamics.from_model(ref_model)).build_context(
        _epoch(R), seconds, r_almanac.Almanac())
    ctx = SpacecraftDynamics(OrbitalDynamics.from_model(port_model)).build_context(
        _epoch(P), seconds, Almanac(), device="cpu")
    return ctx_ref, ctx


@needs_jax
@pytest.mark.parametrize("degree3", [True, False])
@pytest.mark.parametrize("radius_km", [7_000.0, 42_164.0])
def test_solid_tides(degree3, radius_km):
    """SolidTides.accel at LEO and GEO, with and without the Moon's degree 3,
    on f64 and f32 positions (the reference promotes an f32 r to its f64
    DCM and tables, so both return f64): 1e-10 relative. Its forward-mode
    tangent (the port's dual tensors, as the STM EOM takes it) against
    jax.jacfwd: 1e-8 relative."""
    ref, port = _tides_pair(degree3)
    assert port.required_bodies() == ref.required_bodies()
    ctx_ref, ctx = _contexts(ref, port)
    y = _lanes(16, 3, radius_km)
    t = float(ctx_ref.epoch0_tdb) + np.linspace(0.0, HOUR, 16)
    for jdt, tdt in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        a_ref = ref.accel(ctx_ref, _j(t), _j(y[:, :3], jdt), _j(y[:, 3:6], jdt))
        a = port.accel(ctx, _t(t), _t(y[:, :3], tdt), _t(y[:, 3:6], tdt))
        assert a.dtype == torch.float64 and a_ref.dtype == jnp.float64
        assert _rel(a.numpy(), np.asarray(a_ref)) < 1e-10
    assert 1e-15 < np.linalg.norm(a.numpy(), axis=1).min()

    def lane(rr, tt, vv):
        return ref.accel(ctx_ref, tt[None], rr[None], vv[None])[0]

    jac_ref = np.asarray(jax.vmap(jax.jacfwd(lane))(_j(y[:, :3]), _j(t), _j(y[:, 3:6])))  # [B, 3, 3]
    cols = []
    with fwAD.dual_level():
        for j in range(3):
            e = torch.zeros(16, 3, dtype=torch.float64)
            e[:, j] = 1.0
            out = port.accel(ctx, _t(t), fwAD.make_dual(_t(y[:, :3]), e), _t(y[:, 3:6]))
            cols.append(fwAD.unpack_dual(out).tangent)
    jac = torch.stack(cols, dim=-1).numpy()
    scale = np.abs(jac_ref).max(axis=(1, 2))
    assert (np.abs(jac - jac_ref).max(axis=(1, 2)) / scale).max() < 1e-8


# ------------------------------------------------------------- the f32 perturbation stack
def _hifi_models(M, field, files, backend="auto"):
    """Phase 6m's orbital models and force models in package M."""
    if M is R:
        stor = RGravityFieldData.from_egm2008(files["egm"], 21, 21, frame=R.Frames.IAU_EARTH)
        models = (RHarmonics.from_stor(stor, "f64", backend=backend), RPointMasses((NAIF.MOON, NAIF.SUN)),
                  RSolidTides.earth_moon_system())
        return models, (RSolarPressure.default(), RDrag.std_atm1976())
    models = (Harmonics.from_stor(field, "f64", backend), PointMasses((NAIF.MOON, NAIF.SUN)),
              SolidTides.earth_moon_system())
    return models, (SolarPressure.default(), Drag.std_atm1976())


def _hifi_dynamics(M, files, pert_precision):
    field = GravityFieldData.from_egm2008(files["egm"], 21, 21, frame=P.Frames.IAU_EARTH)
    models, forces = _hifi_models(M, field, files)
    OD, SD = (ROrbitalDynamics, RSpacecraftDynamics) if M is R else (OrbitalDynamics, SpacecraftDynamics)
    return SD(OD.from_models(models, M.Frames.EME2000), forces, pert_precision=pert_precision)


@needs_jax
def test_f32_perturbation_eom(files):
    """The f32 perturbation stack at B = 8: each model's output dtype on f32
    positions (the field f32, point masses and tides f64 by promotion, as
    the reference's), the perturbation sum's and the EOM's, and the EOM's
    value: the velocities and the mass flow equal to the bit, the
    accelerations within 4e-8 relative (the field, ~2e-3 of the LEO
    acceleration, runs in f32 and is itself held to 2e-5; 3e-9 measured). The
    field's Pines call against the reference's Pallas kernel in interpret
    mode, at f32: within the reference's own f32 bound, 2e-5 a lane."""
    alm_ref, alm = r_almanac.Almanac(files["spks"]), Almanac(files["spks"])
    dyn_ref = _hifi_dynamics(R, files, "f32")
    dyn = _hifi_dynamics(P, files, "f32")
    assert dyn.pert_precision == "f32"
    ctx_ref = dyn_ref.build_context(_epoch(R), HOUR, alm_ref)
    ctx = dyn.build_context(_epoch(P), HOUR, alm, device="cpu")
    np.testing.assert_allclose(ctx.table.coeffs.numpy(), np.asarray(ctx_ref.table.coeffs), rtol=0, atol=1e-9)
    y = _lanes(8, 4)
    t = np.linspace(0.0, HOUR, 8)
    r32, v32 = y[:, :3].astype(np.float32), y[:, 3:6].astype(np.float32)
    tt = float(ctx_ref.epoch0_tdb) + t
    for m_ref, m in zip(dyn_ref.orbital_dyn.models, dyn.orbital_dyn.models):
        a_ref = m_ref.accel(ctx_ref, _j(tt), _j(r32, jnp.float32), _j(v32, jnp.float32))
        a = m.accel(ctx, _t(tt), _t(r32, torch.float32), _t(v32, torch.float32))
        assert str(a.dtype).split(".")[-1] == str(a_ref.dtype), type(m).__name__
        tol = KERNEL_REL_TOL if a.dtype == torch.float32 else 1e-10
        assert _rel(a.numpy(), np.asarray(a_ref)) < tol, type(m).__name__
    ap_ref = dyn_ref.orbital_dyn.perturbation_accel(ctx_ref, _j(tt), _j(r32, jnp.float32), _j(v32, jnp.float32))
    ap = dyn.orbital_dyn.perturbation_accel(ctx, _t(tt), _t(r32, torch.float32), _t(v32, torch.float32))
    assert ap.dtype == torch.float64 and ap_ref.dtype == jnp.float64

    p = dict(dry_mass_kg=100.0, srp_area_m2=2.0, drag_area_m2=2.0)
    d_ref = np.asarray(dyn_ref.make_eom()(_j(t), _j(y), ctx_ref, p))
    d = dyn.make_eom()(_t(t), _t(y), ctx, p)
    assert d.dtype == torch.float64 and d.shape == (8, 9)
    d = d.numpy()
    np.testing.assert_array_equal(d[:, 0:3], d_ref[:, 0:3])
    np.testing.assert_array_equal(d[:, 6:9], d_ref[:, 6:9])
    assert _rel(d[:, 3:6], d_ref[:, 3:6]) < 4e-8
    two_body = dyn.orbital_dyn.two_body_accel(ctx, _t(y[:, :3]))
    assert np.abs(d[:, 3:6] - two_body.numpy()).max() < 1e-4  # the perturbations only

    # the Pines call: the same f32 body-fixed positions through the
    # reference's Pallas kernel (interpret mode off the TPU) and the port
    stor_ref = RGravityFieldData.from_egm2008(files["egm"], 21, 21, frame=R.Frames.IAU_EARTH)
    pallas = RHarmonics.from_stor(stor_ref, "f64", backend="pallas")
    r_bf = chip_smoke._body_fixed(8, 5).astype(np.float32)
    a_pallas = np.asarray(pallas.accel_body_fixed(_j(r_bf, jnp.float32)))
    a_port = dyn.orbital_dyn.models[0].accel_body_fixed(_t(r_bf, torch.float32))
    assert a_port.dtype == torch.float32 and a_pallas.dtype == np.float32
    assert _rel(a_port.numpy(), a_pallas) < KERNEL_REL_TOL


@needs_jax
def test_hifi_monte_carlo_matches_reference(files):
    """Phase 6m's scene at B = 16 over an hour (RK89 at Config 2's 1e-9)
    through both packages' MonteCarlo.run_until_epoch from the same
    states, the ephemerides read from the SPK files and the field from the
    EGM2008 file. With f32 perturbations the finals agree within 1e-4 km
    (the f32 rounding steers the adaptive steps; 1.8e-5 km measured). With
    f64 perturbations 1e-5 km: SRP and drag stay f32 in both packages and
    steer a step on 4 of the 16 lanes (2.1e-6 km measured); without them
    1e-8 km (1.4e-11 measured). In each package the f32 run lies within
    1 m of the f64 run (the reference's claim, spacecraft_dyn.py:52-58)."""
    alm_ref, alm = r_almanac.Almanac(files["spks"]), Almanac(files["spks"])
    sc_ref, sc = _spacecraft(R), _spacecraft(P)
    y0 = np.asarray(MvnSpacecraft(sc, [StateDispersion("sma", 0.5), StateDispersion("inc", 0.01)])
                    .sample(16, torch.Generator().manual_seed(42), device="cpu"))
    finals = {}
    for prec, forces, tol in (("f32", True, 1e-4), ("f64", True, 1e-5), ("f64", False, 1e-8)):
        dyn_ref, dyn = _hifi_dynamics(R, files, prec), _hifi_dynamics(P, files, prec)
        if not forces:
            dyn_ref.force_models, dyn.force_models = (), ()
        ref = RMonteCarlo(RMvnSpacecraft(sc_ref, [RStateDispersion("sma", 0.5)]), seed=1).run_until_epoch(
            RPropagator.rk89(dyn_ref, RIntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9)),
            alm_ref, _epoch(R) + HOUR, 16, _y0=jnp.asarray(y0))
        res = MonteCarlo(MvnSpacecraft(sc, [StateDispersion("sma", 0.5)]), seed=1).run_until_epoch(
            Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9)),
            alm, _epoch(P) + HOUR, 16, device="cpu", _y0=states_from_numpy(y0, device="cpu"))
        assert res.n_ok == ref.n_ok == 16
        d_km = np.linalg.norm(res.y_final[:, :3] - np.asarray(ref.y_final)[:, :3], axis=1).max()
        print(f"\nhifi MC {prec}{'' if forces else ' without SRP and drag'}: port vs reference {d_km:.3e} km, "
              f"mean accepted {np.mean(res.n_accepted):.2f} vs {np.mean(np.asarray(ref.n_accepted)):.2f}, "
              f"rejected {np.mean(res.n_rejected):.2f} vs {np.mean(np.asarray(ref.n_rejected)):.2f}")
        assert d_km < tol
        if forces:
            finals[prec] = (res.y_final[:, :3], np.asarray(ref.y_final)[:, :3])
    for k, name in enumerate(("port", "reference")):
        gap = np.linalg.norm(finals["f32"][k] - finals["f64"][k], axis=1).max()
        print(f"hifi MC {name}: f32 vs f64 perturbations {gap:.3e} km")
        assert gap < 1e-3


# ------------------------------------------------------------- DAF, SPK, BPC
def _write_daf(path, idword, nd, ni, segments, endian="<"):
    """A DAF file: the file record, one summary record of `segments`
    [(doubles [nd], ints [ni], data words)], a name record, then the data."""
    def fmt(code, n=1):
        return f"{endian}{n}{code}"

    i4 = fmt("i")
    rec1 = bytearray(1024)
    rec1[0:8] = idword.ljust(8).encode()
    struct.pack_into(i4, rec1, 8, nd)
    struct.pack_into(i4, rec1, 12, ni)
    struct.pack_into(i4, rec1, 76, 2)
    struct.pack_into(i4, rec1, 80, 2)
    rec1[88:96] = b"LTL-IEEE" if endian == "<" else b"BIG-IEEE"
    ss = nd + (ni + 1) // 2
    summary = bytearray(1024)
    struct.pack_into(fmt("d", 3), summary, 0, 0.0, 0.0, float(len(segments)))
    words, start = [], 3 * 128 + 1
    for k, (dc, ic, data) in enumerate(segments):
        ic = list(ic) + [start, start + len(data) - 1]
        off = (3 + k * ss) * 8
        struct.pack_into(fmt("d", nd), summary, off, *dc)
        struct.pack_into(fmt("i", len(ic)), summary, off + 8 * nd, *ic)
        words.extend(data)
        start += len(data)
    struct.pack_into(i4, rec1, 84, start)
    data = bytearray(8 * 128 * ((len(words) + 127) // 128))
    struct.pack_into(fmt("d", len(words)), data, 0, *words)
    Path(path).write_bytes(bytes(rec1) + bytes(summary) + b" " * 1024 + bytes(data))


def _cheb_segment(init, intlen, n_rec, n_comp, deg, seed):
    """Type-2/3 words: records (MID, RADIUS, coefficients), then the trailer."""
    coeffs = np.random.default_rng(seed).normal(size=(n_rec, n_comp, deg + 1)) * 1e3
    words = []
    for i in range(n_rec):
        words += [init + (i + 0.5) * intlen, intlen / 2] + list(coeffs[i].ravel())
    return coeffs, words + [init, intlen, float(2 + n_comp * (deg + 1)), float(n_rec)]


@needs_jax
@pytest.mark.parametrize("endian", ["<", ">"])
def test_daf_files_read_by_both(tmp_path, endian):
    """An SPK with a type-2 and a type-3 segment and a binary PCK (type 2),
    written here in either byte order, and type-3 SPKs written by each
    package's `write_spk_type3` (byte for byte the same file): both
    readers give the same segments and the same coefficients, to the bit."""
    c2, w2 = _cheb_segment(-1e5, 4e4, 5, 3, 7, 1)
    c3, w3 = _cheb_segment(-1e5, 8e4, 3, 6, 5, 2)
    spk_path = tmp_path / "mixed.bsp"
    _write_daf(spk_path, "DAF/SPK", 2, 6, [((-1e5, 1e5), (301, 399, 1, 2), w2),
                                             ((-1e5, 1.4e5), (399, 0, 1, 3), w3)], endian)
    cb, wb = _cheb_segment(0.0, 864e2, 4, 3, 9, 3)
    bpc_path = tmp_path / "earth.bpc"
    _write_daf(bpc_path, "DAF/PCK", 2, 5, [((0.0, 3456e2), (3000, 17, 2), wb)], endian)

    def sample(ts):
        return np.stack([np.cos(ts / 1e4), np.sin(ts / 2e4), ts / 1e6, ts * 0 + 1, ts / 1e3, -ts / 1e5], 1) * 1e4

    written = [write_spk_type3(tmp_path / "port.bsp", -7, 399, 1, 100.0, 9_100.0, sample, 2_000.0, 9),
               r_write_spk_type3(tmp_path / "ref.bsp", -7, 399, 1, 100.0, 9_100.0, sample, 2_000.0, 9)]
    assert Path(written[0]).read_bytes() == Path(written[1]).read_bytes()

    for path in (spk_path, *written):
        port, ref = SPK(path), RSPK(path)
        assert [vars(s) for s in port.segments] == [vars(s) for s in ref.segments]
        for s, s_ref in zip(port.segments, ref.segments):
            a, b = port.chebyshev_records(s), ref.chebyshev_records(s_ref)
            assert (a.init, a.intlen) == (b.init, b.intlen)
            np.testing.assert_array_equal(a.coeffs, b.coeffs)
            for t in (s.t_start, 0.5 * (s.t_start + s.t_stop), s.t_stop):
                np.testing.assert_array_equal(port._eval_segment(s, t), ref._eval_segment(s_ref, t))
    port = SPK(spk_path)
    np.testing.assert_array_equal(port.chebyshev_records(port.segments[0]).coeffs, c2)
    np.testing.assert_array_equal(port.chebyshev_records(port.segments[1]).coeffs, c3)
    for target, center in ((301, 399), (301, 0), (399, 0)):
        np.testing.assert_array_equal(port.position(target, center, 5e3),
                                      RSPK(spk_path).position(target, center, 5e3))
    assert port.segment_for(301, 0.0).data_type == 2
    with pytest.raises(KeyError):
        port.segment_for(301, 2e5)

    bpc, bpc_ref = BPC(bpc_path), RBPC(bpc_path)
    assert [vars(s) for s in bpc.segments] == [vars(s) for s in bpc_ref.segments]
    assert (bpc.segments[0].target, bpc.segments[0].center, bpc.segments[0].data_type) == (3000, 17, 2)
    rec = bpc.chebyshev_records(bpc.segments[0])
    np.testing.assert_array_equal(rec.coeffs, bpc_ref.chebyshev_records(bpc_ref.segments[0]).coeffs)
    np.testing.assert_array_equal(rec.coeffs, cb)
    bad = tmp_path / "bad.bsp"
    bad.write_bytes(b"NOT/DAF " + bytes(2040))
    with pytest.raises(P.errors.InputOutputError):
        SPK(bad)


# ------------------------------------------------------------- the almanac
@needs_jax
def test_almanac_on_spk_kernels(files):
    """Almanac([moon, sun]) on phase 6m's SPKs in both packages: position,
    state (the exact Chebyshev derivative) and build_table (fit through
    the SPK chain) within 1e-9 km (km/s); a body no kernel covers falls
    back to the analytic series, body by body; with no kernel the port's
    analytic answers are unchanged."""
    alm_ref, alm = r_almanac.Almanac(files["spks"]), Almanac(files["spks"])
    t0 = _epoch(P).to_tdb_seconds()
    t = t0 + np.linspace(-2 * 86_400.0, HOUR + 2 * 86_400.0, 33)
    for target, center in ((NAIF.MOON, NAIF.EARTH), (NAIF.SUN, NAIF.EARTH), (NAIF.EARTH, NAIF.MOON),
                           (NAIF.MARS_BARYCENTER, NAIF.EARTH), (NAIF.SUN, NAIF.MOON)):
        np.testing.assert_allclose(alm.position(target, center, t), alm_ref.position(target, center, t),
                                   rtol=0, atol=1e-9)
        for dt in (0.0, 1234.5):
            r, v = alm.state(target, center, _epoch(P) + dt)
            r_ref, v_ref = alm_ref.state(target, center, _epoch(R) + dt)
            np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-9)
            np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-12)
    # the kernels answer for the Moon (a fit of the series, not the series)
    analytic = Almanac()
    moon_spk, moon_series = alm.position(NAIF.MOON, NAIF.EARTH, t), analytic.position(NAIF.MOON, NAIF.EARTH, t)
    assert 0.0 < np.abs(moon_spk - moon_series).max() < 1e-3
    # Mars is in no kernel: the analytic series, through the chain
    np.testing.assert_allclose(alm.position(NAIF.MARS_BARYCENTER, NAIF.EARTH, t),
                               analytic.position(NAIF.MARS_BARYCENTER, NAIF.EARTH, t), rtol=1e-12)
    # a spacecraft id no source knows raises KeyError in both
    with pytest.raises(KeyError):
        alm.position(-5, NAIF.EARTH, t)
    bodies = [NAIF.SUN, NAIF.MOON]
    tab_ref = alm_ref.build_table(bodies, NAIF.EARTH, _epoch(R), _epoch(R) + HOUR)
    tab = alm.build_table(bodies, NAIF.EARTH, _epoch(P), _epoch(P) + HOUR, device="cpu")
    np.testing.assert_allclose(tab.coeffs.numpy(), np.asarray(tab_ref.coeffs), rtol=0, atol=1e-9)
    # without kernels, the port's analytic answers to the bit
    r0 = analytic.state(NAIF.MOON, NAIF.SUN, _epoch(P))
    r0_ref = r_almanac.Almanac().state(NAIF.MOON, NAIF.SUN, _epoch(R))
    np.testing.assert_array_equal(r0[0], r0_ref[0])
    np.testing.assert_array_equal(r0[1], r0_ref[1])
    # the EphemTable's multi-body lookup equals body by body, to the bit
    tt = torch.tensor(t0 + np.linspace(0.0, HOUR, 8))
    both = tab.position([0, 1], tt)
    for i in range(2):
        np.testing.assert_array_equal(both[i].numpy(), tab.position(i, tt).numpy())


def _write_synthetic_spk(path, target, center, init, intlen, coeffs):
    """tests/test_ephem.py:233's one-segment type-2 SPK."""
    n_rec, _, deg1 = coeffs.shape
    words = []
    for i in range(n_rec):
        words += [init + (i + 0.5) * intlen, intlen / 2] + list(coeffs[i].ravel())
    words += [init, intlen, float(2 + 3 * deg1), float(n_rec)]
    _write_daf(path, "DAF/SPK", 2, 6, [((init, init + n_rec * intlen), (target, center, 1, 2), words)])


@needs_jax
def test_shifted_kernel_supersedes_analytic(tmp_path):
    """tests/test_ephem.py:272: a deliberately shifted one-record Moon
    kernel answers for the Moon, the Sun still resolves analytically; the
    port equals the reference."""
    t0 = _epoch(P).to_tdb_seconds()
    shift = np.array([12345.0, -6789.0, 4242.0])
    truth = Almanac().position(NAIF.MOON, NAIF.EARTH, np.array([t0]))[0]
    coeffs = np.zeros((1, 3, 3))
    coeffs[0, :, 0] = truth + shift
    p = tmp_path / "moon_shifted.bsp"
    _write_synthetic_spk(p, NAIF.MOON, NAIF.EARTH, t0 - 100.0, 400.0, coeffs)
    alm, alm_ref = Almanac([p]), r_almanac.Almanac([p])
    got = alm.position(NAIF.MOON, NAIF.EARTH, np.array([t0]))[0]
    np.testing.assert_allclose(got, truth + shift, atol=1e-6)
    np.testing.assert_array_equal(got, alm_ref.position(NAIF.MOON, NAIF.EARTH, np.array([t0]))[0])
    sun = alm.position(NAIF.SUN, NAIF.EARTH, np.array([t0]))[0]
    np.testing.assert_allclose(sun, Almanac().position(NAIF.SUN, NAIF.EARTH, np.array([t0]))[0], atol=1e-6)
    r, v = alm.state(NAIF.MOON, NAIF.EARTH, _epoch(P))
    r_ref, v_ref = alm_ref.state(NAIF.MOON, NAIF.EARTH, _epoch(R))
    np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-12)


@needs_jax
def test_default_almanac(tmp_path, monkeypatch, files):
    """tests/test_ephem.py:297: default_almanac under NYX_TPU_DATA skips a
    git-LFS stub and loads the real kernels, the same files in both
    packages; a model without an almanac and ShadowModel take it."""
    (tmp_path / "de440s.bsp").write_text("version https://git-lfs.github.com/spec/v1\noid sha256:abc\nsize 1\n")
    for mod in (p_almanac, r_almanac):
        monkeypatch.setattr(mod, "_DEFAULT", None)
    monkeypatch.setenv("NYX_TPU_DATA", str(tmp_path))
    alm, alm_ref = default_almanac(), r_almanac.default_almanac()
    assert alm.spks == [] and alm_ref.spks == [] and alm.bpcs == []
    assert default_almanac() is alm
    for path in files["spks"]:
        (tmp_path / Path(path).name).write_bytes(Path(path).read_bytes())
    for mod in (p_almanac, r_almanac):
        monkeypatch.setattr(mod, "_DEFAULT", None)
    alm, alm_ref = default_almanac(), r_almanac.default_almanac()
    assert [s.path.name for s in alm.spks] == [s.path.name for s in alm_ref.spks] == \
        ["moon_hifi.bsp", "sun_hifi.bsp"]
    assert p_almanac._is_real_kernel(tmp_path / "moon_hifi.bsp")
    assert not p_almanac._is_real_kernel(tmp_path / "de440s.bsp")
    assert ShadowModel.cislunar()._almanac() is alm
    ctx = SpacecraftDynamics(OrbitalDynamics.from_model(PointMasses((NAIF.MOON,)))).build_context(
        _epoch(P), HOUR, None, device="cpu")
    ctx_ref = RSpacecraftDynamics(ROrbitalDynamics.from_model(RPointMasses((NAIF.MOON,)))).build_context(
        _epoch(R), HOUR, None)
    np.testing.assert_allclose(ctx.table.coeffs.numpy(), np.asarray(ctx_ref.table.coeffs), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(
        ctx.table.coeffs.numpy(), alm.build_table([NAIF.MOON], NAIF.EARTH, _epoch(P), _epoch(P) + HOUR,
                                                  device="cpu").coeffs.numpy())


# ------------------------------------------------------------- trajectory files
@pytest.fixture(scope="module")
def traj():
    """A two-body LEO trajectory over 6 h through the port (RK89 default
    options, every accepted step), and the reference's Trajectory of the
    same nodes."""
    o = P.Orbit.keplerian(8000.0, 0.05, 40.0, 10.0, 20.0, 30.0, _epoch(P), P.Frames.EME2000)
    sc = P.Spacecraft.from_orbit(o)
    dyn = SpacecraftDynamics.new(OrbitalDynamics.two_body(P.Frames.EME2000))
    _, tr = Propagator.rk89(dyn, IntegratorOptions()).with_state(sc, device="cpu").for_duration_with_traj(21_600.0)
    return tr


@needs_jax
def test_bsp_round_trips(tmp_path, traj):
    """Trajectory.to_ephemeris -> Almanac.state within 2e-5 km and 1e-7
    km/s of the interpolant (tests/test_ephem.py:153's bounds); the
    reference's writer on the same nodes within 1e-9 km of the port's
    coefficients; both readers on the port's file; from_bsp in both
    packages within 1e-9 km, and within 5e-5 km of the interpolant."""
    sc_ref = R.Spacecraft.from_orbit(R.Orbit.cartesian(*traj.ys[0, :6], _epoch(R), R.Frames.EME2000))
    traj_ref = RTrajectory.from_capture(_epoch(R), traj.ts, traj.ys, sc_ref)
    path, path_ref = tmp_path / "traj.bsp", tmp_path / "traj_ref.bsp"
    assert traj.to_ephemeris(path, target=-10_000) == str(path)
    traj_ref.to_ephemeris(path_ref, target=-10_000)
    a, b = SPK(path), SPK(path_ref)
    assert [vars(s) for s in a.segments] == [vars(s) for s in b.segments]
    np.testing.assert_allclose(a.chebyshev_records(a.segments[0]).coeffs,
                               b.chebyshev_records(b.segments[0]).coeffs, rtol=0, atol=1e-9)
    alm, alm_ref = Almanac([path]), r_almanac.Almanac([path])
    for t_rel in (0.0, 3333.3, 10_000.0, 21_599.0):
        r, v = alm.state(-10_000, NAIF.EARTH, traj.epoch0 + t_rel)
        want = traj.interpolate(t_rel)
        np.testing.assert_allclose(r, want[:3], atol=2e-5)
        np.testing.assert_allclose(v, want[3:6], atol=1e-7)
        r_ref, v_ref = alm_ref.state(-10_000, NAIF.EARTH, _epoch(R) + t_rel)
        np.testing.assert_array_equal(r, r_ref)
        np.testing.assert_array_equal(v, v_ref)
    back = Trajectory.from_bsp(alm, -10_000, NAIF.EARTH, P.Frames.EME2000, traj.first, _epoch(P),
                               _epoch(P) + 21_000.0, step_s=600.0)
    back_ref = RTrajectory.from_bsp(alm_ref, -10_000, NAIF.EARTH, R.Frames.EME2000, sc_ref, _epoch(R),
                                    _epoch(R) + 21_000.0, step_s=600.0)
    assert len(back) == len(back_ref) == 36
    np.testing.assert_array_equal(back.ts, np.asarray(back_ref.ts))
    np.testing.assert_allclose(back.ys[:, :6], np.asarray(back_ref.ys)[:, :6], rtol=0, atol=1e-9)
    # the degree-11 fit against the interpolant at every 600 s (2.2e-5 km measured)
    np.testing.assert_allclose(back.ys[:, :3], traj.interpolate_many(back.ts)[:, :3], rtol=0, atol=5e-5)
    assert back.template.frame == P.Frames.EME2000
    with pytest.raises(P.errors.ConfigError):
        traj.to_frame(P.Frames.IAU_EARTH, device="cpu").to_ephemeris(tmp_path / "rotating.bsp")


@needs_jax
def test_parquet_and_od_solution_round_trips(tmp_path, traj):
    """to_parquet -> from_parquet in both packages (tests/test_ephem.py:180):
    the port's file read by each gives the same nodes within 1e-9 km; and
    ODSolution.to_ephemeris writes the estimates' trajectory as the BSP
    that Trajectory.to_ephemeris writes, read back at the estimates."""
    path = tmp_path / "traj.parquet"
    traj.to_parquet(path)
    back = Trajectory.from_parquet(path, traj.first)
    sc_ref = R.Spacecraft.from_orbit(R.Orbit.cartesian(*traj.ys[0, :6], _epoch(R), R.Frames.EME2000))
    back_ref = RTrajectory.from_parquet(path, sc_ref)
    assert len(back) == len(back_ref) == len(traj)
    np.testing.assert_allclose(back.ys[:, :6], traj.ys[:, :6], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(back.ts, np.asarray(back_ref.ts))
    np.testing.assert_array_equal(back.ys[:, :6], np.asarray(back_ref.ys)[:, :6])
    assert abs((back.start_epoch - traj.start_epoch).to_seconds()) < 1e-6
    with pytest.raises(P.errors.TrajError):
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(pa.table({"epoch_tai_s": [0.0]}), str(tmp_path / "bad.parquet"))
        Trajectory.from_parquet(tmp_path / "bad.parquet", traj.first)

    sol = ODSolution()
    for k in range(len(traj)):
        nominal = traj.template.set_vector(traj.epoch0 + float(traj.ts[k]), traj.ys[k])
        sol.append(KfEstimate.from_covar(nominal, np.eye(9) * 1e-6), None)
    out = sol.to_ephemeris(tmp_path / "sol.bsp", target=-7)
    expect = sol.to_traj().to_ephemeris(tmp_path / "sol_traj.bsp", target=-7)
    assert Path(out).read_bytes() == Path(expect).read_bytes()
    alm = Almanac([out])
    for e in sol.estimates[1:-1]:
        r, _ = alm.state(-7, NAIF.EARTH, e.epoch)
        np.testing.assert_allclose(r, e.state().orbit.r_km, atol=2e-5)


# ------------------------------------------------------------- configuration
@needs_jax
def test_dynamics_config_builds_hifi_models(files):
    """DynamicsConfig with an EGM2008 file (chosen by its name), solid
    tides, `stdatm` drag, point masses and SRP builds the reference's
    models: the field's tables equal, the tides and densities alike, and
    the EOM within 1e-12 relative at B = 8 (f64 throughout)."""
    cfg = dict(point_masses=(NAIF.MOON, NAIF.SUN), solid_tides=True, solar_pressure=True, drag="stdatm")
    field = dict(path=str(files["egm"]), degree=8, order=8, gunzipped=False)
    dyn = DynamicsConfig(gravity_field=dict(field, frame=P.Frames.IAU_EARTH), **cfg).build()
    dyn_ref = RDynamicsConfig(gravity_field=dict(field, frame=R.Frames.IAU_EARTH), **cfg).build()
    kinds = [type(m).__name__ for m in dyn.orbital_dyn.models]
    assert kinds == [type(m).__name__ for m in dyn_ref.orbital_dyn.models] == \
        ["PointMasses", "Harmonics", "SolidTides"]
    h, h_ref = dyn.orbital_dyn.models[1], dyn_ref.orbital_dyn.models[1]
    assert (h.max_degree, h.mu_km3_s2, h.radius_km) == (h_ref.max_degree, h_ref.mu_km3_s2, h_ref.radius_km)
    for k, v in h._tables[0].items():
        np.testing.assert_array_equal(v, np.asarray(h_ref._tables[0][k]))
    assert [type(f).__name__ for f in dyn.force_models] == ["SolarPressure", "Drag"]
    assert dyn.force_models[1].density == AtmDensity.std_atm1976()
    assert dyn.force_models[1].density.kind == dyn_ref.force_models[1].density.kind == "stdatm"
    t = dyn.orbital_dyn.models[2]
    assert (t.k2, t.k3, [vars(p) for p in t.perturbers]) == \
        (dyn_ref.orbital_dyn.models[2].k2, dyn_ref.orbital_dyn.models[2].k3,
         [vars(p) for p in dyn_ref.orbital_dyn.models[2].perturbers])
    assert DynamicsConfig(drag="exp").build().force_models[0].density == AtmDensity.earth_exponential()
    alm_ref, alm = r_almanac.Almanac(), Almanac()
    ctx_ref = dyn_ref.build_context(_epoch(R), HOUR, alm_ref)
    ctx = dyn.build_context(_epoch(P), HOUR, alm, device="cpu")
    y, t_rel = _lanes(8, 6), np.linspace(0.0, HOUR, 8)
    p = dict(dry_mass_kg=100.0, srp_area_m2=2.0, drag_area_m2=2.0)
    d_ref = np.asarray(dyn_ref.make_eom()(_j(t_rel), _j(y), ctx_ref, p))
    d = dyn.make_eom()(_t(t_rel), _t(y), ctx, p).numpy()
    assert _rel(d[:, 3:6], d_ref[:, 3:6]) < F64_REL


def test_stm_dynamics_keeps_the_dynamics():
    """ScanKalmanOD's stage-2 dynamics cut the field's derivatives to
    stm_jvp_degree and keep the guidance law, the mass decrement and the
    perturbation precision (the reference's scan_filter.py:486-490);
    `with_guidance_law` drops pert_precision, as the reference's
    (spacecraft_dyn.py:66-69)."""
    from nyx_tpu_torch.od import GroundStation, ScanKalmanOD

    stor = GravityFieldData.from_cof(JGM3, 12, 12, True, P.Frames.IAU_EARTH)
    law = object()
    dyn = SpacecraftDynamics(OrbitalDynamics.from_model(Harmonics.from_stor(stor)), (Drag.earth_exp(),),
                             guidance=law, decrement_mass=False, pert_precision="f32")
    od = ScanKalmanOD(Propagator.rk89(dyn, IntegratorOptions()), [GroundStation.dss65_madrid()],
                      stm_jvp_degree=4, device="cpu")
    s2 = od._stm_dynamics(dyn)
    assert s2 is not dyn and s2.orbital_dyn.models[0].jvp_degree == 4
    assert (s2.guidance, s2.decrement_mass, s2.pert_precision) == (law, False, "f32")
    assert s2.force_models == dyn.force_models and s2.orbital_dyn.frame == dyn.orbital_dyn.frame
    assert dyn.with_guidance_law(law).pert_precision == "f64"
    with pytest.raises(P.errors.ConfigError):
        SpacecraftDynamics(OrbitalDynamics.two_body(), pert_precision="f16")


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_f32_perturbation_eom_kernel_matches_twin_on_card(tmp_path):
    """Phase 6m's f32-perturbation EOM at B = 64 on the card: through the
    kernel and through the twin, equal to the bit (the kernel and the twin
    round alike; the rest of the EOM is the same code)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from nyx_tpu_torch.dynamics import gravity_pines

    stor21 = GravityFieldData.from_cof(JGM3, 21, 21, True, P.Frames.IAU_EARTH)
    egm, spks = chip_smoke.hifi_files(tmp_path, stor21, _epoch(P))
    field = GravityFieldData.from_egm2008(egm, 21, 21, frame=P.Frames.IAU_EARTH)
    alm = Almanac(spks)
    y = torch.tensor(_lanes(64, 7), device="cuda")
    t = torch.linspace(0.0, HOUR, 64, dtype=torch.float64, device="cuda")
    p = dict(dry_mass_kg=100.0, srp_area_m2=2.0, drag_area_m2=2.0)
    out = {}
    for backend in ("auto", "torch"):
        dyn = chip_smoke.hifi_propagator(field, "f32", backend).dynamics
        ctx = dyn.build_context(_epoch(P), HOUR, alm, device="cuda")
        gravity_pines.pines_accel_cuda.launches = 0
        out[backend] = dyn.make_eom()(t, y, ctx, p)
        assert gravity_pines.pines_accel_cuda.launches == (1 if backend == "auto" else 0)
    torch.cuda.synchronize()
    assert torch.equal(out["auto"], out["torch"])
    assert torch.isfinite(out["auto"]).all() and out["auto"].dtype == torch.float64
