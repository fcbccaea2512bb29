"""The fused EOM: `dynamics/fused_eom.py` and `csrc/eom.cu`.

On the CPU: which compositions and inputs take the fused path (the
benchmark's scenes do; the STM EOM, guidance, f32 perturbations, an f64
field, the cislunar shadow, the 1976 atmosphere, CPU tensors, forward-AD
duals and torch.func transforms do not), by the path's counters; that a
context or parameters the kernels cannot take raise rather than fall back;
and the benchmark's reader of the share of fused evaluations.

On the card (`cuda` marker): the fused evaluation against the composed one
at 65,537 lanes of 250-2,000 km altitude over several of the Sun's
Chebyshev records, with sunlit, penumbral and umbral lanes, at the
benchmark's compositions (21x21 and 70x70) and without a field; then a 1 h
RK89 run of the 21x21 scene through each path; a strided state through
the fused path. `-s` prints the gaps.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from nyx_tpu_torch import Epoch, Frames, Orbit
from nyx_tpu_torch.constants import NAIF, RADIUS_BY_NAIF
from nyx_tpu_torch.cosmic.eclipse import illumination_factor
from nyx_tpu_torch.cosmic.rotations import apply_dcm, iau_earth_dcm32_pole
from nyx_tpu_torch.cosmic.spacecraft import Thruster
from nyx_tpu_torch.dynamics import (Drag, Harmonics, LocalFrame, Maneuver, OrbitalDynamics,
                                    SolarPressure, SpacecraftDynamics, gravity_pines)
from nyx_tpu_torch.dynamics import fused_eom as F
from nyx_tpu_torch.ephem.almanac import Almanac
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.propagators import IntegratorOptions, Propagator
from nyx_tpu_torch.propagators import integrator

ROOT = Path(__file__).resolve().parents[1]
JGM3 = ROOT / "data" / "JGM3.cof.gz"
EPOCH = Epoch.from_gregorian_utc(2021, 3, 4)
PARAMS = dict(dry_mass_kg=100.0, srp_area_m2=2.0, drag_area_m2=2.0)
R_EARTH = RADIUS_BY_NAIF[NAIF.EARTH]
MU = Frames.EME2000.mu
SPAN_S = 14 * 86_400.0  # the lanes' epochs: four of the Sun's 4-day records


def _field(degree: int, precision: str = "split") -> Harmonics:
    stor = GravityFieldData.from_cof(JGM3, degree, degree, True, Frames.IAU_EARTH)
    return Harmonics.from_stor(stor, precision)


def _dyn(degree: int = 21, srp=True, drag=True, **kw) -> SpacecraftDynamics:
    orbital = (OrbitalDynamics.from_model(_field(degree), Frames.EME2000) if degree
               else OrbitalDynamics.two_body(Frames.EME2000))
    models = ([SolarPressure.default()] if srp else []) + ([Drag.earth_exp()] if drag else [])
    return SpacecraftDynamics(orbital, models, **kw)


def _scene(B: int, seed: int, device):
    """(t_rel [B], y [B, 9]): positions at 250-2,000 km, a third of
    them within 80 km of the Earth's shadow cone's edge; circular speeds in
    random directions; Cr, Cd and propellant drawn per lane."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, SPAN_S, B)
    rmag = R_EARTH + rng.uniform(250.0, 2_000.0, B)
    sun = Almanac().position(NAIF.SUN, NAIF.EARTH, EPOCH.to_tdb_seconds() + t)
    s_hat = sun / np.linalg.norm(sun, axis=1, keepdims=True)
    u = rng.normal(size=(B, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    edge = np.arange(B) % 3 == 0
    perp = u - np.sum(u * s_hat, axis=1, keepdims=True) * s_hat
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    d_perp = R_EARTH + rng.uniform(-80.0, 80.0, B)
    behind = perp * d_perp[:, None] - s_hat * np.sqrt(rmag**2 - d_perp**2)[:, None]
    r = np.where(edge[:, None], behind, u * rmag[:, None])
    w = rng.normal(size=(B, 3))
    w -= np.sum(w * r, axis=1, keepdims=True) * r / rmag[:, None] ** 2
    v = w / np.linalg.norm(w, axis=1, keepdims=True) * np.sqrt(MU / rmag)[:, None]
    y = np.concatenate([r, v, rng.uniform(1.0, 2.0, (B, 1)), rng.uniform(1.8, 2.6, (B, 1)),
                        rng.uniform(0.0, 20.0, (B, 1))], axis=1)
    k = dict(dtype=torch.float64, device=device)
    return torch.as_tensor(t, **k), torch.as_tensor(y, **k)


def _scene_module():
    spec = importlib.util.spec_from_file_location("_portbench_scene",
                                                  ROOT / "portbench" / "pbench" / "scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config", ["leo_mc_jgm3_21x21", "leo_mc_jgm3_70x70"])
def test_benchmark_scene_engages(config):
    """The benchmark's dynamics, built as its harness builds them, take the
    fused path: a split field, SRP in the Earth's shadow, exponential drag."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    dyn = _scene_module().build(cfg, ROOT, seed=1).prop.dynamics
    plan = F.plan_for(dyn, with_stm=False)
    assert plan is not None and plan.center == NAIF.EARTH
    assert plan.field.max_degree == cfg["field"]["degree"]
    assert plan.srp is not None and plan.drag is not None
    assert hasattr(dyn.make_eom(), "composed")


def _guided():
    law = Maneuver.from_time_invariant(EPOCH, EPOCH + 600.0, 1.0, [1.0, 0.0, 0.0], LocalFrame.VNC)
    return SpacecraftDynamics(OrbitalDynamics.from_model(_field(8), Frames.EME2000),
                              [SolarPressure.default()], guidance=law)


COMPOSED = {
    "stm": lambda: (_dyn(8), True),
    "guided": lambda: (_guided(), False),
    "pert_f32": lambda: (_dyn(8, pert_precision="f32"), False),
    "f64_field": lambda: (SpacecraftDynamics(
        OrbitalDynamics.from_model(_field(8, "f64"), Frames.EME2000), [Drag.earth_exp()]), False),
    "cislunar_srp": lambda: (SpacecraftDynamics(
        OrbitalDynamics.from_model(_field(8), Frames.EME2000), [SolarPressure.cislunar()]), False),
    "std_atm1976": lambda: (SpacecraftDynamics(
        OrbitalDynamics.from_model(_field(8), Frames.EME2000), [Drag.std_atm1976()]), False),
}


def _call(dyn, with_stm, t, y, *, dual=False):
    """One CPU evaluation of `dyn`'s EOM; the change in (composed calls,
    fused launches) it made."""
    ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device="cpu")
    eom = dyn.make_eom(with_stm, thruster=Thruster(1.0, 300.0) if dyn.has_guidance else None)
    n0 = (F.fused_eom.composed_calls, F.fused_eom.launches)
    if with_stm:
        y = torch.cat([y, torch.eye(9, dtype=y.dtype).reshape(1, 81).expand(len(y), 81)], dim=1)
    if dyn.has_guidance:
        y = torch.cat([y, torch.ones_like(y[:, :1])], dim=1)
    if dual:
        with fwAD.dual_level():
            out = eom(t, fwAD.make_dual(y, torch.ones_like(y)), ctx, PARAMS)
            assert fwAD.unpack_dual(out).tangent is not None
    else:
        out = eom(t, y, ctx, PARAMS)
    assert out.shape == y.shape and torch.isfinite(out).all()
    return F.fused_eom.composed_calls - n0[0], F.fused_eom.launches - n0[1]


@pytest.mark.parametrize("case", sorted(COMPOSED))
def test_composition_takes_composed_path(case):
    """Each of these compositions has no fused plan, and its evaluation is
    counted as composed."""
    dyn, with_stm = COMPOSED[case]()
    assert F.plan_for(dyn, with_stm) is None
    t, y = _scene(4, 3, "cpu")
    assert _call(dyn, with_stm, t, y) == (1, 0)


@pytest.mark.parametrize("case", ["cpu_tensor", "dual_input", "func_jvp"])
def test_input_takes_composed_path(case):
    """The benchmark's composition with an input the kernels do not take: a
    CPU tensor, a forward-AD dual, a torch.func.jvp. Each is declined and
    evaluated on the composed path."""
    dyn = _dyn(8)
    plan = F.plan_for(dyn, with_stm=False)
    assert plan is not None
    t, y = _scene(4, 5, "cpu")
    ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device="cpu")
    if case == "cpu_tensor":
        assert plan.declines(t, y)
        assert _call(dyn, False, t, y) == (1, 0)
    elif case == "dual_input":
        with fwAD.dual_level():
            assert plan.declines(t, fwAD.make_dual(y, torch.ones_like(y)))
        assert _call(dyn, False, t, y, dual=True) == (1, 0)
    else:
        eom = dyn.make_eom()
        n0 = (F.fused_eom.composed_calls, F.fused_eom.launches)
        seen = []

        def f(yy):
            seen.append(plan.declines(t, yy))
            return eom(t, yy, ctx, PARAMS)

        _, tangent = torch.func.jvp(f, (y,), (torch.ones_like(y),))
        assert seen == [True] and torch.isfinite(tangent).all()
        assert (F.fused_eom.composed_calls - n0[0], F.fused_eom.launches - n0[1]) == (1, 0)


def test_constants_follow_the_models():
    """The kernels' constants come from the model objects and the context:
    a field's J2/J3, the density's parameters, the table's records."""
    dyn = _dyn(21)
    plan = F.plan_for(dyn, with_stm=False)
    ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device="cpu")
    c = plan.consts(ctx, PARAMS)
    h, dens = plan.field, plan.drag.density
    assert (c.field, c.j3, c.srp, c.drag) == (1, 1, 1, 2)
    assert c.c2_coef == -1.5 * h.j2 and c.c3_coef == -2.5 * h.j3 and c.mu == ctx.frame.mu
    assert c.rho0 == np.float32(dens.rho0) and c.r0_m == dens.r0_m
    assert c.inv_ref_alt_m == np.float32(1.0) / np.float32(dens.ref_alt_m)
    assert c.sun_t0 == ctx.table.t0 and c.sun_coeffs == ctx.table.coeffs.shape[-1]
    assert tuple(c.sun_strides) == ctx.table.coeffs.stride()[1:]
    assert c.sun_last_rec == ctx.table.coeffs.shape[1] - 1 >= 3
    assert c.epoch0_tdb == ctx.epoch0_tdb and c.dry_mass_kg == PARAMS["dry_mass_kg"]
    two_body = F.plan_for(_dyn(0, srp=False, drag=False), with_stm=False)
    assert (two_body.field, two_body.srp, two_body.drag) == (None, None, None)


def test_unfit_context_or_parameters_raise():
    """What the kernels cannot take raises, and is never handed back to the
    composed path: a per-lane spacecraft parameter, a context of another
    frame's centre, SRP without the context's Sun table."""
    dyn = _dyn(8)
    plan = F.plan_for(dyn, with_stm=False)
    ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device="cpu")
    assert plan.consts(ctx, PARAMS).srp == 1
    for key in ("dry_mass_kg", "srp_area_m2", "drag_area_m2"):
        with pytest.raises(TypeError, match=key):
            plan.consts(ctx, {**PARAMS, key: torch.full((4,), 2.0, dtype=torch.float64)})
    with pytest.raises(ValueError, match="centred"):
        plan.consts(dataclasses.replace(ctx, frame=Frames.MOON_J2000), PARAMS)
    with pytest.raises(ValueError, match="Sun table"):
        plan.consts(dataclasses.replace(ctx, table=None), PARAMS)


def test_constants_kept_per_context_and_parameters():
    """`consts` returns the last call's constants for the same context and
    parameters, and new ones for another context or another parameter."""
    dyn = _dyn(8)
    plan = F.plan_for(dyn, with_stm=False)
    ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device="cpu")
    c = plan.consts(ctx, PARAMS)
    assert plan.consts(ctx, dict(PARAMS)) is c
    other = plan.consts(ctx, {**PARAMS, "srp_area_m2": 3.0})
    assert other is not c and other.srp_area_m2 == 3.0
    later = dyn.build_context(EPOCH + 60.0, SPAN_S, Almanac(), device="cpu")
    assert plan.consts(later, PARAMS).epoch0_tdb == later.epoch0_tdb != ctx.epoch0_tdb


def test_fused_launches_pines_through_the_module(monkeypatch):
    """The fused path reaches the Pines kernel through `gravity_pines`'
    module global, as the composed path does, so whatever stands in for
    `pines_accel_cuda` there (a tally of launches by thread) sees every
    launch. The kernels are CPU fakes here; the plan and the call are real."""
    dyn = _dyn(8)
    plan = F.plan_for(dyn, with_stm=False)
    ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device="cpu")
    t, y = _scene(4, 17, "cpu")
    seen = []

    def kernel(r_bf, tab, q_lo, **kw):
        seen.append((tuple(r_bf.shape), q_lo, kw["W"]))
        return torch.zeros_like(r_bf)

    monkeypatch.setattr(gravity_pines, "pines_accel_cuda", kernel)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(F, "eom_pre", lambda t_rel, yy, c: yy[:, :3].to(torch.float32))
    monkeypatch.setattr(F, "eom_post", lambda t_rel, yy, a_bf, sun, c: torch.zeros_like(yy))
    n0 = F.fused_eom.launches
    out = F.fused_eom(plan, t, y, ctx, PARAMS)
    assert seen == [((4, 3), 0, plan.field.pines_args()["W"])]
    assert out.shape == y.shape and F.fused_eom.launches == n0 + 1


def _metric_reader():
    spec = importlib.util.spec_from_file_location("_portbench_eom_fused_pct",
                                                  ROOT / "portbench" / "metrics" / "eom_fused_pct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("fused,pines,want", [(96, 96, 100.0), (0, 96, 0.0), (48, 96, 50.0),
                                              (0, 0, None)])
def test_eom_fused_pct_reads_the_share(fused, pines, want):
    """The benchmark's `eom_fused_pct`: `eom_post` launches over Pines
    launches, 0 where no evaluation fused (the regression it guards), None
    where the ensemble counted no Pines launch."""
    by_name = {"pines_kernel(float const*)": (1.5, pines), "eom_pre_kernel": (0.03, fused)}
    if fused:
        by_name["eom_post_kernel(EomConsts)"] = (0.08, fused)
    run = SimpleNamespace(summary={"by_name": by_name}, window=SimpleNamespace(pines_launches=pines))
    assert _metric_reader()(run) == want
    assert _metric_reader()(SimpleNamespace(summary=None, window=run.window)) is None


def _ulps(a, b):
    """Largest distance in f32 units in the last place between `a` and `b`."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


@pytest.mark.cuda
def test_fused_matches_composed_on_card():
    """At each composition: the velocity columns equal, columns 6-8 zero,
    the acceleration within 1e-12 km/s^2 with a field (the f32 field's
    rounding) and 1e-15 without (about 1e-5 of the SRP or drag term), the
    Pines input within 2 f32 ulps of the composed rotation, one fused launch
    an evaluation and one Pines launch with a field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    dev = torch.device("cuda")
    B = 65_537
    t, y = _scene(B, 11, dev)
    cases = [("21x21", _dyn(21), 1e-12), ("70x70", _dyn(70), 1e-12),
             ("two-body+SRP", _dyn(0, drag=False), 1e-15),
             ("two-body+drag", _dyn(0, srp=False), 1e-15)]
    for name, dyn, tol in cases:
        ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device=dev)
        eom = dyn.make_eom()
        plan = F.plan_for(dyn, with_stm=False)
        assert plan is not None and not plan.declines(t, y)
        n_f, n_p = F.fused_eom.launches, gravity_pines.pines_accel_cuda.launches
        fused = eom(t, y, ctx, PARAMS)
        torch.cuda.synchronize()
        assert F.fused_eom.launches == n_f + 1, name
        assert gravity_pines.pines_accel_cuda.launches == n_p + (plan.field is not None), name
        composed = eom.composed(t, y, ctx, PARAMS)
        assert torch.equal(fused[:, :3], y[:, 3:6]) and torch.equal(fused[:, :3], composed[:, :3])
        assert torch.equal(fused[:, 6:], torch.zeros_like(fused[:, 6:]))
        gap = (fused[:, 3:6] - composed[:, 3:6]).abs().max().item()
        bits = int((fused[:, 3:6] != composed[:, 3:6]).any(dim=1).sum())
        print(f"\n{name}: acceleration gap {gap:.3e} km/s^2, {bits} of {B} lanes differ")
        assert gap <= tol, name
        if plan.field is not None:
            r_bf = F.eom_pre(t, y, plan.consts(ctx, PARAMS))
            dcm32, _ = iau_earth_dcm32_pole(ctx.epoch0_tdb + t)
            ulps = _ulps(r_bf, apply_dcm(dcm32, y[:, :3].to(torch.float32)))
            print(f"{name}: eom_pre within {ulps} f32 ulps of the composed rotation")
            assert ulps <= 2, name

    # the lanes hold every kind of illumination
    ctx = _dyn(0, drag=False).build_context(EPOCH, SPAN_S, Almanac(), device=dev)
    r32 = y[:, :3].to(torch.float32)
    sun = ctx.table.position(ctx.table.index_of(NAIF.SUN), ctx.epoch0_tdb + t, dtype=torch.float32)
    k = illumination_factor(sun - r32, [(-r32, R_EARTH)])
    lit, umbra = int((k == 1).sum()), int((k == 0).sum())
    penumbra = int(((k > 0) & (k < 1)).sum())
    print(f"lanes: {lit} sunlit, {penumbra} penumbral, {umbra} umbral")
    assert lit > 0 and umbra > 0 and penumbra > 0


@pytest.mark.cuda
def test_fused_rk89_hour_on_card():
    """4,096 lanes of the 21x21 scene over 1 h of RK89 at 1e-9: the fused
    and the composed EOM take the same iterations and end within 1e-5 km."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    dev = torch.device("cuda")
    dyn = _dyn(21)
    orbit = Orbit.keplerian(7136.6, 0.0002, 51.6, 30.0, 65.0, 80.0, EPOCH, Frames.EME2000)
    rng = np.random.default_rng(7)
    y0 = np.concatenate([np.asarray(orbit.r_km), np.asarray(orbit.v_km_s), [1.8, 2.2, 0.0]])
    y0 = y0 + np.concatenate([rng.normal(0, 1.0, (4096, 3)), rng.normal(0, 1e-3, (4096, 3)),
                              np.zeros((4096, 3))], axis=1)
    y0 = torch.as_tensor(y0, dtype=torch.float64, device=dev)
    prop = Propagator.rk89(dyn, IntegratorOptions.with_adaptive_step(0.1, 2700.0, 1e-9))
    ctx = dyn.build_context(EPOCH, 3600.0, Almanac(), device=dev)
    eom, fin = dyn.make_eom(), dyn.make_finally()
    runs = []
    for f in (eom, eom.composed):
        n0 = F.fused_eom.launches
        res = integrator.propagate(f, y0, 3600.0, prop.opts, prop.method, finally_fn=fin,
                                   eom_args=(ctx, PARAMS))
        runs.append((res, F.fused_eom.launches - n0))
    (fused, n_fused), (composed, n_composed) = runs
    gap = (fused.y[:, :3] - composed.y[:, :3]).norm(dim=1).max().item()
    print(f"\n1 h RK89: {fused.iterations} iterations fused, {composed.iterations} composed, "
          f"{n_fused} fused evaluations; finals {gap:.3e} km apart")
    assert n_fused > 0 and n_composed == 0
    assert fused.iterations == composed.iterations
    assert gap <= 1e-5


@pytest.mark.cuda
def test_strided_state_runs_fused_on_card():
    """A strided state and time (views into wider buffers) take the fused
    path, copied to contiguous ones, and give the contiguous input's
    derivative bit for bit; a per-lane parameter raises on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    dev = torch.device("cuda")
    t, y = _scene(4_097, 13, dev)
    dyn = _dyn(21)
    ctx = dyn.build_context(EPOCH, SPAN_S, Almanac(), device=dev)
    eom = dyn.make_eom()
    wide = torch.cat([y, torch.ones_like(y[:, :3])], dim=1)[:, :9]
    t2 = torch.stack([t, t], dim=1)[:, 0]
    assert not (wide.is_contiguous() or t2.is_contiguous())
    n_f, n_c = F.fused_eom.launches, F.fused_eom.composed_calls
    strided = eom(t2, wide, ctx, PARAMS)
    assert (F.fused_eom.launches - n_f, F.fused_eom.composed_calls - n_c) == (1, 0)
    assert torch.equal(strided, eom(t, y, ctx, PARAMS))
    with pytest.raises(TypeError, match="drag_area_m2"):
        eom(t, y, ctx, {**PARAMS, "drag_area_m2": torch.full((len(t),), 2.0, device=dev)})
