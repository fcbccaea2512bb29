"""SpacecraftDynamics: the composition root.

Torch port of nyx_tpu/dynamics/spacecraft_dyn.py: orbital dynamics + force
models (SRP, drag) + an optional guidance law with propellant decrement, as
one batched EOM over `[B, 9]` float64 states [x,y,z,vx,vy,vz,Cr,Cd,m_prop],
with the STM over `[B, 90]` states. Guided dynamics append the guidance
mode as a trailing column (`[B, 10]`, or `[B, 91]` with the STM), which
the post-step hook updates.
The force models evaluate in float32 and their sum is cast back to the
state dtype. With `pert_precision="f32"` the orbital perturbations (the
field, third bodies, tides) also run on float32 r and v, and their sum is
cast back; two-body stays at the state dtype.
On the card, the compositions that `fused_eom.plan_for` names evaluate in
two hand-written kernels around the Pines launch (`csrc/eom.cu`), with the
same operations in the same order; every other evaluation, and every one
on the CPU, runs the composed EOM below.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import torch
import torch.autograd.forward_ad as fwAD

from ..constants import STD_GRAVITY_M_S2
from ..errors import ConfigError
from ..time import Epoch
from ..tracing import annotate
from ..xmath import FORWARD_AD
from .fused_eom import fused_eom, plan_for
from .gravity_pines import COUNT_LOCK
from .orbital import EomContext, OrbitalDynamics

CORE_DIM = 9
STM_DIM = CORE_DIM * CORE_DIM
# the EOM's span around a force model, by its class; `eom.<class>` otherwise
_SPAN_NAMES = {"SolarPressure": "eom.srp"}


class SpacecraftDynamics:
    def __init__(self, orbital_dyn: OrbitalDynamics, force_models: Sequence = (),
                 guidance=None, decrement_mass: bool = True, pert_precision: str = "f64"):
        self.orbital_dyn = orbital_dyn
        self.force_models = tuple(force_models)
        self.guidance = guidance
        self.decrement_mass = decrement_mass
        #: "f64": every acceleration at the state dtype. "f32": two-body and
        #: the state update stay f64, and `orbital_dyn.perturbation_accel`
        #: runs on r and v cast to f32 (the reference's
        #: spacecraft_dyn.py:143-152). Its models keep the reference's
        #: promotion: an f64-precision field then runs at f32 (through the
        #: kernel on the card), while third bodies and tides, fed f64 tables
        #: and rotations, come back f64.
        if pert_precision not in ("f64", "f32"):
            raise ConfigError(f"unknown pert_precision {pert_precision!r}")
        self.pert_precision = pert_precision

    # the reference's constructors SpacecraftDynamics::new / from_models
    @classmethod
    def new(cls, orbital_dyn) -> "SpacecraftDynamics":
        return cls(orbital_dyn)

    @classmethod
    def from_models(cls, orbital_dyn, force_models) -> "SpacecraftDynamics":
        return cls(orbital_dyn, force_models)

    @classmethod
    def from_guidance_law(cls, orbital_dyn, guidance, decrement_mass=True) -> "SpacecraftDynamics":
        return cls(orbital_dyn, (), guidance, decrement_mass)

    def with_guidance_law(self, guidance) -> "SpacecraftDynamics":
        # as the reference's (spacecraft_dyn.py:66-69), pert_precision is
        # not carried over: the guided copy runs its perturbations at f64
        return SpacecraftDynamics(self.orbital_dyn, self.force_models, guidance, self.decrement_mass)

    @property
    def has_guidance(self) -> bool:
        return self.guidance is not None

    def state_dim(self, with_stm: bool = False) -> int:
        n = CORE_DIM + (STM_DIM if with_stm else 0)
        return n + 1 if self.has_guidance else n  # guidance mode column (last)

    def required_bodies(self):
        bodies = list(self.orbital_dyn.required_bodies())
        for fm in self.force_models:
            bodies.extend(fm.required_bodies())
        if self.guidance is not None:
            bodies.extend(self.guidance.required_bodies())
        seen, out = set(), []
        center = self.orbital_dyn.frame.center
        for b in bodies:
            if b != center and b not in seen:
                seen.add(b)
                out.append(b)
        return out

    def build_context(self, epoch0: Epoch, duration_s: float, almanac=None, *, device) -> EomContext:
        """Constants of one propagation: its TDB start and, when a model
        needs bodies, their Chebyshev table over the arc on `device`, from
        `almanac` or, if None, `default_almanac()`."""
        frame = self.orbital_dyn.frame
        bodies = self.required_bodies()
        table = None
        if bodies:
            if almanac is None:
                from ..ephem.almanac import default_almanac

                almanac = default_almanac()
            end = epoch0 + max(duration_s, 0.0)
            start = epoch0 + min(duration_s, 0.0)
            table = almanac.build_table(bodies, frame.center, start, end, device=device)
        return EomContext(epoch0_tdb=epoch0.to_tdb_seconds(), table=table, frame=frame)

    def make_eom(self, with_stm: bool = False, thruster=None):
        """`eom(t_rel_s [B], y [B, N], ctx, sc_params) -> [B, N]`. `sc_params`
        holds dry_mass_kg, srp_area_m2 and drag_area_m2 (floats).

        With a guidance law, N = 10: the state and the guidance mode, whose
        derivative is zero; the law's direction and throttle add the
        thrust `throttle F / (m 1000)` km/s^2 of `thruster` and, with
        `decrement_mass`, the mass flow -F / (Isp g0).

        with_stm=True: the EOM of [B, 90] states, the 9 of the state and
        the 81 of its row-major STM Phi, with Phi' = A Phi and A = d(y9')/d(y9)
        from 9 forward-mode passes. The reference vmaps one jvp over the 9
        unit tangents; here they are folded into the batch axis of one
        forward-mode pass over [9B, 9] (autograd's dual tensors: the same
        derivatives as `torch.func.jvp`, bit for bit, at half its host cost
        an operation), so the gravity kernel, which cannot run under vmap,
        takes the primal of every pass in one launch. Lane
        block 0 of that primal is the state derivative: lanes are
        independent, so it is the [B, 9] EOM's value bit for bit. Guided,
        the state is [B, 91], the mode last (the reference's layout,
        spacecraft_dyn.py:189-213), and A includes the thrust's
        dependence on the state through the law's direction and the mass.

        Where `fused_eom.plan_for` accepts the composition, the returned
        EOM runs `fused_eom` on each input that `FusedPlan.declines` does
        not decline, and on the rest the composed EOM, which its `composed`
        attribute holds."""
        core = self._core_eom(thruster)
        guided = self.has_guidance
        if guided and thruster is None:
            raise ConfigError("guided dynamics need the spacecraft's thruster")
        plan = plan_for(self, with_stm)
        if plan is not None:
            def fused_or_composed(t_rel, y, ctx, p):
                if plan.declines(t_rel, y):
                    return core(t_rel, y, ctx, p)
                with annotate("eom.call"):
                    return fused_eom(plan, t_rel, y, ctx, p)

            fused_or_composed.composed = core
            return fused_or_composed
        if guided and not with_stm:
            def guided_eom(t_rel, y, ctx, p):
                ydot = core(t_rel, y[:, :CORE_DIM], ctx, p, y[:, CORE_DIM])
                return torch.cat([ydot, torch.zeros_like(y[:, CORE_DIM:])], dim=-1)

            return guided_eom
        if not with_stm:
            return core

        def eom(t_rel, y, ctx, p):
            B = y.shape[0]
            y9 = y[:, :CORE_DIM]
            mode9 = None
            if guided:
                # the folded batch tiles the lanes (block j holds every lane
                # in order), so the mode and per-lane guidance parameters
                # tile the same way, never interleave
                mode9 = y[:, -1].repeat(CORE_DIM)
                gp = ctx.guidance_params
                if isinstance(gp, torch.Tensor) and gp.dim() == 2:
                    ctx = replace(ctx, guidance_params=gp.repeat(CORE_DIM, 1))
            eye = torch.eye(CORE_DIM, dtype=y.dtype, device=y.device)
            with FORWARD_AD, fwAD.dual_level():
                out = fwAD.unpack_dual(core(t_rel.repeat(CORE_DIM),
                                            fwAD.make_dual(y9.repeat(CORE_DIM, 1), eye.repeat_interleave(B, dim=0)),
                                            ctx, p, mode9))
            ydot, cols = out.primal, out.tangent
            # cols[j*B + b, i] = A[b, i, j]
            a_mat = cols.reshape(CORE_DIM, B, CORE_DIM).permute(1, 2, 0)
            phi = y[:, CORE_DIM:CORE_DIM + STM_DIM].reshape(B, CORE_DIM, CORE_DIM)
            parts = [ydot[:B], torch.matmul(a_mat, phi).reshape(B, STM_DIM)]
            if guided:
                parts.append(torch.zeros_like(y[:, -1:]))  # the mode has no dynamics
            return torch.cat(parts, dim=-1)

        return eom

    def _core_eom(self, thruster):
        guidance = self.guidance
        decrement_mass = self.decrement_mass
        pert_f32 = self.pert_precision == "f32"
        # each force model with its span's name, named once here
        force_models = tuple(
            (fm, _SPAN_NAMES.get(type(fm).__name__, f"eom.{type(fm).__name__.lower()}"))
            for fm in self.force_models)

        def eom(t_rel, y9, ctx, p, mode=None):
            with COUNT_LOCK:
                fused_eom.composed_calls += 1
            with annotate("eom.call"):
                t_tdb = ctx.epoch0_tdb + t_rel
                r = y9[..., 0:3]
                v = y9[..., 3:6]
                cr = y9[..., 6]
                cd = y9[..., 7]
                m_prop = y9[..., 8]
                mass = p["dry_mass_kg"] + m_prop
                if pert_f32 and r.dtype == torch.float64 and self.orbital_dyn.models:
                    with annotate("eom.two_body"):
                        a = self.orbital_dyn.two_body_accel(ctx, r)
                    with annotate("eom.gravity"):
                        ap = self.orbital_dyn.perturbation_accel(ctx, t_tdb, r.to(torch.float32),
                                                                 v.to(torch.float32))
                    a = a + ap.to(r.dtype)
                else:
                    with annotate("eom.gravity"):
                        a = self.orbital_dyn.accel(ctx, t_tdb, r, v)
                if force_models:
                    # SRP and drag are <= ~1e-9 km/s^2: f32 rounding of the force
                    # lands far below the integrator tolerance on the total
                    fdt = torch.float32 if r.dtype == torch.float64 else r.dtype
                    sc32 = dict(
                        cr=cr.to(fdt),
                        cd=cd.to(fdt),
                        srp_area_m2=p["srp_area_m2"],
                        drag_area_m2=p["drag_area_m2"],
                        mass_kg=mass.to(fdt),
                    )
                    r32, v32 = r.to(fdt), v.to(fdt)
                    f = torch.zeros_like(r32)
                    for fm, name in force_models:
                        with annotate(name):
                            f = f + fm.force_per_mass(ctx, t_tdb, r32, v32, sc32)
                    a = a + f.to(r.dtype)
                mdot = torch.zeros_like(m_prop)
                if guidance is not None:
                    with annotate("eom.guidance"):
                        u, throttle = guidance.direction_and_throttle(ctx, t_tdb, y9, mode)
                    f_n = throttle * thruster.thrust_N
                    a = a + (f_n / (mass * 1e3))[..., None] * u
                    if decrement_mass:
                        mdot = -f_n / (thruster.isp_s * STD_GRAVITY_M_S2)
                zeros = torch.zeros_like(cr)
                return torch.cat([v, a, torch.stack([zeros, zeros, mdot], dim=-1)], dim=-1)

        return eom

    def make_finally(self):
        """Post-accepted-step hook: clamps Cr into [0, 2], then, with a
        guidance law, sets the mode column to the law's next mode."""
        guidance = self.guidance

        def finally_fn(t_rel, y, ctx, p):
            y = y.clone()
            y[..., 6] = torch.clamp(y[..., 6], 0.0, 2.0)
            if guidance is not None:
                t_tdb = ctx.epoch0_tdb + t_rel
                y[..., -1] = guidance.next_mode(ctx, t_tdb, y[..., 0:CORE_DIM], y[..., -1])
            return y

        return finally_fn
