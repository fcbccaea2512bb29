"""Guidance laws: the Ruggiero locally-optimal low-thrust law.

Torch port of nyx_tpu/dynamics/guidance.py (the reference's GuidanceLaw
trait, guidance/mod.rs:111-149, and Ruggiero, ruggiero.rs:40-510). A law
gives two batched functions that the integrator's EOM and its post-step
hook call on float64 tensors, with no host synchronization:

  direction_and_throttle(ctx, t_tdb, y9, mode) -> (u_inertial [B, 3], throttle [B])
  next_mode(ctx, t_tdb, y9, mode) -> mode' [B]

Mode transitions are masks over the lane axis, applied after every
accepted step as the reference's Dynamics::finally does. Finite-burn
maneuvers, Kluever and the replay and parametric laws are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch.linalg import vector_norm

from ..constants import NAIF, RADIUS_BY_NAIF
from ..cosmic.eclipse import occultation_percentage
from ..cosmic.orbit import keplerian_from_cartesian, rcn_dcm, ric_dcm, vnc_dcm
from ..cosmic.spacecraft import GuidanceMode
from ..errors import GuidanceConfigError
from ..md.objective import Objective
from ..md.param import StateParameter

HALF_PI = math.pi / 2.0


# Angle/vector helpers (guidance/mod.rs:129-149)
def unit_vector_from_plane_angles(alpha, beta):
    """In-plane angle alpha, out-of-plane angle beta -> unit vector in the
    local (RCN) frame (mod.rs:129-135)."""
    return torch.stack(
        [torch.sin(alpha) * torch.cos(beta), torch.cos(alpha) * torch.cos(beta), torch.sin(beta)],
        dim=-1,
    )


def plane_angles_from_unit_vector(vhat):
    """(alpha, beta) radians from a unit vector (mod.rs:138-140)."""
    return torch.atan2(vhat[..., 1], vhat[..., 0]), torch.arcsin(vhat[..., 2])


def unit_vector_from_ra_dec(alpha, delta):
    """Right ascension / declination -> unit vector (mod.rs:143-149)."""
    return torch.stack(
        [torch.cos(delta) * torch.cos(alpha), torch.cos(delta) * torch.sin(alpha), torch.sin(delta)],
        dim=-1,
    )


def ra_dec_from_unit_vector(vhat):
    return torch.atan2(vhat[..., 1], vhat[..., 0]), torch.arcsin(vhat[..., 2])


def _cbrt(x):
    """Real cube root, negative arguments included (torch has no cbrt)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


class LocalFrame:
    """Local orbital frame tags (guidance/mod.rs LocalFrame)."""

    Inertial = "inertial"
    RIC = "ric"
    VNC = "vnc"
    RCN = "rcn"

    @staticmethod
    def dcm_to_inertial(frame: str, r, v):
        """[..., 3, 3] DCM local -> inertial (transpose of the row-frames)."""
        if frame == LocalFrame.Inertial:
            return torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[:-1] + (3, 3))
        dcm = {LocalFrame.RIC: ric_dcm, LocalFrame.VNC: vnc_dcm, LocalFrame.RCN: rcn_dcm}[frame](r, v)
        return dcm.transpose(-1, -2)


class GuidanceLaw:
    """Interface contract (guidance/mod.rs:111-127). Concrete laws override
    the two batched hooks; `required_bodies` lists the ephemeris bodies the
    law needs in the EomContext (the Sun for eclipse gating, say)."""

    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        raise NotImplementedError

    def next_mode(self, ctx, t_tdb, y9, mode):
        return mode

    def required_bodies(self) -> Tuple[int, ...]:
        return ()


_RUGGIERO_PARAMS = (
    StateParameter.SMA,
    StateParameter.ECC,
    StateParameter.INC,
    StateParameter.RAAN,
    StateParameter.AOP,
)


@dataclass
class Ruggiero(GuidanceLaw):
    """Closed-loop locally-optimal low-thrust law (IEPC 2011-102), the
    reference's `Ruggiero` (ruggiero.rs:40-46). Objectives over up to five
    Keplerian elements (sma km, ecc, inc/raan/aop deg) with per-element
    efficiency thresholds and an optional coast-in-eclipse gate."""

    objectives: Tuple[Objective, ...]
    init_values: Tuple[float, ...]  # objective parameters at the initial state
    eta_thresholds: Tuple[float, ...] = ()
    max_eclipse_prct: Optional[float] = None
    shadow_bodies: Tuple[int, ...] = (NAIF.EARTH,)
    #: read the per-objective efficiency thresholds from
    #: `ctx.guidance_params` ([n_obj] or per-lane [B, n_obj]) instead of
    #: `eta_thresholds`, so one batched run carries a population of laws
    #: (the reference's raise_optim.rs NSGA-II individuals)
    ctx_eta_thresholds: bool = False

    # -- constructors (ruggiero.rs:54-152) -----------------------------
    @classmethod
    def simple(cls, objectives: Sequence[Objective], initial) -> "Ruggiero":
        return cls.from_thresholds(objectives, [0.0] * len(objectives), initial)

    @classmethod
    def from_thresholds(cls, objectives, eta_thresholds, initial) -> "Ruggiero":
        objectives = tuple(objectives)
        if not 1 <= len(objectives) <= 5:
            raise GuidanceConfigError(f"must provide between 1 and 5 objectives, got {len(objectives)}")
        for obj in objectives:
            if obj.parameter not in _RUGGIERO_PARAMS:
                raise GuidanceConfigError(f"objective {obj.parameter} not supported in Ruggiero")
        init_values = tuple(float(initial.orbit.value(obj.parameter)) for obj in objectives)
        return cls(objectives, init_values, tuple(eta_thresholds))

    @classmethod
    def from_ctx_thresholds(cls, objectives, initial) -> "Ruggiero":
        """Thresholds supplied at propagation time through
        `ctx.guidance_params` (see `ctx_eta_thresholds`); the batched form of
        the reference's `Ruggiero::from_ηthresholds` (raise_optim.rs:181)."""
        law = cls.from_thresholds(objectives, [0.0] * len(objectives), initial)
        law.ctx_eta_thresholds = True
        return law

    @classmethod
    def from_max_eclipse(cls, objectives, initial, max_eclipse,
                         shadow_bodies=(NAIF.EARTH,)) -> "Ruggiero":
        law = cls.simple(objectives, initial)
        law.max_eclipse_prct = max_eclipse
        law.shadow_bodies = tuple(shadow_bodies)
        return law

    def required_bodies(self):
        if self.max_eclipse_prct is None:
            return ()
        return (NAIF.SUN,) + tuple(self.shadow_bodies)

    # ------------------------------------------------------------------
    @staticmethod
    def _osc_value(param: str, kep):
        """Objective-parameter value in the reference's units (km / deg)."""
        if param == StateParameter.SMA:
            return kep["sma"]
        if param == StateParameter.ECC:
            return kep["ecc"]
        return torch.rad2deg(kep[param])  # inc / raan / aop

    @staticmethod
    def efficiency(param: str, kep, mu, vmag):
        """eta in [0, 1] of correcting `param` at the osculating orbit
        (ruggiero.rs:159-214)."""
        e = kep["ecc"]
        ta = kep["ta"]
        w = kep["aop"]
        if param == StateParameter.SMA:
            a = kep["sma"]
            return vmag * torch.sqrt((a * (1.0 - e)) / (mu * (1.0 + e)))
        if param == StateParameter.ECC:
            num = 1.0 + 2.0 * e * torch.cos(ta) + torch.cos(ta) ** 2
            return num / (2.0 * (1.0 + e * torch.cos(ta)))
        if param == StateParameter.INC:
            num = torch.abs(torch.cos(w + ta)) * (
                torch.sqrt(1.0 - e**2 * torch.sin(w) ** 2) - e * torch.abs(torch.cos(w))
            )
            return num / (1.0 + e * torch.cos(ta))
        if param == StateParameter.RAAN:
            num = torch.abs(torch.sin(w + ta)) * (
                torch.sqrt(1.0 - e**2 * torch.cos(w) ** 2) - e * torch.abs(torch.sin(w))
            )
            return num / (1.0 + e * torch.cos(ta))
        return torch.ones_like(e)  # AoP

    def _weight(self, i, kep, mu, vmag, thr=None):
        """Correction weight for objective i, zero when achieved or below the
        efficiency threshold (ruggiero.rs:216-240). `thr` overrides the
        static threshold with a per-lane tensor."""
        obj = self.objectives[i]
        init = self.init_values[i]
        target = obj.desired_value
        tol = obj.tolerance
        osc = self._osc_value(obj.parameter, kep)
        eta = self.efficiency(obj.parameter, kep, mu, vmag)
        if thr is None:
            thr = self.eta_thresholds[i] if i < len(self.eta_thresholds) else 0.0
        denom_init = init + tol if abs(init - target) < tol else init
        weight = (target - osc) / abs(target - denom_init)
        # The reference's smooth ramp across [tol, 2 tol] instead of a hard
        # zero at |err| < tol: a thrust cut inside an RK step would collapse
        # the step to min_step where an element sits at the tolerance.
        gate = torch.clamp(torch.abs(osc - target) / tol - 1.0, 0.0, 1.0)
        gate = torch.where(eta < thr, 0.0, gate)
        return weight * gate

    def _steering_rcn(self, kep, mu, rmag, vmag, thresholds=None):
        """Unit steering vector in the RCN frame (ruggiero.rs direction)."""
        e = kep["ecc"]
        ta = kep["ta"]
        inc = kep["inc"]
        aop = kep["aop"]
        zeros = torch.zeros_like(e)
        # eccentric anomaly (elliptic)
        ea = torch.atan2(torch.sqrt(1.0 - e**2) * torch.sin(ta), e + torch.cos(ta))
        steering = 0.0
        for i, obj in enumerate(self.objectives):
            thr = None if thresholds is None else thresholds[..., i]
            w = self._weight(i, kep, mu, vmag, thr=thr)
            p = obj.parameter
            if p == StateParameter.SMA:
                alpha = torch.atan2(e * torch.sin(ta), 1.0 + e * torch.cos(ta))
                u = unit_vector_from_plane_angles(alpha, zeros)
            elif p == StateParameter.ECC:
                alpha = torch.atan2(torch.sin(ta), torch.cos(ta) + torch.cos(ea))
                u = unit_vector_from_plane_angles(alpha, zeros)
            elif p == StateParameter.INC:
                beta = HALF_PI * torch.sign(torch.cos(ta + aop))
                u = unit_vector_from_plane_angles(zeros, beta)
            elif p == StateParameter.RAAN:
                beta = HALF_PI * torch.sign(torch.sin(ta + aop))
                u = unit_vector_from_plane_angles(zeros, beta)
            else:  # AOP (ruggiero.rs:362-388)
                oe2 = 1.0 - e**2
                e3 = e**3
                sqrt_val = torch.sqrt(0.25 * (oe2 / e3) ** 2 + 1.0 / 27.0)
                opti_ta_alpha = torch.arccos(torch.clamp(
                    _cbrt(oe2 / (2.0 * e3) + sqrt_val) - _cbrt(-oe2 / (2.0 * e3) + sqrt_val) - 1.0 / e,
                    -1.0, 1.0,
                ))
                opti_ta_beta = torch.arccos(torch.clamp(-e * torch.cos(aop), -1.0, 1.0)) - aop
                in_plane = torch.abs(ta - opti_ta_alpha) < torch.abs(ta - opti_ta_beta)
                pp = kep["sma"] * oe2
                alpha = torch.atan2(-pp * torch.cos(ta), (pp + rmag) * torch.sin(ta))
                u_in = unit_vector_from_plane_angles(alpha, zeros)
                beta = HALF_PI * torch.sign(-torch.sin(ta + aop)) * torch.cos(inc)
                u_out = unit_vector_from_plane_angles(zeros, beta)
                u = torch.where(in_plane[..., None], u_in, u_out)
            steering = steering + u * w[..., None]
        nrm = vector_norm(steering, dim=-1, keepdim=True)
        return torch.where(nrm > 0.0, steering / torch.where(nrm > 0.0, nrm, 1.0), 0.0)

    # -- the batched GuidanceLaw hooks ---------------------------------
    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        r = y9[..., 0:3]
        v = y9[..., 3:6]
        mu = ctx.frame.mu
        kep = keplerian_from_cartesian(r, v, mu)
        thresholds = None
        if self.ctx_eta_thresholds:
            if ctx.guidance_params is None:
                raise GuidanceConfigError(
                    "Ruggiero.from_ctx_thresholds needs ctx.guidance_params "
                    "([n_obj] or [B, n_obj] efficiency thresholds)"
                )
            thresholds = ctx.guidance_params
        steer_rcn = self._steering_rcn(kep, mu, vector_norm(r, dim=-1), vector_norm(v, dim=-1), thresholds)
        dcm = LocalFrame.dcm_to_inertial(LocalFrame.RCN, r, v)
        u = torch.einsum("...ij,...j->...i", dcm, steer_rcn)
        thrusting = mode == GuidanceMode.Thrust
        throttle = (thrusting & (vector_norm(steer_rcn, dim=-1) > 0.0)).to(y9.dtype)
        return torch.where(thrusting[..., None], u, 0.0), throttle

    def _achieved_mask(self, kep):
        ok = None
        for obj in self.objectives:
            osc = self._osc_value(obj.parameter, kep)
            err = obj.desired_value - (obj.multiplicative_factor * osc + obj.additive_factor)
            if obj.parameter in StateParameter.ANGLES_DEG:
                err = torch.remainder(err + 180.0, 360.0) - 180.0
            this = torch.abs(err) <= obj.tolerance
            ok = this if ok is None else ok & this
        return ok

    def next_mode(self, ctx, t_tdb, y9, mode):
        """Thrust until every objective is achieved; with max_eclipse_prct,
        coast while the Sun is more occulted than that (ruggiero.rs:425-455).
        The occultation is taken at the state's dtype."""
        r = y9[..., 0:3]
        v = y9[..., 3:6]
        kep = keplerian_from_cartesian(r, v, ctx.frame.mu)
        achieved = self._achieved_mask(kep)
        want = torch.where(achieved, float(GuidanceMode.Coast), torch.full_like(mode, GuidanceMode.Thrust))
        if self.max_eclipse_prct is not None:
            r_sun = ctx.table.position(ctx.body_index(NAIF.SUN), t_tdb) - r
            pct = torch.zeros_like(mode)
            for body in self.shadow_bodies:
                if body == ctx.frame.center:
                    r_occ = -r
                else:
                    r_occ = ctx.table.position(ctx.body_index(body), t_tdb) - r
                pct = torch.maximum(pct, occultation_percentage(r_sun, r_occ, RADIUS_BY_NAIF[body]))
            want = torch.where((~achieved) & (pct > self.max_eclipse_prct), float(GuidanceMode.Coast), want)
        return torch.where(mode == GuidanceMode.Inhibit, mode, want)

    # -- host-side status (ruggiero.rs:243-256) -------------------------
    def achieved(self, sc) -> bool:
        return all(obj.assess_raw(sc.orbit.value(obj.parameter))[0] for obj in self.objectives)

    def status(self, sc):
        out = []
        for obj in self.objectives:
            ok, err = obj.assess_raw(sc.orbit.value(obj.parameter))
            out.append(f"{obj.parameter} achieved: {ok}\t error = {err:.5f}")
        return out
