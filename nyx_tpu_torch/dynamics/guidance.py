"""Guidance laws: Ruggiero and Kluever low thrust, finite-burn maneuvers.

Torch port of nyx_tpu/dynamics/guidance.py (the reference's GuidanceLaw
trait, guidance/mod.rs:111-149, Ruggiero, ruggiero.rs:40-510, Maneuver
and ImpulsiveManeuver, mnvr.rs:39-418, Kluever, kluever.rs:39-310, and
the replay, replay.rs:32-128). A law
gives two batched functions that the integrator's EOM and its post-step
hook call on float64 tensors, with no host synchronization:

  direction_and_throttle(ctx, t_tdb, y9, mode) -> (u_inertial [B, 3], throttle [B])
  next_mode(ctx, t_tdb, y9, mode) -> mode' [B]

Mode transitions are masks over the lane axis, applied after every
accepted step as the reference's Dynamics::finally does. The burn gates
are the reference's, edge for edge: `Maneuver` thrusts inside [start, end)
OR while the mode is latched Thrust; `ParametricManeuver` gates by time
alone; both `next_mode`s use the half-open window, and
`ManeuverSequence.direction_and_throttle` takes t <= end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.linalg import vector_norm

from ..constants import NAIF, RADIUS_BY_NAIF
from ..cosmic.eclipse import occultation_percentage
from ..cosmic.orbit import keplerian_from_cartesian, rcn_dcm, ric_dcm, vnc_dcm
from ..cosmic.spacecraft import GuidanceMode
from ..errors import GuidanceConfigError
from ..md.objective import Objective
from ..md.param import StateParameter
from ..time import Epoch

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


def _burn_mode(in_burn, mode):
    """Thrust where `in_burn`, Coast elsewhere; Inhibit lanes keep it."""
    want = torch.where(torch.broadcast_to(in_burn, mode.shape), torch.full_like(mode, GuidanceMode.Thrust),
                       torch.full_like(mode, GuidanceMode.Coast))
    return torch.where(mode == GuidanceMode.Inhibit, mode, want)


def _on(law, name: str, like):
    """The law's host array `name` as a float64 tensor on the device of
    `like`, copied there once and kept (a copy a call would stall the host
    on the card)."""
    cache = law.__dict__.setdefault("_on_device", {})
    key = (name, like.device)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(getattr(law, name), np.float64), dtype=torch.float64,
                                     device=like.device)
    return cache[key]


def _polyval(coeffs, t):
    """numpy polyval order (most significant first), by Horner."""
    out = torch.zeros_like(t)
    for c in np.asarray(coeffs, np.float64):
        out = out * t + float(c)
    return out


# ---------------------------------------------------------------------------
# Finite-burn maneuvers (mnvr.rs:39-418)
# ---------------------------------------------------------------------------
@dataclass
class ImpulsiveManeuver:
    """Instantaneous delta-v in a local frame (mnvr.rs:39-52)."""

    dv_km_s: np.ndarray
    local_frame: str = LocalFrame.VNC

    def apply(self, sc):
        """The spacecraft after the instantaneous delta-v (host, float64)."""
        r = torch.from_numpy(np.asarray(sc.orbit.r_km, np.float64))
        v = torch.from_numpy(np.asarray(sc.orbit.v_km_s, np.float64))
        dcm = LocalFrame.dcm_to_inertial(self.local_frame, r, v)
        return sc.with_dv((dcm @ torch.as_tensor(np.asarray(self.dv_km_s, np.float64))).numpy())


@dataclass
class Maneuver(GuidanceLaw):
    """A single finite burn between two epochs (mnvr.rs:67-92). Its direction
    is a fixed vector in `frame` (with an optional rate and acceleration:
    u(t) = normalize(vector + vector_rate tau + vector_accel tau^2), tau the
    time since the burn's start) or azimuth/elevation polynomials of tau
    (MnvrRepr, mnvr.rs:131-140), most significant coefficient first."""

    start: Epoch
    end: Epoch
    thrust_prct: float = 1.0
    vector: Optional[np.ndarray] = None  # direction at burn start in `frame`
    azimuth_poly: Optional[np.ndarray] = None  # alpha(tau) rad
    elevation_poly: Optional[np.ndarray] = None
    frame: str = LocalFrame.VNC
    vector_rate: Optional[np.ndarray] = None
    vector_accel: Optional[np.ndarray] = None

    def __post_init__(self):
        self._start_tdb = self.start.to_tdb_seconds()
        self._end_tdb = self.end.to_tdb_seconds()
        if self.vector is None and self.azimuth_poly is None:
            raise GuidanceConfigError("Maneuver needs a vector or angle polynomials")

    @classmethod
    def from_impulsive(cls, dt: Epoch, vector, frame=LocalFrame.VNC) -> "Maneuver":
        """An (almost) impulsive maneuver: 1 ms at full throttle
        (mnvr.rs:183-186)."""
        return cls.from_time_invariant(dt, dt + 1e-3, 1.0, vector, frame)

    @classmethod
    def from_time_invariant(cls, start, end, thrust_lvl, vector, frame) -> "Maneuver":
        return cls(start, end, thrust_lvl, vector=np.asarray(vector, dtype=np.float64), frame=frame)

    @classmethod
    def constant_direction(cls, start, end, thrust_lvl, alpha_rad, delta_rad,
                           frame=LocalFrame.VNC) -> "Maneuver":
        return cls(start, end, thrust_lvl, azimuth_poly=np.array([alpha_rad]),
                   elevation_poly=np.array([delta_rad]), frame=frame)

    @property
    def duration_s(self) -> float:
        return self._end_tdb - self._start_tdb

    def vector_at(self, t_tdb):
        """Direction in `frame` at TDB times t_tdb [...] (mnvr.rs:205-216):
        [..., 3]."""
        tau = t_tdb - self._start_tdb
        if self.vector is not None:
            vec = _on(self, "vector", t_tdb).expand(tau.shape + (3,))
            if self.vector_rate is not None:
                vec = vec + _on(self, "vector_rate", t_tdb) * tau[..., None]
            if self.vector_accel is not None:
                vec = vec + _on(self, "vector_accel", t_tdb) * tau[..., None] ** 2
            return vec / vector_norm(vec, dim=-1, keepdim=True)
        return unit_vector_from_ra_dec(_polyval(self.azimuth_poly, tau), _polyval(self.elevation_poly, tau))

    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        r = y9[..., 0:3]
        v = y9[..., 3:6]
        dcm = LocalFrame.dcm_to_inertial(self.frame, r, v)
        u = torch.einsum("...ij,...j->...i", dcm, torch.broadcast_to(self.vector_at(t_tdb), r.shape))
        # thrust while the stage time is in the window OR the mode is latched
        # Thrust: the time term catches a burn inside one long coast step,
        # the latch keeps stages that probe past the step's end thrusting
        in_burn = (t_tdb >= self._start_tdb) & (t_tdb < self._end_tdb)
        thrusting = (torch.broadcast_to(in_burn, mode.shape) | (mode == GuidanceMode.Thrust)) & (
            mode != GuidanceMode.Inhibit)
        throttle = thrusting.to(y9.dtype) * self.thrust_prct
        return torch.where(thrusting[..., None], u, 0.0), throttle

    def next_mode(self, ctx, t_tdb, y9, mode):
        """Thrust inside [start, end), coast outside (mnvr.rs:392-399; the
        half-open window keeps a propagation resumed exactly at the burn's
        end from thrusting one more step)."""
        return _burn_mode((t_tdb >= self._start_tdb) & (t_tdb < self._end_tdb), mode)

    def __str__(self):
        return (f"Finite burn @ {100.0 * self.thrust_prct:.2f}% from {self.start} "
                f"for {self.duration_s:.3f} s in {self.frame}")


@dataclass
class ManeuverSequence(GuidanceLaw):
    """Several non-overlapping finite burns as one guidance law."""

    maneuvers: Tuple[Maneuver, ...]

    def __post_init__(self):
        self.maneuvers = tuple(sorted(self.maneuvers, key=lambda m: m._start_tdb))
        if len({m.frame for m in self.maneuvers}) != 1:
            raise GuidanceConfigError("all maneuvers in a sequence must share a frame")

    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        u = torch.zeros_like(y9[..., 0:3])
        throttle = torch.zeros_like(y9[..., 0])
        for m in self.maneuvers:
            in_burn = (t_tdb >= m._start_tdb) & (t_tdb <= m._end_tdb)
            um, tm = m.direction_and_throttle(ctx, t_tdb, y9, mode)
            u = torch.where(in_burn[..., None], um, u)
            throttle = torch.where(in_burn, tm, throttle)
        return u, throttle

    def next_mode(self, ctx, t_tdb, y9, mode):
        in_any = torch.zeros_like(mode, dtype=torch.bool)
        for m in self.maneuvers:
            in_any = in_any | ((t_tdb >= m._start_tdb) & (t_tdb < m._end_tdb))
        return _burn_mode(in_any, mode)


# ---------------------------------------------------------------------------
# Kluever blended control law (kluever.rs:39-310)
# ---------------------------------------------------------------------------
@dataclass
class Kluever(GuidanceLaw):
    """Weighted-objective blended low-thrust law (kluever.rs:39-48): the
    steering angles alpha/beta are blended over the weighted objectives
    (sma, ecc, inc, raan) in the RCN frame."""

    objectives: Tuple[Objective, ...]
    weights: Tuple[float, ...]
    max_eclipse_prct: Optional[float] = None
    shadow_bodies: Tuple[int, ...] = (NAIF.EARTH,)

    @classmethod
    def new(cls, objectives, weights) -> "Kluever":
        return cls(tuple(objectives), tuple(weights))

    @classmethod
    def from_max_eclipse(cls, objectives, weights, max_eclipse) -> "Kluever":
        return cls(tuple(objectives), tuple(weights), max_eclipse)

    def required_bodies(self):
        if self.max_eclipse_prct is None:
            return ()
        return (NAIF.SUN,) + tuple(self.shadow_bodies)

    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        r = y9[..., 0:3]
        v = y9[..., 3:6]
        kep = keplerian_from_cartesian(r, v, ctx.frame.mu)
        e = kep["ecc"]
        ta = kep["ta"]
        u_rad = ta + kep["aop"]
        num_a = torch.zeros_like(e)
        den_a = torch.zeros_like(e)
        num_b = torch.zeros_like(e)
        for obj, w0 in zip(self.objectives, self.weights):
            if w0 == 0.0:
                continue
            error = obj.desired_value - Ruggiero._osc_value(obj.parameter, kep)
            w = torch.where(torch.abs(error) >= obj.tolerance, w0 * torch.sign(error), 0.0)
            p = obj.parameter
            if p == StateParameter.SMA:
                num_a = num_a + w * (e * torch.sin(ta))
                den_a = den_a + w * (1.0 + e * torch.cos(ta))
            elif p == StateParameter.ECC:
                num_a = num_a + w * torch.sin(ta)
                den_a = den_a + w * (torch.cos(ta) + (e + torch.cos(ta)) / (1.0 + e * torch.cos(ta)))
            elif p == StateParameter.INC:
                num_b = num_b + w * torch.sign(torch.cos(u_rad))
            elif p == StateParameter.RAAN:
                num_b = num_b + w * torch.sign(torch.sin(u_rad))
            else:
                raise GuidanceConfigError(f"Kluever does not support objective {p}")
        alpha = torch.atan2(num_a, den_a)
        beta = torch.atan2(num_b, torch.sqrt(num_a**2 + den_a**2))
        steer_rcn = unit_vector_from_plane_angles(alpha, beta)
        dcm = LocalFrame.dcm_to_inertial(LocalFrame.RCN, r, v)
        u = torch.einsum("...ij,...j->...i", dcm, steer_rcn)
        thrusting = mode == GuidanceMode.Thrust
        return torch.where(thrusting[..., None], u, 0.0), thrusting.to(y9.dtype)

    def next_mode(self, ctx, t_tdb, y9, mode):
        """Ruggiero's transitions (kluever.rs:300-330)."""
        helper = Ruggiero(self.objectives, tuple(0.0 for _ in self.objectives),
                          max_eclipse_prct=self.max_eclipse_prct, shadow_bodies=self.shadow_bodies)
        return helper.next_mode(ctx, t_tdb, y9, mode)

    def achieved(self, sc) -> bool:
        return all(obj.assess_raw(float(sc.orbit.value(obj.parameter)))[0] for obj in self.objectives)


@dataclass
class ThrustDirectionReplay(GuidanceLaw):
    """Replays recorded thrust directions (guidance/replay.rs:32-128): logged
    (epoch, inertial unit vector, throttle) samples, interpolated on the
    device (zero-order hold on the throttle, renormalized linear
    interpolation of the direction)."""

    ts_tdb: np.ndarray  # [K] sample epochs, TDB s past J2000, sorted
    directions: np.ndarray  # [K, 3] inertial unit vectors
    throttles: np.ndarray  # [K]

    @classmethod
    def from_samples(cls, epochs, directions, throttles) -> "ThrustDirectionReplay":
        ts = np.array([e.to_tdb_seconds() for e in epochs])
        order = np.argsort(ts)
        return cls(ts[order], np.asarray(directions, dtype=np.float64)[order],
                   np.asarray(throttles, dtype=np.float64)[order])

    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        ts, dirs, thr = (_on(self, a, y9) for a in ("ts_tdb", "directions", "throttles"))
        i = torch.clamp(torch.searchsorted(ts, t_tdb.contiguous()) - 1, 0, ts.shape[0] - 2)
        f = torch.clamp((t_tdb - ts[i]) / torch.clamp(ts[i + 1] - ts[i], min=1e-9), 0.0, 1.0)
        u = dirs[i] * (1.0 - f[..., None]) + dirs[i + 1] * f[..., None]
        nrm = vector_norm(u, dim=-1, keepdim=True)
        u = u / torch.where(nrm > 0, nrm, 1.0)
        in_window = (t_tdb >= float(self.ts_tdb[0])) & (t_tdb <= float(self.ts_tdb[-1]))
        thrusting = (mode == GuidanceMode.Thrust) & in_window
        return torch.where(thrusting[..., None], u, 0.0), torch.where(thrusting, thr[i], 0.0)

    def next_mode(self, ctx, t_tdb, y9, mode):
        return _burn_mode((t_tdb >= float(self.ts_tdb[0])) & (t_tdb <= float(self.ts_tdb[-1])), mode)


@dataclass
class ParametricManeuver(GuidanceLaw):
    """A finite burn whose 12 parameters come from `ctx.guidance_params`, so
    one EOM serves every corrected or perturbed maneuver of a targeting
    loop, lane by lane (the counterpart of the reference's parallel-FD
    thrust targeters, targeter.rs thrust_dir/_rate/_profile).

    Parameters ([12], or [B, 12] per lane):

      0 start_tdb   1 end_tdb   2 thrust_level
      3:6  direction vector at burn start (local frame)
      6:9  direction rate  [1/s]
      9:12 direction accel [1/s^2]

    u_local(tau) = normalize(c + r tau + a tau^2), tau = t - start.
    """

    frame: str = LocalFrame.RCN

    @staticmethod
    def params_from_maneuver(mnvr: Maneuver) -> np.ndarray:
        """The 12 parameters of a constant-vector Maneuver."""
        if mnvr.vector is None:
            raise GuidanceConfigError(
                "ParametricManeuver needs a vector-representation Maneuver as the initial guess")
        v = np.asarray(mnvr.vector, dtype=np.float64)
        v = v / np.linalg.norm(v)
        return np.concatenate([[mnvr._start_tdb, mnvr._end_tdb, mnvr.thrust_prct], v, np.zeros(6)])

    @staticmethod
    def _direction_local(p, tau):
        u = p[..., 3:6] + p[..., 6:9] * tau[..., None] + p[..., 9:12] * tau[..., None] ** 2
        return u / vector_norm(u, dim=-1, keepdim=True)

    def direction_and_throttle(self, ctx, t_tdb, y9, mode):
        p = ctx.guidance_params
        if p is None:
            raise GuidanceConfigError("ParametricManeuver requires ctx.guidance_params")
        tau = torch.broadcast_to(t_tdb - p[..., 0], y9.shape[:-1])
        r = y9[..., 0:3]
        v = y9[..., 3:6]
        dcm = LocalFrame.dcm_to_inertial(self.frame, r, v)
        u = torch.einsum("...ij,...j->...i", dcm, torch.broadcast_to(self._direction_local(p, tau), r.shape))
        # a pure time gate at the stage's time, no latch: the FD Jacobian
        # with respect to StartEpoch/Duration needs the burn's edges to move
        # the result, and the adaptive controller finds each edge by
        # rejecting steps
        t = torch.broadcast_to(t_tdb, mode.shape)
        thrusting = (t >= p[..., 0]) & (t < p[..., 1]) & (mode != GuidanceMode.Inhibit)
        return torch.where(thrusting[..., None], u, 0.0), torch.where(thrusting, p[..., 2], 0.0)

    def next_mode(self, ctx, t_tdb, y9, mode):
        p = ctx.guidance_params
        return _burn_mode((t_tdb >= p[..., 0]) & (t_tdb < p[..., 1]), mode)
