"""Orbital dynamics: two-body + composable acceleration models.

Torch port of nyx_tpu/dynamics/orbital.py: the central two-body term plus a
list of models exposing a batched `accel(ctx, t_tdb_s, r, v) -> [B, 3]`,
among them the third-body point masses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch.linalg import vector_norm

from ..constants import GM_BY_NAIF, SPEED_OF_LIGHT_KM_S
from ..cosmic.frames import Frame, Frames
from ..xmath import norm


@dataclass(frozen=True)
class EomContext:
    """Per-propagation constants handed to every model."""

    epoch0_tdb: float  # TDB s past J2000 of t=0
    table: object  # EphemTable for the Sun / shadow bodies (or None)
    frame: Frame  # integration frame (center + J2000 orientation)
    #: parameters of a parametric guidance law: a float64 tensor [P] shared
    #: by every lane or [B, P] per lane, on the state's device (or None)
    guidance_params: object = None

    def body_index(self, body: int) -> int:
        return self.table.index_of(body)


@dataclass(frozen=True)
class PointMasses:
    """Third-body point-mass gravity (reference: dynamics/orbital.rs:178-197).

    The light-time aberration option evaluates the perturber at t - |r|/c.
    """

    bodies: Tuple[int, ...]
    light_time_correction: bool = False

    def __init__(self, bodies, light_time_correction=False):
        object.__setattr__(self, "bodies", tuple(int(b) for b in bodies))
        object.__setattr__(self, "light_time_correction", light_time_correction)

    def required_bodies(self):
        return self.bodies

    def accel(self, ctx: EomContext, t_tdb, r, v):
        a = torch.zeros_like(r)
        bodies = [b for b in self.bodies if b != ctx.frame.center]
        if not bodies:
            return a
        # every body's position in one Clenshaw pass ([P, B, 3] wrt center, f64)
        positions = ctx.table.position([ctx.body_index(b) for b in bodies], t_tdb)
        for body, rb in zip(bodies, positions):
            mu = GM_BY_NAIF[body]
            idx = ctx.body_index(body)
            if self.light_time_correction:
                dt = vector_norm(rb, dim=-1) / SPEED_OF_LIGHT_KM_S
                rb = ctx.table.position(idx, t_tdb - dt)
            d = rb - r  # spacecraft -> body
            # normalize first, as the reference does: every intermediate
            # stays near 1 instead of |d|^3 (~1e24 km^3 for the Sun). The
            # Sun's term is a difference of accelerations ~2,000 times the
            # result at GEO, so the norms sum as jnp.linalg.norm does
            # (vector_norm), not as xmath.norm.
            dmag = vector_norm(d, dim=-1, keepdim=True)
            dhat = d / dmag
            rbmag = vector_norm(rb, dim=-1, keepdim=True)
            rbhat = rb / rbmag
            a = a + mu * (dhat / (dmag * dmag) - rbhat / (rbmag * rbmag))
        return a


class OrbitalDynamics:
    """Two-body + sum of accel models in a given inertial frame."""

    def __init__(self, models: Sequence = (), frame: Frame = Frames.EME2000):
        self.models = tuple(models)
        self.frame = frame

    @classmethod
    def two_body(cls, frame: Frame = Frames.EME2000) -> "OrbitalDynamics":
        return cls((), frame)

    @classmethod
    def point_masses(cls, bodies, frame: Frame = Frames.EME2000) -> "OrbitalDynamics":
        return cls((PointMasses(bodies),), frame)

    @classmethod
    def from_model(cls, model, frame: Frame = Frames.EME2000) -> "OrbitalDynamics":
        return cls((model,), frame)

    @classmethod
    def from_models(cls, models, frame: Frame = Frames.EME2000) -> "OrbitalDynamics":
        return cls(tuple(models), frame)

    def with_model(self, model) -> "OrbitalDynamics":
        return OrbitalDynamics(self.models + (model,), self.frame)

    def required_bodies(self):
        out = []
        for m in self.models:
            out.extend(m.required_bodies())
        return out

    def two_body_accel(self, ctx: EomContext, r):
        """Central-body term only, in the dtype of `r`."""
        rmag_kd = norm(r, keepdim=True)
        rhat = r / rmag_kd
        return -ctx.frame.mu * rhat / (rmag_kd * rmag_kd)

    def perturbation_accel(self, ctx: EomContext, t_tdb, r, v):
        """Sum of the non-two-body models, in the dtype of `r`."""
        a = torch.zeros_like(r)
        for m in self.models:
            a = a + m.accel(ctx, t_tdb, r, v)
        return a

    def accel(self, ctx: EomContext, t_tdb, r, v):
        """Total acceleration [B,3] including the central two-body term."""
        return self.two_body_accel(ctx, r) + self.perturbation_accel(ctx, t_tdb, r, v)
