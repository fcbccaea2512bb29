"""Orbital dynamics: two-body + composable acceleration models.

Torch port of nyx_tpu/dynamics/orbital.py: the central two-body term plus a
list of models exposing a batched `accel(ctx, t_tdb_s, r, v) -> [B, 3]`.
Third-body point masses are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..cosmic.frames import Frame, Frames
from ..xmath import norm


@dataclass(frozen=True)
class EomContext:
    """Per-propagation constants handed to every model."""

    epoch0_tdb: float  # TDB s past J2000 of t=0
    table: object  # EphemTable for the Sun / shadow bodies (or None)
    frame: Frame  # integration frame (center + J2000 orientation)

    def body_index(self, body: int) -> int:
        return self.table.index_of(body)


class OrbitalDynamics:
    """Two-body + sum of accel models in a given inertial frame."""

    def __init__(self, models: Sequence = (), frame: Frame = Frames.EME2000):
        self.models = tuple(models)
        self.frame = frame

    @classmethod
    def from_model(cls, model, frame: Frame = Frames.EME2000) -> "OrbitalDynamics":
        return cls((model,), frame)

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
