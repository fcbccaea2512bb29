"""Objective: a desired value of a StateParameter with a tolerance.

Torch port of nyx_tpu/md/objective.py (the reference's md/objective.rs:
27-75), as the Ruggiero guidance law uses it. Host-side only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import param as param_mod
from .param import StateParameter


@dataclass(frozen=True)
class Objective:
    parameter: str
    desired_value: float
    tolerance: float = 0.1
    # multiplicative/additive factors as the reference (objective.rs:40-46)
    multiplicative_factor: float = 1.0
    additive_factor: float = 0.0

    @classmethod
    def within_tolerance(cls, parameter, desired, tolerance) -> "Objective":
        return cls(parameter, desired, tolerance)

    def assess_raw(self, achieved: float):
        """(ok, error) with the reference's factor convention; angle errors
        wrap into [-180, 180) degrees."""
        err = self.desired_value - (self.multiplicative_factor * achieved + self.additive_factor)
        if self.parameter in StateParameter.ANGLES_DEG:
            err = (err + 180.0) % 360.0 - 180.0
        return abs(err) <= self.tolerance, err

    def assess(self, y, mu, radius_km=0.0):
        """`assess_raw` of the parameter's value on the state `y` (a [>= 6]
        tensor or array)."""
        achieved = float(param_mod.value(self.parameter, torch.as_tensor(y), mu, radius_km))
        return self.assess_raw(achieved)
