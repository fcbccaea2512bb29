"""Correction variables for the differential corrector.

Torch port of nyx_tpu/md/opti/target_variable.py:15-142 (the reference's
Variable/Vary, md/opti/target_variable.rs:28-208): which state component
or finite-burn parameter to vary, with what finite-difference
perturbation, initial guess and bounds. Host-side only; the defaults and
bounds are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


class Vary:
    """Correction-variable tags (target_variable.rs:28-68)."""

    PositionX = "position_x"
    PositionY = "position_y"
    PositionZ = "position_z"
    VelocityX = "velocity_x"
    VelocityY = "velocity_y"
    VelocityZ = "velocity_z"

    POSITIONS = (PositionX, PositionY, PositionZ)
    VELOCITIES = (VelocityX, VelocityY, VelocityZ)

    # finite-burn maneuver variables (target_variable.rs:28-68); these
    # correct a ParametricManeuver's 12-parameter vector, not the state
    ThrustX = "thrust_x"
    ThrustY = "thrust_y"
    ThrustZ = "thrust_z"
    ThrustLevel = "thrust_level"
    ThrustRateX = "thrust_rate_x"
    ThrustRateY = "thrust_rate_y"
    ThrustRateZ = "thrust_rate_z"
    ThrustAccelX = "thrust_accel_x"
    ThrustAccelY = "thrust_accel_y"
    ThrustAccelZ = "thrust_accel_z"
    StartEpoch = "start_epoch"
    EndEpoch = "end_epoch"
    Duration = "duration"

    MNVR = (
        ThrustX, ThrustY, ThrustZ, ThrustLevel,
        ThrustRateX, ThrustRateY, ThrustRateZ,
        ThrustAccelX, ThrustAccelY, ThrustAccelZ,
        StartEpoch, EndEpoch, Duration,
    )

    #: flat 9-state slot each tag perturbs (in the local frame block)
    SLOT = {
        PositionX: 0, PositionY: 1, PositionZ: 2,
        VelocityX: 3, VelocityY: 4, VelocityZ: 5,
    }

    #: ParametricManeuver parameter-vector slot for the maneuver tags
    PSLOT = {
        StartEpoch: 0, EndEpoch: 1, Duration: 1, ThrustLevel: 2,
        ThrustX: 3, ThrustY: 4, ThrustZ: 5,
        ThrustRateX: 6, ThrustRateY: 7, ThrustRateZ: 8,
        ThrustAccelX: 9, ThrustAccelY: 10, ThrustAccelZ: 11,
    }


@dataclass
class Variable:
    """One correction variable (target_variable.rs:28-120)."""

    component: str  # a Vary tag
    perturbation: float = 1e-4  # finite-difference step (km or km/s)
    init_guess: float = 0.0
    max_step: float = 0.5
    max_value: float = 10.0
    min_value: float = -10.0

    @classmethod
    def from_vary(cls, component: str, perturbation: Optional[float] = None):
        if perturbation is None:
            if component in Vary.POSITIONS:
                perturbation = 1e-4
            elif component in (Vary.StartEpoch, Vary.EndEpoch, Vary.Duration):
                perturbation = 0.5  # seconds
            elif component in Vary.MNVR:
                perturbation = 1e-4  # unit-vector component / level / rate
            else:
                perturbation = 1e-6
        kw = {}
        if component == Vary.ThrustLevel:
            # throttle stays in (0, 1]
            kw = dict(max_value=1.0, min_value=1e-4, max_step=0.2)
        elif component in (Vary.StartEpoch, Vary.EndEpoch, Vary.Duration):
            kw = dict(max_value=600.0, min_value=-600.0, max_step=60.0)
        elif component in (Vary.ThrustRateX, Vary.ThrustRateY,
                           Vary.ThrustRateZ):
            # rate * burn duration must stay O(1) for a unit vector:
            # 1e-3/s over a 10-minute burn rotates the direction by ~0.6
            perturbation = 1e-6
            kw = dict(max_value=1e-2, min_value=-1e-2, max_step=1e-4)
        elif component in (Vary.ThrustAccelX, Vary.ThrustAccelY,
                           Vary.ThrustAccelZ):
            perturbation = 1e-8
            kw = dict(max_value=1e-4, min_value=-1e-4, max_step=1e-6)
        return cls(component, perturbation, **kw)

    @property
    def is_finite_burn(self) -> bool:
        return self.component in Vary.MNVR

    def with_initial_guess(self, guess: float) -> "Variable":
        from dataclasses import replace

        return replace(self, init_guess=guess)

    def with_max_step(self, step: float) -> "Variable":
        from dataclasses import replace

        return replace(self, max_step=step)

    def with_bounds(self, lo: float, hi: float) -> "Variable":
        from dataclasses import replace

        return replace(self, min_value=lo, max_value=hi)

    def apply_bounds(self, value: float) -> float:
        return min(max(value, self.min_value), self.max_value)

    def check_step(self, step: float) -> float:
        """Clamp one Newton step to max_step (target_variable.rs:192-208)."""
        return min(max(step, -self.max_step), self.max_step)

    @property
    def slot(self) -> int:
        return Vary.SLOT[self.component]

    @property
    def pslot(self) -> int:
        """ParametricManeuver parameter index for finite-burn tags."""
        return Vary.PSLOT[self.component]

    def __str__(self):
        return f"Variable({self.component}, pert {self.perturbation})"
