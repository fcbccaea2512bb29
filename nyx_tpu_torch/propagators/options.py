"""Integrator options (GMAT defaults), torch port of nyx_tpu/propagators/options.py.

The reference's TPU-only knobs (`stage_mode`, `steps_per_iter`,
`min_lanes`, `loop_mode`, `combo_precision`) have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

from ..time import Duration
from .error_ctrl import ErrorControl


def _secs(x) -> float:
    return x.to_seconds() if isinstance(x, Duration) else float(x)


@dataclass(frozen=True)
class IntegratorOptions:
    init_step_s: float = 60.0
    min_step_s: float = 1e-3
    max_step_s: float = 2700.0
    tolerance: float = 1e-12
    attempts: int = 50
    fixed_step: bool = False
    error_ctrl: Callable = ErrorControl.RSSCartesianStep
    # Cap on attempted steps per propagate call.
    max_iterations: int = 200_000
    # Frame to move the state into before propagating (the reference's
    # options.rs:42-61); None propagates in the state's own frame.
    integration_frame: object = None

    @classmethod
    def with_adaptive_step(
        cls, min_step, max_step, tolerance=1e-12, error_ctrl=ErrorControl.RSSCartesianStep
    ) -> "IntegratorOptions":
        return cls(
            init_step_s=_secs(max_step),
            min_step_s=_secs(min_step),
            max_step_s=_secs(max_step),
            tolerance=tolerance,
            attempts=50,
            fixed_step=False,
            error_ctrl=error_ctrl,
        )

    # alias matching the reference's seconds-based constructor
    with_adaptive_step_s = with_adaptive_step

    @classmethod
    def with_fixed_step(cls, step) -> "IntegratorOptions":
        s = _secs(step)
        return cls(init_step_s=s, min_step_s=s, max_step_s=s, tolerance=0.0, attempts=0,
                   fixed_step=True)

    with_fixed_step_s = with_fixed_step

    @classmethod
    def with_max_step(cls, max_step) -> "IntegratorOptions":
        s = _secs(max_step)
        return cls(init_step_s=s, max_step_s=s)

    @classmethod
    def with_tolerance(cls, tolerance: float) -> "IntegratorOptions":
        return cls(tolerance=tolerance)

    def set_max_step(self, max_step) -> "IntegratorOptions":
        s = _secs(max_step)
        return replace(self, max_step_s=s, init_step_s=min(self.init_step_s, s))
