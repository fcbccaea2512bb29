"""Integrator options (GMAT defaults), torch port of nyx_tpu/propagators/options.py.

The reference's TPU-only knobs (`stage_mode`, `steps_per_iter`,
`min_lanes`, `loop_mode`, `combo_precision`) have no counterpart here, and
fixed-step integration is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    error_ctrl: Callable = ErrorControl.RSSCartesianStep
    # Cap on attempted steps per propagate call.
    max_iterations: int = 200_000

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
            error_ctrl=error_ctrl,
        )
