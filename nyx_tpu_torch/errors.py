"""Exception classes the port raises.

Copied from nyx_tpu/errors.py: one class per layer, each also subclassing
the builtin (`ValueError`) the caller may already catch, under the common
`NyxError`. `PropagationNaNError` is the port's own: the reference raises
the builtin `ArithmeticError` on a NaN lane, so the port's class is both
that and a `PropagationError`. The reference's OD classes are not needed
yet.
"""

from __future__ import annotations

__all__ = [
    "NyxError", "StateError", "ConfigError", "GuidanceConfigError", "PropagationError",
    "PropagationNaNError", "TrajError", "EventError", "TargetingError", "MonteCarloError",
    "LambertError",
]


class NyxError(Exception):
    """Base class for every framework-originated error (errors.rs:30)."""


class StateError(NyxError, ValueError):
    """Invalid state/parameter access (errors.rs StateError: 'param is
    unavailable in this context', read-only parameters, ...)."""


class ConfigError(NyxError, ValueError):
    """Invalid or inconsistent configuration (io/mod.rs ConfigError)."""


class GuidanceConfigError(ConfigError):
    """Guidance law configuration errors (errors.rs GuidanceConfigError)."""


class PropagationError(NyxError, RuntimeError):
    """Integrator failures: NaN states, min-step underflow, unreached
    stop conditions (propagators/mod.rs PropagationError)."""


class PropagationNaNError(PropagationError, ArithmeticError):
    """A lane's state turned to NaN: caught by `except ArithmeticError`,
    as the reference's, and by `except PropagationError`."""


class TrajError(NyxError, ValueError):
    """Trajectory storage/interpolation errors: out-of-bounds epoch,
    empty trajectory, capture overflow (md/trajectory/mod.rs TrajError)."""


class EventError(TrajError):
    """Event search failures: event never found in the arc (md/events)."""


class TargetingError(NyxError, RuntimeError):
    """Differential-correction failures: singular Jacobian, max
    iterations (md/opti TargetingError)."""


class MonteCarloError(NyxError, ValueError):
    """Monte Carlo queries that need data the run did not keep (capture
    buffers, initial states, a located event)."""


class LambertError(NyxError, ValueError):
    """Lambert solver failures: 180-degree geometry, no multi-rev
    solution, iteration limit (errors.rs LambertError)."""


class InputOutputError(NyxError, OSError):
    """File parsing and serialization failures (a TDM's unsupported time
    scale, path or units)."""
