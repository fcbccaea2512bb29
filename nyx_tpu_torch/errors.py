"""Exception classes the port raises.

Copied from nyx_tpu/errors.py: one class per layer, each also subclassing
the builtin (`ValueError`) the caller may already catch, under the common
`NyxError`. `PropagationNaNError` is the port's own: the reference raises
the builtin `ArithmeticError` on a NaN lane, so the port's class is both
that and a `PropagationError`.
"""

from __future__ import annotations

__all__ = [
    "NyxError", "StateError", "ConfigError", "InputOutputError", "EphemerisError",
    "DynamicsError", "GuidanceConfigError", "PropagationError", "PropagationNaNError",
    "TrajError", "EventError", "TargetingError", "ODError", "MeasurementSimError",
    "MonteCarloError", "LambertError",
]


class NyxError(Exception):
    """Base class for every framework-originated error (errors.rs:30)."""


class StateError(NyxError, ValueError):
    """Invalid state/parameter access (errors.rs StateError: 'param is
    unavailable in this context', read-only parameters, ...)."""


class ConfigError(NyxError, ValueError):
    """Invalid or inconsistent configuration (io/mod.rs ConfigError)."""


class EphemerisError(NyxError, ValueError):
    """Almanac/SPK/BPC lookup or parsing failures (the reference defers
    these to ANISE's AlmanacError)."""


class DynamicsError(NyxError, ValueError):
    """Force-model composition/evaluation errors (dynamics/mod.rs)."""


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


class ODError(NyxError, RuntimeError):
    """Orbit-determination failures: too few measurements, singular
    gain/information matrix, filter divergence (od/mod.rs:120-182)."""


class MeasurementSimError(ODError):
    """Measurement simulation errors (od/mod.rs MeasurementSimError)."""


class MonteCarloError(NyxError, ValueError):
    """Monte Carlo queries that need data the run did not keep (capture
    buffers, initial states, a located event)."""


class LambertError(NyxError, ValueError):
    """Lambert solver failures: 180-degree geometry, no multi-rev
    solution, iteration limit (errors.rs LambertError)."""


class InputOutputError(NyxError, OSError):
    """File parsing and serialization failures (a TDM's unsupported time
    scale, path or units)."""
