"""Exception classes the port raises.

Copied from nyx_tpu/errors.py: one class per layer, each also subclassing
the builtin (`ValueError`) the caller may already catch, under the common
`NyxError`. The reference's other classes are not needed yet.
"""

from __future__ import annotations

__all__ = [
    "NyxError", "StateError", "ConfigError", "GuidanceConfigError", "PropagationError",
    "TrajError",
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


class TrajError(NyxError, ValueError):
    """Trajectory storage/interpolation errors: out-of-bounds epoch,
    empty trajectory, capture overflow (md/trajectory/mod.rs TrajError)."""
