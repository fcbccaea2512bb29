"""Host-facing Propagator setup (torch port of nyx_tpu/propagators/propagator.py)."""

from __future__ import annotations

from .options import IntegratorOptions
from .tableaus import IntegratorMethod


class Propagator:
    """Immutable propagator setup: dynamics + method + options."""

    def __init__(self, dynamics, method: IntegratorMethod = IntegratorMethod.RK89,
                 opts: IntegratorOptions = None):
        self.dynamics = dynamics
        self.method = method
        self.opts = opts or IntegratorOptions()

    @classmethod
    def rk89(cls, dynamics, opts=None) -> "Propagator":
        return cls(dynamics, IntegratorMethod.RK89, opts)

    def with_state(self, state, almanac=None, *, device="cuda"):
        """A PropInstance propagating `state` on `device` (the card unless
        the caller asks for another)."""
        from .instance import PropInstance

        return PropInstance(self, state, almanac, device=device)
