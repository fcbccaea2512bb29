"""Host-facing Propagator setup (torch port of nyx_tpu/propagators/propagator.py)."""

from __future__ import annotations

from .options import IntegratorOptions
from .tableaus import IntegratorMethod

_METHODS = {
    "rk89": IntegratorMethod.RK89,
    "dp78": IntegratorMethod.DormandPrince78,
    "dormandprince78": IntegratorMethod.DormandPrince78,
    "dp45": IntegratorMethod.DormandPrince45,
    "dormandprince45": IntegratorMethod.DormandPrince45,
    "ck45": IntegratorMethod.CashKarp45,
    "cashkarp45": IntegratorMethod.CashKarp45,
    "rk4": IntegratorMethod.RK4Fixed,
    "verner56": IntegratorMethod.Verner56,
}


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

    @classmethod
    def dp78(cls, dynamics, opts=None) -> "Propagator":
        return cls(dynamics, IntegratorMethod.DormandPrince78, opts)

    @classmethod
    def default(cls, dynamics) -> "Propagator":
        return cls(dynamics)

    @classmethod
    def from_method(cls, dynamics, method: str, opts=None) -> "Propagator":
        """Method by name ('rk89', 'dp78', 'dp45', 'ck45', 'rk4', 'verner56')."""
        return cls(dynamics, _METHODS[method.lower()], opts)

    def with_guidance(self, law) -> "Propagator":
        """A copy whose dynamics run the guidance law `law`."""
        return Propagator(self.dynamics.with_guidance_law(law), self.method, self.opts)

    def with_state(self, state, almanac=None, *, device="cuda"):
        """A PropInstance propagating `state` on `device` (the card unless
        the caller asks for another)."""
        from .instance import PropInstance

        return PropInstance(self, state, almanac, device=device)

    # The reference calls this `with`; that's reserved in Python.
    def with_(self, state, almanac=None, *, device="cuda"):
        return self.with_state(state, almanac, device=device)
