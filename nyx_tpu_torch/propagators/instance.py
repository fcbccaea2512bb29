"""PropInstance: one spacecraft propagated on a device.

Torch port of the core of nyx_tpu/propagators/instance.py: packs a
`Spacecraft` into a [1, 9] float64 state on the device (with guided
dynamics, [1, 10]: the guidance mode last), builds the EOM context, runs
`integrator.propagate` with the EOM of the state's thruster and unpacks the
result, mode included, with `for_duration_with_traj` reading the capture
buffer into a host `Trajectory`. A state-carried STM, an integration frame
other than the state's, events and the context override are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cosmic.spacecraft import Spacecraft
from ..errors import PropagationError, TrajError
from ..md.trajectory import Trajectory
from ..time import Duration
from . import integrator
from .integrator import DONE, FAILED_NAN


def _secs(x) -> float:
    return x.to_seconds() if isinstance(x, Duration) else float(x)


class PropInstance:
    def __init__(self, prop, state: Spacecraft, almanac=None, *, device="cuda"):
        self.prop = prop
        self.state = state
        self.almanac = almanac
        self.device = torch.device(device)

    @property
    def dynamics(self):
        return self.prop.dynamics

    def _pack(self) -> torch.Tensor:
        y = self.state.to_vector()
        if self.dynamics.has_guidance:
            y = np.concatenate([y, [float(self.state.mode)]])
        return torch.as_tensor(y, dtype=torch.float64, device=self.device)[None, :]

    def _unpack(self, epoch, y_row: np.ndarray) -> Spacecraft:
        sc = self.state.set_vector(epoch, y_row[0:9])
        if self.dynamics.has_guidance:
            sc.mode = int(round(float(y_row[-1])))
        return sc

    def _run(self, duration_s: float, n_capture: int = 0):
        dyn = self.dynamics
        sc = self.state
        ctx = dyn.build_context(sc.epoch, duration_s, self.almanac, device=self.device)
        y0 = self._pack()
        sc_params = dict(dry_mass_kg=sc.dry_mass_kg, srp_area_m2=sc.srp_area_m2,
                         drag_area_m2=sc.drag_area_m2)
        res = integrator.propagate(
            dyn.make_eom(thruster=sc.thruster), y0, duration_s, self.prop.opts, self.prop.method,
            finally_fn=dyn.make_finally(), eom_args=(ctx, sc_params), n_capture=n_capture,
        )
        status = int(res.status[0])
        if status == FAILED_NAN:
            raise PropagationError("propagation diverged to NaN; try another method or smaller steps")
        if status != DONE:
            raise PropagationError(
                f"propagation did not finish (status={status}); increase "
                "IntegratorOptions.max_iterations"
            )
        self.state = self._unpack(sc.epoch + duration_s, res.y[0].cpu().numpy())
        return y0[0].cpu().numpy(), res

    def for_duration(self, duration) -> Spacecraft:
        d = _secs(duration)
        if d != 0.0:
            self._run(d)
        return self.state

    def for_duration_with_traj(self, duration, n_capture: int = 8192):
        """(final state, Trajectory of every accepted step and the start)."""
        epoch0, template = self.state.epoch, self.state
        y0, res = self._run(_secs(duration), n_capture=n_capture)
        n = int(res.traj_len[0])
        if n >= n_capture:
            raise TrajError(
                f"trajectory capture buffer saturated ({n_capture} accepted "
                "steps): increase n_capture or the integrator tolerance"
            )
        ts = np.concatenate([[0.0], res.traj_t[0, :n].cpu().numpy()])
        ys = np.concatenate([y0[None, :], res.traj_y[0, :n].cpu().numpy()])
        return self.state, Trajectory.from_capture(epoch0, ts, ys, template)
