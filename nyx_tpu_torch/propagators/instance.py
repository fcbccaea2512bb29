"""PropInstance: one spacecraft propagated on a device.

Torch port of the core of nyx_tpu/propagators/instance.py: packs a
`Spacecraft` into a [1, 9] float64 state on the device (with guided
dynamics, [1, 10]: the guidance mode last), builds the EOM context, runs
`integrator.propagate` with the EOM of the state's thruster and unpacks the
result, mode included, with `for_duration_with_traj` reading the capture
buffer into a host `Trajectory`; `until_epoch` and the event stops
(`until_event`, `until_nth_event`: propagate with capture, then root-find
on the trajectory) build on it. A lane that turns to NaN raises
`PropagationNaNError`, an `ArithmeticError` as the reference's. With
`IntegratorOptions.integration_frame` set, the state moves into that
frame once, up front (relabelled where the centres match, else
translated through the almanac), and results stay in it.

A spacecraft built `with_stm()` propagates its 9x9 STM beside the state,
packed in the reference's order (instance.py:78-93): the 9 state slots,
the 81 of Phi row-major, then the mode column when guided, so a guided
STM state is [1, 91]. The EOM is made once per (with_stm, thruster) and
kept, as the reference keeps it (:70-76). `ctx_override`, when set,
replaces the EOM context built from the almanac (ephemeris sensitivity
studies).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..cosmic.spacecraft import Spacecraft
from ..errors import EventError, PropagationError, PropagationNaNError, TrajError
from ..md.trajectory import Trajectory
from ..time import Duration, Epoch
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
        iframe = prop.opts.integration_frame
        if iframe is not None and iframe != state.frame:
            if iframe.center == state.frame.center:
                orbit = replace(state.orbit, frame=iframe)
            elif almanac is None:
                raise PropagationError("integration_frame with a different center needs an almanac")
            else:
                orbit = almanac.translate_to(state.orbit, iframe)
            self.state = replace(state, orbit=orbit)
        #: the integrator's PropResult of the latest propagation (steps,
        #: iterations), or None before the first
        self.last_result = None
        #: an EomContext used instead of the one built from the almanac
        self.ctx_override = None
        self._eom_cache = {}

    @property
    def dynamics(self):
        return self.prop.dynamics

    def _eom(self, with_stm: bool):
        key = (with_stm, self.state.thruster)
        if key not in self._eom_cache:
            self._eom_cache[key] = self.dynamics.make_eom(with_stm, thruster=self.state.thruster)
        return self._eom_cache[key]

    def _pack(self) -> torch.Tensor:
        sc = self.state
        y = sc.to_vector()
        if sc.stm is not None:
            y = np.concatenate([y, np.asarray(sc.stm, dtype=np.float64).ravel()])
        if self.dynamics.has_guidance:
            y = np.concatenate([y, [float(sc.mode)]])
        return torch.as_tensor(y, dtype=torch.float64, device=self.device)[None, :]

    def _unpack(self, epoch, y_row: np.ndarray) -> Spacecraft:
        sc = self.state.set_vector(epoch, y_row[0:9])
        if self.state.stm is not None:
            sc.stm = y_row[9:90].reshape(9, 9).copy()
        if self.dynamics.has_guidance:
            sc.mode = int(round(float(y_row[-1])))
        return sc

    def _run(self, duration_s: float, n_capture: int = 0):
        dyn = self.dynamics
        sc = self.state
        ctx = self.ctx_override or dyn.build_context(sc.epoch, duration_s, self.almanac,
                                                     device=self.device)
        y0 = self._pack()
        sc_params = dict(dry_mass_kg=sc.dry_mass_kg, srp_area_m2=sc.srp_area_m2,
                         drag_area_m2=sc.drag_area_m2)
        res = integrator.propagate(
            self._eom(sc.stm is not None), y0, duration_s, self.prop.opts, self.prop.method,
            finally_fn=dyn.make_finally(), eom_args=(ctx, sc_params), n_capture=n_capture,
        )
        self.last_result = res
        status = int(res.status[0])
        if status == FAILED_NAN:
            raise PropagationNaNError("propagation diverged to NaN; try another method or smaller steps")
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

    def until_epoch(self, epoch: Epoch) -> Spacecraft:
        return self.for_duration(epoch - self.state.epoch)

    def until_epoch_with_traj(self, epoch: Epoch, n_capture: int = 8192):
        return self.for_duration_with_traj(epoch - self.state.epoch, n_capture)

    def until_event(self, max_duration, event, n_capture: int = 8192):
        """Propagate until the first occurrence of `event` within
        `max_duration`: (state at the event, trajectory of the whole arc)."""
        return self.until_nth_event(max_duration, event, 0, n_capture)

    def until_nth_event(self, max_duration, event, trigger: int, n_capture: int = 8192):
        """Propagate until the (trigger+1)-th crossing of `event`, found on
        the captured trajectory of `max_duration`. Raises EventError if the
        arc holds fewer."""
        from ..md.events import find_events

        _, traj = self.for_duration_with_traj(max_duration, n_capture)
        details = find_events(traj, event, max_events=trigger + 1)
        if len(details) <= trigger:
            raise EventError(
                f"event {event} not found {trigger + 1} time(s) within "
                f"{_secs(max_duration)} s (found {len(details)})"
            )
        self.state = traj.at(details[trigger].epoch)
        return self.state, traj

    def latest_details(self) -> dict:
        return dict(step=None, error=None, attempts=None)
