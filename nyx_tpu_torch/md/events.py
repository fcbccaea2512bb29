"""Event finding on trajectories (torch port of nyx_tpu/md/events.py).

An event is a zero crossing of `value(parameter) - desired` (wrapped into
[-180, 180) for angles). The design is the reference's: the event
function over the trajectory's nodes, a sign change between two nodes
(skipping the jumps of an angle's wrap), then scipy's `brentq` on the
Hermite-interpolated trajectory to `epoch_precision_s`. The event function
runs the port's `param.value` on CPU float64 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from scipy.optimize import brentq

from ..cosmic.spacecraft import Spacecraft
from ..time import Epoch
from . import param as param_mod
from .trajectory import Trajectory


@dataclass(frozen=True)
class Event:
    parameter: str
    desired_value: float = 0.0
    epoch_precision_s: float = 0.1
    value_precision: Optional[float] = None

    @classmethod
    def apoapsis(cls) -> "Event":
        return cls("ta", 180.0)

    @classmethod
    def periapsis(cls) -> "Event":
        return cls("ta", 0.0)

    @property
    def is_angle(self) -> bool:
        return self.parameter.lower() in param_mod.StateParameter.ANGLES_DEG

    def g(self, y, mu, radius_km=0.0):
        """Signed event function of states `y` [..., N] (tensors)."""
        err = param_mod.value(self.parameter, y, mu, radius_km) - self.desired_value
        if self.is_angle:
            err = torch.remainder(err + 180.0, 360.0) - 180.0
        return err

    def __str__(self):
        return f"{self.parameter} = {self.desired_value}"


@dataclass
class EventDetails:
    event: Event
    epoch: Epoch
    state: Spacecraft
    value: float


def find_events(traj: Trajectory, event: Event, max_events: int = 100) -> List[EventDetails]:
    """All sign-change crossings of the event on a trajectory, Brent-refined."""
    frame = traj.template.frame
    mu, radius = frame.mu, frame.radius_km or 0.0
    g_samples = event.g(torch.as_tensor(traj.ys), mu, radius).numpy()

    def g_of_t(t_rel: float) -> float:
        y = torch.as_tensor(traj.interpolate(t_rel)[None, :])
        return float(event.g(y, mu, radius)[0])

    out: List[EventDetails] = []
    for i in range(len(traj.ts) - 1):
        a, b = g_samples[i], g_samples[i + 1]
        if np.isnan(a) or np.isnan(b):
            continue
        if a == 0.0:
            t_root = float(traj.ts[i])
        elif a * b < 0.0:
            # a jump of more than 180 is an angle's wrap, not a crossing
            if event.is_angle and abs(b - a) > 180.0:
                continue
            t_root = brentq(g_of_t, float(traj.ts[i]), float(traj.ts[i + 1]),
                            xtol=event.epoch_precision_s)
        else:
            continue
        epoch = traj.epoch0 + t_root
        state = traj.template.set_vector(epoch, traj.interpolate(t_root)[:9])
        out.append(EventDetails(event, epoch, state, g_of_t(t_root)))
        if len(out) >= max_events:
            break
    return out


def find_nth_event(traj: Trajectory, event: Event, n: int) -> Optional[EventDetails]:
    """The 0-indexed n-th event, as the reference's until_nth_event."""
    events = find_events(traj, event, max_events=n + 1)
    return events[n] if len(events) > n else None


def find_minmax(traj: Trajectory, parameter: str, kind: str = "min"):
    """(state, value, epoch) of a parameter's extremum over the nodes."""
    vals = traj.values_of(parameter, traj.ys)
    idx = int(np.argmin(vals) if kind == "min" else np.argmax(vals))
    return traj._state_at_index(idx), float(vals[idx]), traj.epoch0 + float(traj.ts[idx])
