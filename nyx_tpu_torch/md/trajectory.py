"""Trajectory storage and Hermite interpolation.

Host-side numpy copy of nyx_tpu/md/trajectory.py:1-234: `hermite_eval`,
and a `Trajectory` built from a propagation's captured nodes with the
13-sample sliding-window Hermite interpolation of position and velocity
(linear in the other columns), including the window's thinning of
near-coincident nodes; its queries (first/last, every, every_between,
sample_values, resample, rebuild, filter_by_*) and its parquet and OEM
export (io/export.py). Frame transforms, ground tracks, RIC differences,
`from_bsp`, `to_ephemeris` and `from_parquet` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..cosmic.spacecraft import Spacecraft
from ..errors import TrajError
from ..time import Duration, Epoch
from . import param as param_mod

INTERPOLATION_SAMPLES = 13


def hermite_eval(ts, ys, yds, t):
    """Hermite interpolation with derivatives at `t`.

    ts [n], ys [n, k] values, yds [n, k] derivatives. Returns (y [k], yd [k]).
    Newton divided-difference formulation on 2n doubled nodes.
    """
    n, k = ys.shape
    m = 2 * n
    z = np.repeat(ts, 2)
    q = np.zeros((m, m, k))
    q[0::2, 0] = ys
    q[1::2, 0] = ys
    # first divided differences: odd rows use the derivative
    for i in range(m - 1):
        if i % 2 == 0:
            q[i, 1] = yds[i // 2]
        else:
            q[i, 1] = (q[i + 1, 0] - q[i, 0]) / (z[i + 1] - z[i])
    for j in range(2, m):
        for i in range(m - j):
            q[i, j] = (q[i + 1, j - 1] - q[i, j - 1]) / (z[i + j] - z[i])
    # the Newton form and its derivative, accumulated term by term
    val = np.zeros(k)
    dval = np.zeros(k)
    prod = 1.0
    dprod = 0.0
    val += q[0, 0]
    for j in range(1, m):
        dprod = dprod * (t - z[j - 1]) + prod
        prod = prod * (t - z[j - 1])
        val = val + q[0, j] * prod
        dval = dval + q[0, j] * dprod
    return val, dval


@dataclass
class Trajectory:
    epoch0: Epoch
    ts: np.ndarray  # [K] seconds relative to epoch0, strictly increasing
    ys: np.ndarray  # [K, N] flat state vectors (N >= 9)
    template: Spacecraft

    @classmethod
    def from_capture(cls, epoch0, ts, ys, template) -> "Trajectory":
        ts = np.asarray(ts, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        order = np.argsort(ts, kind="stable")
        ts, ys = ts[order], ys[order]
        keep = np.concatenate([[True], np.diff(ts) > 0])
        return cls(epoch0, ts[keep], ys[keep], template)

    def __len__(self):
        return len(self.ts)

    @property
    def first(self) -> Spacecraft:
        return self._state_at_index(0)

    @property
    def last(self) -> Spacecraft:
        return self._state_at_index(len(self.ts) - 1)

    @property
    def start_epoch(self) -> Epoch:
        return self.epoch0 + float(self.ts[0])

    @property
    def end_epoch(self) -> Epoch:
        return self.epoch0 + float(self.ts[-1])

    def _state_at_index(self, i: int) -> Spacecraft:
        return self.template.set_vector(self.epoch0 + float(self.ts[i]), self.ys[i])

    def _window(self, t_rel: float):
        i = int(np.searchsorted(self.ts, t_rel))
        half = INTERPOLATION_SAMPLES // 2
        lo = max(0, min(i - half, len(self.ts) - INTERPOLATION_SAMPLES))
        hi = min(len(self.ts), lo + INTERPOLATION_SAMPLES)
        return lo, hi

    def interpolate(self, t_rel: float) -> np.ndarray:
        """Interpolated flat state at relative seconds (Hermite pos/vel,
        linear in the other columns)."""
        if not (self.ts[0] - 1e-9 <= t_rel <= self.ts[-1] + 1e-9):
            raise TrajError(
                f"epoch {t_rel} s outside trajectory [{self.ts[0]}, {self.ts[-1]}]"
            )
        lo, hi = self._window(t_rel)
        ts = self.ts[lo:hi]
        ys = self.ys[lo:hi]
        # thin near-coincident nodes: adaptive-step bursts can put tiny
        # steps next to long ones in one window, and the high-degree Newton
        # divided differences then cancel catastrophically. Every node lies
        # on the trajectory, so dropping those closer than a quarter of the
        # window's mean spacing loses nothing.
        if len(ts) > 2:
            min_dt = 0.25 * (ts[-1] - ts[0]) / (len(ts) - 1)
            keep = [0]
            for i in range(1, len(ts)):
                if ts[i] - ts[keep[-1]] >= min_dt or i == len(ts) - 1:
                    keep.append(i)
            if len(keep) < len(ts):
                ts, ys = ts[keep], ys[keep]
        # normalize time for conditioning
        tmid = ts[len(ts) // 2]
        pos, vel = hermite_eval(ts - tmid, ys[:, 0:3], ys[:, 3:6], t_rel - tmid)
        out = self.ys[0].copy()
        out[0:3] = pos
        out[3:6] = vel
        for col in range(6, self.ys.shape[1]):
            out[col] = np.interp(t_rel, self.ts, self.ys[:, col])
        return out

    def at(self, epoch: Epoch) -> Spacecraft:
        t_rel = (epoch - self.epoch0).to_seconds()
        return self.template.set_vector(epoch, self.interpolate(t_rel)[:9])

    # ---------------- queries ----------------------------------------
    def every(self, step) -> Iterator[Spacecraft]:
        step_s = _secs(step)
        t = float(self.ts[0])
        while t <= self.ts[-1] + 1e-9:
            yield self.template.set_vector(
                self.epoch0 + t, self.interpolate(min(t, float(self.ts[-1])))[:9]
            )
            t += step_s

    def every_between(self, step, start: Epoch, end: Epoch) -> Iterator[Spacecraft]:
        step_s = _secs(step)
        t = (start - self.epoch0).to_seconds()
        t_end = (end - self.epoch0).to_seconds()
        while t <= t_end + 1e-9:
            yield self.template.set_vector(self.epoch0 + t, self.interpolate(t)[:9])
            t += step_s

    def values_of(self, parameter: str, ys) -> np.ndarray:
        """A StateParameter of the states `ys` [K, N] in this trajectory's
        frame (the port's `param.value` on CPU float64 tensors)."""
        frame = self.template.frame
        y = torch.as_tensor(np.asarray(ys, dtype=np.float64))
        return param_mod.value(parameter, y, frame.mu, frame.radius_km or 0.0).numpy()

    def sample_values(self, parameter: str, step) -> tuple[np.ndarray, np.ndarray]:
        """(rel_seconds, values) of a StateParameter at a fixed step."""
        ts = np.arange(self.ts[0], self.ts[-1] + 1e-9, _secs(step))
        ys = np.stack([self.interpolate(t) for t in ts])
        return ts, self.values_of(parameter, ys)

    def resample(self, step) -> "Trajectory":
        ts = np.arange(self.ts[0], self.ts[-1] + 1e-9, _secs(step))
        ys = np.stack([self.interpolate(t) for t in ts])
        return Trajectory(self.epoch0, ts, ys, self.template)

    def rebuild(self, epochs) -> "Trajectory":
        """New trajectory whose nodes sit exactly at `epochs` (any, possibly
        non-uniform, epochs), each interpolated from this trajectory."""
        ts = np.asarray([(e - self.epoch0).to_seconds() for e in epochs], dtype=np.float64)
        ys = np.stack([self.interpolate(float(t)) for t in ts])
        return Trajectory(self.epoch0, ts, ys, self.template)

    def filter_by_epoch(self, start: Epoch, end: Epoch) -> "Trajectory":
        """Sub-trajectory whose nodes fall in [start, end]."""
        s = (start - self.epoch0).to_seconds()
        e = (end - self.epoch0).to_seconds()
        keep = (self.ts >= s - 1e-9) & (self.ts <= e + 1e-9)
        if not np.any(keep):
            raise TrajError("no trajectory nodes in the requested window")
        return Trajectory(self.epoch0, self.ts[keep], self.ys[keep], self.template)

    def filter_by_offset(self, start_offset_s=0.0, end_offset_s=None) -> "Trajectory":
        """Sub-trajectory by offsets (s or Duration) from the first node."""
        t0 = float(self.ts[0])
        keep = self.ts - t0 >= _secs(start_offset_s) - 1e-9
        if end_offset_s is not None:
            keep &= self.ts - t0 <= _secs(end_offset_s) + 1e-9
        if not np.any(keep):
            raise TrajError("no trajectory nodes in the requested window")
        return Trajectory(self.epoch0, self.ts[keep], self.ys[keep], self.template)

    # ---------------- export (parquet/OEM in io.export) ---------------
    def to_parquet(self, path, cfg=None):
        from ..io.export import traj_to_parquet

        return traj_to_parquet(self, path, cfg)

    def to_oem(self, path, cfg=None):
        from ..io.export import traj_to_oem

        return traj_to_oem(self, path, cfg)

    def __str__(self):
        return f"Trajectory from {self.start_epoch} to {self.end_epoch} ({len(self.ts)} states)"


def _secs(x) -> float:
    return x.to_seconds() if isinstance(x, Duration) else float(x)
