"""Trajectory storage and Hermite interpolation.

Host-side numpy copy of the parts of nyx_tpu/md/trajectory.py that the
tracking simulator and the OD checks use: `hermite_eval`, and a
`Trajectory` built from a propagation's captured nodes with the
13-sample sliding-window Hermite interpolation of position and velocity
(linear in the other columns), including the window's thinning of
near-coincident nodes. Resampling, events and queries are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cosmic.spacecraft import Spacecraft
from ..errors import TrajError
from ..time import Epoch

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
