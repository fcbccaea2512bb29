"""Trajectory storage and Hermite interpolation.

Host-side numpy copy of nyx_tpu/md/trajectory.py:1-234: `hermite_eval`,
and a `Trajectory` built from a propagation's captured nodes with the
13-sample sliding-window Hermite interpolation of position and velocity
(linear in the other columns), including the window's thinning of
near-coincident nodes, at one time or at many (`interpolate_many`, one
divided-difference table a window); its queries (first/last, every, every_between,
sample_values, resample, rebuild, filter_by_*) and its parquet and OEM
export (io/export.py); the frame transform (`to_frame`: a centre change
through the almanac, a rotation through J2000 with the transport term
from `torch.func.jvp` of the DCM), the ground track and the RIC
difference to another trajectory (nyx_tpu/md/trajectory.py:238-352);
`from_bsp` (sampling an SPK through the almanac), `to_ephemeris` (an SPK
type-3 BSP through io/spk.py) and `from_parquet` (:360-417).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator

import numpy as np
import torch

from ..constants import NAIF
from ..cosmic.frames import Frames
from ..cosmic.orbit import Orbit, ric_dcm
from ..cosmic.rotations import apply_dcm, apply_dcm_t
from ..cosmic.spacecraft import Spacecraft
from ..errors import ConfigError, TrajError
from ..time import Duration, Epoch
from . import param as param_mod

INTERPOLATION_SAMPLES = 13
# The body-fixed frame of each centre with an IAU model (groundtrack).
_IAU_FRAMES = {NAIF.EARTH: Frames.IAU_EARTH, NAIF.MOON: Frames.IAU_MOON, NAIF.MARS: Frames.IAU_MARS,
               NAIF.SUN: Frames.IAU_SUN}


def _divided_differences(ts, ys, yds):
    """(doubled nodes z [2n], Newton coefficients q[0, :] [2n, k]) of the
    Hermite interpolant of values ys [n, k] and derivatives yds [n, k] at
    ts [n]."""
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
    return z, q[0]


def _newton_eval(z, q0, t):
    """The Newton form with coefficients q0 [m, k] on nodes z [m] and its
    derivative at t (a float, or an array [T]: values [T, k]), accumulated
    term by term."""
    t = np.asarray(t, dtype=np.float64)[..., None]
    val = np.zeros(t.shape[:-1] + q0.shape[1:])
    dval = np.zeros_like(val)
    prod = np.ones_like(t)
    dprod = np.zeros_like(t)
    val += q0[0]
    for j in range(1, len(z)):
        dprod = dprod * (t - z[j - 1]) + prod
        prod = prod * (t - z[j - 1])
        val = val + q0[j] * prod
        dval = dval + q0[j] * dprod
    return val, dval


def hermite_eval(ts, ys, yds, t):
    """Hermite interpolation with derivatives at `t`.

    ts [n], ys [n, k] values, yds [n, k] derivatives. Returns (y [k], yd [k]).
    Newton divided-difference formulation on 2n doubled nodes.
    """
    return _newton_eval(*_divided_differences(ts, ys, yds), float(t))


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

    def interpolate(self, t_rel: float) -> np.ndarray:
        """Interpolated flat state at relative seconds (Hermite pos/vel,
        linear in the other columns)."""
        return self.interpolate_many(np.array([t_rel], dtype=np.float64))[0]

    def interpolate_many(self, t_rel) -> np.ndarray:
        """[T, N] interpolated flat states at relative seconds t_rel [T], each
        as `interpolate` gives it: the times that share a 13-node window
        share its divided differences."""
        t_rel = np.asarray(t_rel, dtype=np.float64)
        bad = (t_rel < self.ts[0] - 1e-9) | (t_rel > self.ts[-1] + 1e-9)
        if bad.any():
            raise TrajError(
                f"epoch {t_rel[bad][0]} s outside trajectory [{self.ts[0]}, {self.ts[-1]}]"
            )
        half = INTERPOLATION_SAMPLES // 2
        i = np.searchsorted(self.ts, t_rel)
        lo = np.maximum(0, np.minimum(i - half, len(self.ts) - INTERPOLATION_SAMPLES))
        out = np.repeat(self.ys[:1], len(t_rel), axis=0)
        for col in range(6, self.ys.shape[1]):
            out[:, col] = np.interp(t_rel, self.ts, self.ys[:, col])
        for w in np.unique(lo):
            sel = lo == w
            ts = self.ts[w:w + INTERPOLATION_SAMPLES]
            ys = self.ys[w:w + INTERPOLATION_SAMPLES]
            # thin near-coincident nodes: adaptive-step bursts can put tiny
            # steps next to long ones in one window, and the high-degree
            # Newton divided differences then cancel catastrophically. Every
            # node lies on the trajectory, so dropping those closer than a
            # quarter of the window's mean spacing loses nothing.
            if len(ts) > 2:
                min_dt = 0.25 * (ts[-1] - ts[0]) / (len(ts) - 1)
                keep = [0]
                for j in range(1, len(ts)):
                    if ts[j] - ts[keep[-1]] >= min_dt or j == len(ts) - 1:
                        keep.append(j)
                if len(keep) < len(ts):
                    ts, ys = ts[keep], ys[keep]
            # normalize time for conditioning
            tmid = ts[len(ts) // 2]
            z, q0 = _divided_differences(ts - tmid, ys[:, 0:3], ys[:, 3:6])
            pos, vel = _newton_eval(z, q0, t_rel[sel] - tmid)
            out[sel, 0:3] = pos
            out[sel, 3:6] = vel
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
        return ts, self.values_of(parameter, self.interpolate_many(ts))

    def resample(self, step) -> "Trajectory":
        ts = np.arange(self.ts[0], self.ts[-1] + 1e-9, _secs(step))
        return Trajectory(self.epoch0, ts, self.interpolate_many(ts), self.template)

    def rebuild(self, epochs) -> "Trajectory":
        """New trajectory whose nodes sit exactly at `epochs` (any, possibly
        non-uniform, epochs), each interpolated from this trajectory."""
        ts = np.asarray([(e - self.epoch0).to_seconds() for e in epochs], dtype=np.float64)
        return Trajectory(self.epoch0, ts, self.interpolate_many(ts), self.template)

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

    # ---------------- frames and comparisons -------------------------
    def to_frame(self, frame, almanac=None, *, device="cuda") -> "Trajectory":
        """Every node in `frame`: moved to its centre (the almanac's
        positions, velocities by central differences with h = 16 s), then
        rotated old -> J2000 -> new on `device`, velocities with the
        transport term dDCM/dt @ r of each rotating frame."""
        old = self.template.frame
        ys = np.array(self.ys, copy=True)
        t_tdb = self.epoch0.to_tdb_seconds() + self.ts
        if frame.center != old.center:
            if almanac is None:
                raise TrajError("changing central bodies requires an almanac")
            h = 16.0
            ys[:, 0:3] += almanac.position(old.center, frame.center, t_tdb)
            ys[:, 3:6] += (almanac.position(old.center, frame.center, t_tdb + h)
                           - almanac.position(old.center, frame.center, t_tdb - h)) / (2 * h)
        if frame.orientation != old.orientation:
            f64 = dict(dtype=torch.float64, device=device)
            tt = torch.as_tensor(t_tdb, **f64)
            ones = torch.ones_like(tt)
            dcm_old, dot_old = torch.func.jvp(old.dcm_from_j2000, (tt,), (ones,))
            dcm_new, dot_new = torch.func.jvp(frame.dcm_from_j2000, (tt,), (ones,))
            r_old, v_old = torch.as_tensor(ys[:, 0:3], **f64), torch.as_tensor(ys[:, 3:6], **f64)
            r_j = apply_dcm_t(dcm_old, r_old)
            v_j = apply_dcm_t(dcm_old, v_old) + apply_dcm_t(dot_old, r_old)
            ys[:, 0:3] = apply_dcm(dcm_new, r_j).cpu().numpy()
            ys[:, 3:6] = (apply_dcm(dcm_new, v_j) + apply_dcm(dot_new, r_j)).cpu().numpy()
        orbit = Orbit(ys[0, 0:3].copy(), ys[0, 3:6].copy(), self.epoch0 + float(self.ts[0]), frame)
        return Trajectory(self.epoch0, self.ts.copy(), ys, replace(self.template, orbit=orbit))

    def groundtrack(self, body_frame=None, step=60.0, *, device="cuda"):
        """(epochs_rel_s, lat_deg, lon_deg, alt_km) under the trajectory
        every `step`, the rotation on `device`. `body_frame` defaults to the
        IAU frame of the trajectory's centre (the reference's default is
        IAU_EARTH whatever the centre); a frame about another body raises,
        since the positions are not moved to its centre."""
        center = self.template.frame.center
        if body_frame is None:
            if center not in _IAU_FRAMES:
                raise ConfigError(f"no IAU body frame for center {center}; pass body_frame")
            body_frame = _IAU_FRAMES[center]
        if body_frame.center != center:
            raise ConfigError(f"ground track in {body_frame} of a trajectory about {self.template.frame}: "
                              "move the trajectory to its centre first (to_frame)")
        ts = np.arange(float(self.ts[0]), float(self.ts[-1]) + 1e-9, _secs(step))
        rs = self.interpolate_many(ts)[:, :3]
        f64 = dict(dtype=torch.float64, device=device)
        dcm = body_frame.dcm_from_j2000(torch.as_tensor(self.epoch0.to_tdb_seconds() + ts, **f64))
        r_bf = apply_dcm(dcm, torch.as_tensor(rs, **f64)).cpu().numpy()
        rmag = np.linalg.norm(r_bf, axis=-1)
        lat = np.degrees(np.arcsin(r_bf[:, 2] / rmag))
        lon = np.degrees(np.arctan2(r_bf[:, 1], r_bf[:, 0]))
        return ts, lat, lon, rmag - (body_frame.radius_km or 0.0)

    def ric_diff(self, other: "Trajectory", step=60.0):
        """(epochs_rel_s, dr_ric [K, 3], dv_ric [K, 3]) of this trajectory
        minus `other` in `other`'s RIC frame, every `step` over their common
        span (host, float64)."""
        off = (self.epoch0 - other.epoch0).to_seconds()
        t0 = max(float(self.ts[0]), float(other.ts[0]) - off)
        t1 = min(float(self.ts[-1]), float(other.ts[-1]) - off)
        ts = np.arange(t0, t1 + 1e-9, _secs(step))
        mine = self.interpolate_many(ts)[:, :6]
        theirs = other.interpolate_many(ts + off)[:, :6]
        dcm = ric_dcm(torch.from_numpy(theirs[:, 0:3].copy()), torch.from_numpy(theirs[:, 3:6].copy())).numpy()
        dr = np.einsum("kij,kj->ki", dcm, mine[:, 0:3] - theirs[:, 0:3])
        dv = np.einsum("kij,kj->ki", dcm, mine[:, 3:6] - theirs[:, 3:6])
        return ts, dr, dv

    def ric_diff_to_parquet(self, other: "Trajectory", path, step=60.0) -> str:
        """`ric_diff` written as a zstd parquet table: epoch_rel_s, the
        position and velocity difference norms and each RIC component."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        ts, dr, dv = self.ric_diff(other, step)
        cols = {"epoch_rel_s": ts, "delta_r_km": np.linalg.norm(dr, axis=-1),
                "delta_v_km_s": np.linalg.norm(dv, axis=-1)}
        for i, lbl in enumerate(("radial", "in_track", "cross_track")):
            cols[f"dr_{lbl}_km"] = dr[:, i]
            cols[f"dv_{lbl}_km_s"] = dv[:, i]
        pq.write_table(pa.table(cols), str(path), compression="zstd")
        return str(path)

    # ---------------- export (parquet/OEM in io.export) ---------------
    def to_parquet(self, path, cfg=None):
        from ..io.export import traj_to_parquet

        return traj_to_parquet(self, path, cfg)

    def to_oem(self, path, cfg=None):
        from ..io.export import traj_to_oem

        return traj_to_oem(self, path, cfg)

    def to_ephemeris(self, path, target: int = -10_000, degree: int = 11,
                     intlen_s: float | None = None) -> str:
        """Export as a SPICE BSP (one SPK type-3 Chebyshev segment), as the
        reference's to_ephemeris -> ANISE BSP (sc_traj.rs:158)."""
        from ..io.spk import traj_to_bsp

        return traj_to_bsp(self, path, target, degree, intlen_s)

    @classmethod
    def from_bsp(cls, almanac, target: int, center: int, frame, template, start, end,
                 step_s: float = 300.0) -> "Trajectory":
        """A Trajectory sampled every `step_s` from a loaded SPK through
        `almanac.state` (sc_traj.rs from_bsp:90-134); `template` gives the
        columns past the orbit, and `frame` the states' frame."""
        n = int((end - start).to_seconds() / step_s) + 1
        ts = np.arange(n, dtype=np.float64) * step_s
        base = template.to_vector()
        ys = np.zeros((n, base.shape[0]))
        for i, t in enumerate(ts):
            r, v = almanac.state(target, center, start + float(t))
            row = base.copy()
            row[0:3] = r
            row[3:6] = v
            ys[i] = row
        return cls(start, ts, ys, template.with_orbit(replace(template.orbit, frame=frame)))

    @classmethod
    def from_parquet(cls, path, template) -> "Trajectory":
        """A trajectory written by to_parquet (it needs the cartesian x..vz
        columns; sc_traj.rs:212 parity). `template` gives the frame and
        the spacecraft's constants."""
        import pyarrow.parquet as pq

        table = pq.read_table(path)
        missing = [c for c in ("epoch_tai_s", "x", "y", "z", "vx", "vy", "vz")
                   if c not in table.column_names]
        if missing:
            raise TrajError(f"parquet trajectory missing columns: {missing}")
        tai = np.asarray(table["epoch_tai_s"])
        epoch0 = Epoch.from_tai_seconds_j2000(float(tai[0]))
        ts = tai - tai[0]
        ys = np.tile(template.to_vector(), (len(ts), 1))
        for j, c in enumerate(("x", "y", "z", "vx", "vy", "vz")):
            ys[:, j] = np.asarray(table[c])
        return cls.from_capture(epoch0, ts, ys, template)

    def __str__(self):
        return f"Trajectory from {self.start_epoch} to {self.end_epoch} ({len(self.ts)} states)"


def _secs(x) -> float:
    return x.to_seconds() if isinstance(x, Duration) else float(x)
