"""Spacecraft-to-spacecraft (interlink) tracking.

Torch port of nyx_tpu/od/interlink.py:28-197: a transmitter spacecraft with
its own trajectory acts as the tracking device, producing crosslink range
and Doppler. The transmitter's trajectory is resampled on a uniform grid
(`DeviceTrajectory`) and looked up on the device by a cubic Hermite, so the
filter differentiates the crosslink observables as it does a station's.
Visibility is a line-of-sight test against the central body's sphere, given
to the scheduler as a pseudo-elevation of +90 deg (clear) or -90 deg
(occulted). `DeviceTrajectory` also carries the cross-body centre offsets of
`GroundStation.with_target_frame`.

Every observable is batched over epochs: t_tdb [K], states rv6 [K, 6].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..xmath import norm
from .msr import MeasurementType
from .noise import StochasticNoise


@dataclass(eq=False)
class DeviceTrajectory:
    """A dense trajectory table with a cubic-Hermite state lookup.

    ts: [K] TDB seconds past J2000, increasing
    ys: [K, 6] position and velocity rows
    center: NAIF id of the body the states are about, where known
    """

    ts: np.ndarray
    ys: np.ndarray
    center: Optional[int] = None
    _cache: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_trajectory(cls, traj, step_s: float = 60.0) -> "DeviceTrajectory":
        """`traj` resampled every `step_s` from its first node to its last
        (which closes the grid), by one batched interpolation."""
        t0_tdb = traj.epoch0.to_tdb_seconds()
        t_rel = np.arange(float(traj.ts[0]), float(traj.ts[-1]) + 1e-9, step_s)
        if t_rel[-1] < float(traj.ts[-1]) - 1e-6:
            t_rel = np.append(t_rel, float(traj.ts[-1]))
        ys = traj.interpolate_many(t_rel)[:, :6]
        return cls(t0_tdb + t_rel, ys, traj.template.frame.center)

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ts [K], ys [K, 6]) as float64 tensors on `device`, cached."""
        key = str(torch.device(device))
        if key not in self._cache:
            k = dict(dtype=torch.float64, device=device)
            self._cache[key] = (torch.as_tensor(np.asarray(self.ts), **k),
                                torch.as_tensor(np.asarray(self.ys), **k))
        return self._cache[key]

    def state_at(self, t_tdb: torch.Tensor) -> torch.Tensor:
        """[K, 6] states at TDB epochs t_tdb [K], on t_tdb's device."""
        ts, ys = self.tables(t_tdb.device)
        i = torch.clamp(torch.searchsorted(ts, t_tdb) - 1, 0, ts.shape[0] - 2)
        return hermite_rows(t_tdb, ts[i], ts[i + 1], ys[i], ys[i + 1])


def hermite_rows(t, t0, t1, y0, y1):
    """Per-row cubic Hermite [K, 6] at times t [K] inside intervals
    [t0, t1] (each [K]) with position and velocity endpoints y0, y1
    [K, 6]; the velocity is the basis' derivative."""
    h = (t1 - t0)[:, None]
    s = ((t - t0)[:, None]) / h
    r0, v0, r1, v1 = y0[:, 0:3], y0[:, 3:6], y1[:, 0:3], y1[:, 3:6]
    s2, s3 = s * s, s * s * s
    r = ((2 * s3 - 3 * s2 + 1) * r0 + (s3 - 2 * s2 + s) * h * v0
         + (-2 * s3 + 3 * s2) * r1 + (s3 - s2) * h * v1)
    v = ((6 * s2 - 6 * s) / h * r0 + (3 * s2 - 4 * s + 1) * v0
         + (-6 * s2 + 6 * s) / h * r1 + (3 * s2 - 2 * s) * v1)
    return torch.cat([r, v], dim=-1)


def stack_tables(tables: Sequence[DeviceTrajectory], device):
    """Per-device tables padded to one length by extending the last
    interval (increasing times keep the lookup defined; queries never land
    there, as every arc lies inside its tables): (ts [D, K], ys [D, K, 6])
    on `device`."""
    k_max = max(len(tb.ts) for tb in tables)
    ts_rows, ys_rows = [], []
    for tb in tables:
        ts, ys = np.asarray(tb.ts, dtype=np.float64), np.asarray(tb.ys, dtype=np.float64)
        pad = k_max - len(ts)
        if pad:
            dt_tail = ts[-1] - ts[-2] if len(ts) > 1 else 1.0
            ts = np.concatenate([ts, ts[-1] + dt_tail * np.arange(1, pad + 1)])
            ys = np.concatenate([ys, np.repeat(ys[-1:], pad, axis=0)])
        ts_rows.append(ts)
        ys_rows.append(ys)
    k = dict(dtype=torch.float64, device=device)
    return torch.as_tensor(np.stack(ts_rows), **k), torch.as_tensor(np.stack(ys_rows), **k)


def table_state_rows(t_tdb, trk, ts_tab, ys_tab):
    """[N, 6] states at TDB epochs t_tdb [N], row n looked up in the table
    of device trk[n] of the stacked tables (ts [D, K], ys [D, K, 6]): one
    search a device, then a gather by row."""
    k_len = ts_tab.shape[1]
    rows = torch.arange(t_tdb.shape[0], device=t_tdb.device)
    i_all = torch.stack([torch.searchsorted(ts_tab[d], t_tdb) for d in range(ts_tab.shape[0])])
    i = torch.clamp(i_all[trk, rows] - 1, 0, k_len - 2)
    return hermite_rows(t_tdb, ts_tab[trk, i], ts_tab[trk, i + 1], ys_tab[trk, i], ys_tab[trk, i + 1])


def link_observe(rv6, tx, types: Sequence[str]):
    """Noiseless crosslink observables [K, T] of receiver states rv6 [K, 6]
    against transmitter states tx [K, 6]."""
    rho = rv6[:, 0:3] - tx[:, 0:3]
    rho_dot = rv6[:, 3:6] - tx[:, 3:6]
    rng = norm(rho)
    table = {
        MeasurementType.RANGE_KM: lambda: rng,
        MeasurementType.DOPPLER_KM_S: lambda: torch.sum(rho * rho_dot, dim=-1) / rng,
        MeasurementType.X_KM: lambda: rv6[:, 0],
        MeasurementType.Y_KM: lambda: rv6[:, 1],
        MeasurementType.Z_KM: lambda: rv6[:, 2],
    }
    return torch.stack([table[t]() for t in types], dim=-1)


@dataclass
class InterlinkTxSpacecraft:
    """The transmitter spacecraft as a tracking device. `elevation_mask_deg`
    gates the pseudo-elevation as a station's mask gates its elevation."""

    traj: object  # the transmitter's Trajectory
    name: str = "interlink-tx"
    measurement_types: Tuple[str, ...] = (
        MeasurementType.RANGE_KM,
        MeasurementType.DOPPLER_KM_S,
    )
    integration_time_s: Optional[float] = None
    stochastic_noises: Dict[str, StochasticNoise] = field(default_factory=dict)
    occulting_radius_km: Optional[float] = None  # the central body's LOS radius
    grid_step_s: float = 60.0
    elevation_mask_deg: float = 0.0
    # the transmitter resampled on its grid (`DeviceTrajectory`)
    dev_traj: DeviceTrajectory = field(init=False, repr=False)
    # a transmitter has no terrain: see GroundStation.active_terrain_mask
    active_terrain_mask = None

    def __post_init__(self):
        self.dev_traj = DeviceTrajectory.from_trajectory(self.traj, self.grid_step_s)
        if not self.stochastic_noises:
            self.stochastic_noises = {
                MeasurementType.RANGE_KM: StochasticNoise.default_range_km(),
                MeasurementType.DOPPLER_KM_S: StochasticNoise.default_doppler_km_s(),
            }

    def _link_values(self, t_tdb, rv6, types):
        return self.measurement_fn_at(t_tdb, types)(rv6)

    def _los_clear(self, t_tdb, rv6):
        """[K] pseudo-elevations: +90 deg where the segment from the
        receiver to the transmitter clears the occulting sphere, else -90."""
        if self.occulting_radius_km is None:
            return torch.full_like(t_tdb, 90.0)
        tx = self.dev_traj.state_at(t_tdb)[:, 0:3]
        rx = rv6[:, 0:3]
        d = tx - rx
        dd = torch.sum(d * d, dim=-1)
        u = torch.clamp(-torch.sum(rx * d, dim=-1) / torch.where(dd > 0, dd, torch.ones_like(dd)),
                        0.0, 1.0)
        clear = norm(rx + u[:, None] * d) > self.occulting_radius_km
        return torch.where(clear, 90.0, -90.0).to(t_tdb.dtype)

    def azimuth_elevation_range(self, t_tdb, rv6):
        """(azimuth_deg, elevation_deg, range_km, range_rate_km_s), each [K],
        as a ground station's: azimuth 0, the pseudo-elevation of the line
        of sight, and the link's range and range rate."""
        vals = self._link_values(t_tdb, rv6, (MeasurementType.RANGE_KM,
                                              MeasurementType.DOPPLER_KM_S))
        return torch.zeros_like(t_tdb), self._los_clear(t_tdb, rv6), vals[:, 0], vals[:, 1]

    def measurement_fn(self, types=None):
        """`h(t_tdb [K], rv6 [K, 6]) -> [K, T]`: `measurement_fn_at` at the
        epochs t_tdb."""
        return lambda t, rv6: self.measurement_fn_at(t, types)(rv6)

    def measurement_fn_at(self, t_tdb, types=None):
        """`h(rv6 [K, 6]) -> [K, T]`, one way, at the fixed epochs t_tdb
        [K], the transmitter's state looked up once."""
        types = tuple(types or self.measurement_types)
        tx = self.dev_traj.state_at(t_tdb)
        return lambda rv6: link_observe(rv6, tx, types)

    def two_way_fn(self, types=None):
        """`h2(t_tdb [K], rv6_t [K, 6], rv6_tm [K, 6]) -> [K, T]`: the average
        of the one-way values at t and t - T_int."""
        types = tuple(types or self.measurement_types)
        t_int = float(self.integration_time_s or 0.0)

        def h2(t, rv6_t, rv6_tm):
            return 0.5 * (self._link_values(t - t_int, rv6_tm, types)
                          + self._link_values(t, rv6_t, types))

        return h2

    def batch_values(self, ts_tdb_s, ys6, types=None, *, device="cuda"):
        """Noiseless crosslink observations and pseudo-elevations over a
        strand, computed on `device`: numpy (values [K, T], elevation [K])."""
        types = tuple(types or self.measurement_types)
        t, y = _on(ts_tdb_s, ys6, device)
        return (self._link_values(t, y, types).cpu().numpy(), self._los_clear(t, y).cpu().numpy())

    def batch_azel(self, ts_tdb_s, ys6, *, device="cuda"):
        """(zeros [K], pseudo-elevation [K]) over a sample grid, computed on
        `device`, as numpy: the elevation channel carries the occultation
        gate."""
        t, y = _on(ts_tdb_s, ys6, device)
        return np.zeros(t.shape[0]), self._los_clear(t, y).cpu().numpy()

    def min_elevation_deg(self, az_deg):
        """Minimum visible pseudo-elevation (deg) at the azimuth(s): the
        flat mask."""
        return np.full(np.shape(az_deg), self.elevation_mask_deg)

    def measurement_covar(self, types=None) -> np.ndarray:
        types = tuple(types or self.measurement_types)
        return np.diag([self.stochastic_noises[t].covariance() for t in types])


def is_interlink(device) -> bool:
    """Whether `device` is an interlink transmitter (else a ground station)."""
    return isinstance(device, InterlinkTxSpacecraft)


def _on(ts, ys6, device):
    k = dict(dtype=torch.float64, device=device)
    return torch.as_tensor(np.asarray(ts), **k), torch.as_tensor(np.asarray(ys6)[:, :6], **k)
