"""Ground-point PNT: an asset on a body's surface estimated from stations.

Port of nyx_tpu/od/groundpnt.py:32-218 (the reference's od/groundpnt/):
the estimated state is a surface asset, its body-fixed position and a slow
velocity (`GroundAsset`, geodetic coordinates and a South-East-Zenith
velocity), with static dynamics (Phi maps the position by the velocity; the
velocity is constant). Stations of the same body track it by range,
Doppler and angles, all body-fixed, so the geometry is time-independent
and the filter needs no integrator. `GroundPntSim` simulates the tracking
and `GroundPntProcess` filters it: the observation and its Jacobian (by
`torch.func.jacfwd`) on `device`, the 6x6 filter algebra on the host, as
the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..cosmic.frames import Frame, Frames
from ..time import Epoch
from .estimate import Residual
from .ground_station import geodetic_to_body_fixed, sez_dcm
from .msr import Measurement, MeasurementType, TrackingDataArc

STATE_DIM = 6  # body-fixed [x, y, z, vx, vy, vz] km, km/s
_R2D = 180.0 / np.pi


def _sez_np(lat_deg, lon_deg) -> np.ndarray:
    return sez_dcm(torch.tensor(float(lat_deg), dtype=torch.float64),
                   torch.tensor(float(lon_deg), dtype=torch.float64)).numpy()


@dataclass
class GroundAsset:
    """The estimated surface state."""

    name: str
    latitude_deg: float
    longitude_deg: float
    height_km: float
    epoch: Epoch
    v_sez_km_s: np.ndarray = field(default_factory=lambda: np.zeros(3))
    frame: Frame = Frames.IAU_EARTH

    def to_vector(self) -> np.ndarray:
        """The body-fixed [x, y, z, vx, vy, vz] (km, km/s)."""
        k = dict(dtype=torch.float64)
        r = geodetic_to_body_fixed(torch.tensor(float(self.latitude_deg), **k),
                                   torch.tensor(float(self.longitude_deg), **k),
                                   torch.tensor(float(self.height_km), **k),
                                   self.frame.radius_km, self.frame.flattening).numpy()
        v = _sez_np(self.latitude_deg, self.longitude_deg).T @ np.asarray(self.v_sez_km_s)
        return np.concatenate([r, v])

    @classmethod
    def from_vector(cls, name, vec, epoch, frame=Frames.IAU_EARTH) -> "GroundAsset":
        """The asset at a body-fixed state: geodetic latitude and height by
        six fixed-point iterations on the flattened body."""
        r = np.asarray(vec[0:3], dtype=np.float64)
        lon = float(np.degrees(np.arctan2(r[1], r[0])))
        f = frame.flattening
        e2 = f * (2 - f)
        req = frame.radius_km
        p = np.hypot(r[0], r[1])
        lat_r = np.arctan2(r[2], p * (1 - e2))
        for _ in range(6):
            n = req / np.sqrt(1 - e2 * np.sin(lat_r) ** 2)
            h = p / np.cos(lat_r) - n
            lat_r = np.arctan2(r[2], p * (1 - e2 * n / (n + h)))
        lat = float(np.degrees(lat_r))
        n = req / np.sqrt(1 - e2 * np.sin(lat_r) ** 2)
        h = float(p / np.cos(lat_r) - n)
        v_sez = _sez_np(lat, lon) @ np.asarray(vec[3:6], dtype=np.float64)
        return cls(name, lat, lon, h, epoch, v_sez, frame)

    def __str__(self):
        return (f"GroundAsset({self.name}: lat {self.latitude_deg:.6f} deg, "
                f"lon {self.longitude_deg:.6f} deg, h {self.height_km * 1e3:.1f} m)")


def _asset_obs(x6, st_bf, st_sez, types):
    """Observations [T] of the asset's state x6 [6] from a station at
    body-fixed st_bf [3] with its SEZ rotation st_sez [3, 3]."""
    rho = st_sez @ (x6[0:3] - st_bf)
    rho_dot = st_sez @ x6[3:6]
    rng = torch.linalg.vector_norm(rho)
    table = {
        MeasurementType.RANGE_KM: lambda: rng,
        MeasurementType.DOPPLER_KM_S: lambda: torch.dot(rho, rho_dot) / rng,
        MeasurementType.AZIMUTH_DEG: lambda: torch.remainder(torch.atan2(rho[1], -rho[0]) * _R2D, 360.0),
        MeasurementType.ELEVATION_DEG: lambda: torch.asin(rho[2] / rng) * _R2D,
    }
    return torch.stack([table[t]() for t in types])


def _station_frame(gs, device):
    """(body-fixed position [3], SEZ rotation [3, 3]) of a station on `device`."""
    k = dict(dtype=torch.float64, device=device)
    return (gs.body_fixed_position(device=device),
            sez_dcm(torch.tensor(float(gs.latitude_deg), **k), torch.tensor(float(gs.longitude_deg), **k)))


class GroundPntSim:
    """Tracking of a ground asset by stations, simulated on `device`."""

    def __init__(self, stations: Sequence, asset: GroundAsset, sampling_s=60.0, seed=0, *,
                 device="cuda"):
        self.stations = list(stations)
        self.asset = asset
        self.sampling_s = sampling_s
        self.seed = seed
        self.device = torch.device(device)

    def generate_measurements(self, duration_s: float) -> TrackingDataArc:
        """Every `sampling_s` over `duration_s`, each station above its
        elevation mask, with its white noise drawn in the reference's order."""
        rng = np.random.default_rng(self.seed)
        x6 = torch.as_tensor(self.asset.to_vector(), dtype=torch.float64, device=self.device)
        geo = {gs.name: _station_frame(gs, self.device) for gs in self.stations}
        obs = {}
        for gs in self.stations:
            types = tuple(gs.measurement_types) + (MeasurementType.ELEVATION_DEG,)
            obs[gs.name] = _asset_obs(x6, *geo[gs.name], types).cpu().numpy()
        out: List[Measurement] = []
        n = int(duration_s / self.sampling_s) + 1
        for k in range(n):
            epoch = self.asset.epoch + k * self.sampling_s
            for gs in self.stations:
                vals = obs[gs.name]
                if vals[-1] < gs.elevation_mask_deg:
                    continue
                data = {}
                for j, t in enumerate(gs.measurement_types):
                    noise = 0.0
                    sn = gs.stochastic_noises.get(t)
                    if sn is not None and sn.white_noise is not None:
                        noise = sn.white_noise.sample(rng)
                    data[t] = float(vals[j]) + noise
                out.append(Measurement(gs.name, epoch, data))
        return TrackingDataArc.from_measurements(out)


class GroundPntProcess:
    """A Kalman filter over the static ground state: Phi = [[I, dt I],
    [0, I]], no process noise."""

    def __init__(self, stations: Sequence, variant: str = "ekf",
                 resid_rejection_sigmas: Optional[float] = None, *, device="cuda"):
        self.stations = {g.name: g for g in stations}
        self.variant = variant
        self.resid_rejection_sigmas = resid_rejection_sigmas
        self.device = torch.device(device)

    def process_arc(self, asset: GroundAsset, covar0: np.ndarray, arc: TrackingDataArc):
        """(the estimated GroundAsset, its covariance [6, 6], the residuals)."""
        f64 = dict(dtype=torch.float64, device=self.device)
        x = asset.to_vector()
        p_mat = np.asarray(covar0, dtype=np.float64).copy()
        t_prev = asset.epoch.to_tai_seconds()
        residuals = []
        h_cache = {}
        for i in range(len(arc)):
            msr = arc.measurement(i)
            gs = self.stations.get(msr.tracker)
            if gs is None:
                continue
            dt = msr.epoch.to_tai_seconds() - t_prev
            t_prev = msr.epoch.to_tai_seconds()
            phi = np.eye(STATE_DIM)
            phi[0:3, 3:6] = dt * np.eye(3)
            x = phi @ x
            p_mat = phi @ p_mat @ phi.T

            types = tuple(t for t in gs.measurement_types if t in msr.data)
            if not types:
                continue
            key = (gs.name, types)
            if key not in h_cache:
                st_bf, st_sez = _station_frame(gs, self.device)

                def h(xx, st_bf=st_bf, st_sez=st_sez, types=types):
                    return _asset_obs(xx, st_bf, st_sez, types)

                h_cache[key] = (h, torch.func.jacfwd(h))
            h_fn, jac_fn = h_cache[key]
            xt = torch.as_tensor(x, **f64)
            both = torch.cat([h_fn(xt)[:, None], jac_fn(xt)], dim=1).cpu().numpy()
            computed, h_mat = both[:, 0], both[:, 1:]
            real = msr.observation(types)
            r_mat = gs.measurement_covar(types)
            prefit = real - computed
            s_mat = h_mat @ p_mat @ h_mat.T + r_mat
            l_chol = np.linalg.cholesky(s_mat)
            ratio = float(np.linalg.norm(np.linalg.solve(l_chol, prefit)) / np.sqrt(len(types)))
            rejected = self.resid_rejection_sigmas is not None and ratio > self.resid_rejection_sigmas
            if not rejected:
                k_gain = np.linalg.solve(s_mat, h_mat @ p_mat.T).T
                x = x + k_gain @ prefit
                ikh = np.eye(STATE_DIM) - k_gain @ h_mat
                p_mat = ikh @ p_mat @ ikh.T + k_gain @ r_mat @ k_gain.T
                p_mat = 0.5 * (p_mat + p_mat.T)
            postfit = real - h_fn(torch.as_tensor(x, **f64)).cpu().numpy()
            residuals.append(Residual(msr.epoch, msr.tracker, types, prefit, postfit, ratio,
                                      bool(rejected)))
        est = GroundAsset.from_vector(asset.name, x, Epoch.from_tai_seconds_j2000(t_prev), asset.frame)
        return est, p_mat, residuals
