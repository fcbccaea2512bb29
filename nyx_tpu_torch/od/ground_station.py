"""Ground stations: geometry, visibility, one-way and two-way observables.

Torch port of the core of nyx_tpu/od/ground_station.py. Observables are
batched over epochs: `station_geometry` gives each epoch's station
position and velocity in J2000 and the J2000 -> SEZ rotation, and
`observe` the range, range rate, azimuth, elevation or position of a
spacecraft state against it, optionally backdated by the downlink light
time (`light_time_backdate`, per row). The station velocity is d/dt of
`frame.dcm_from_j2000(t).T @ r_bf`, taken with `torch.func.jvp` over time
as the reference takes it with `jax.jvp`. The OD filter gathers the
geometry by tracker index (per-row latitude, longitude and height) and
differentiates `observe` alone. A two-way observable (`two_way_fn`) is the
average of the one-way values at t - T_int and t. YAML I/O, terrain masks,
timestamp noise and cross-body targets are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import SPEED_OF_LIGHT_KM_S
from ..cosmic.frames import Frame, Frames
from ..cosmic.rotations import apply_dcm, apply_dcm_t
from ..xmath import norm
from .msr import MeasurementType
from .noise import StochasticNoise

_D2R = math.pi / 180.0
_R2D = 180.0 / math.pi


def geodetic_to_body_fixed(lat_deg, lon_deg, height_km, radius_eq_km, flattening):
    """Geodetic coordinates (tensors) -> body-fixed Cartesian position
    [..., 3] (km)."""
    lat = lat_deg * _D2R
    lon = lon_deg * _D2R
    e2 = flattening * (2.0 - flattening)
    sin_lat = torch.sin(lat)
    n = radius_eq_km / torch.sqrt(1.0 - e2 * sin_lat**2)
    x = (n + height_km) * torch.cos(lat) * torch.cos(lon)
    y = (n + height_km) * torch.cos(lat) * torch.sin(lon)
    z = (n * (1.0 - e2) + height_km) * sin_lat
    return torch.stack([x, y, z], dim=-1)


def sez_dcm(lat_deg, lon_deg):
    """DCM [..., 3, 3] body-fixed -> SEZ (South-East-Zenith)."""
    lat = lat_deg * _D2R
    lon = lon_deg * _D2R
    sl, cl = torch.sin(lat), torch.cos(lat)
    so, co = torch.sin(lon), torch.cos(lon)
    zero = torch.zeros_like(sl)
    return torch.stack(
        [
            torch.stack([sl * co, sl * so, -cl], -1),  # South
            torch.stack([-so, co, zero], -1),  # East
            torch.stack([cl * co, cl * so, sl], -1),  # Zenith
        ],
        -2,
    )


def station_geometry(t_tdb, lat_deg, lon_deg, height_km, frame: Frame):
    """(r_st [K, 3], v_st [K, 3], sez [K, 3, 3]) at TDB epochs `t_tdb` [K]
    for stations at per-epoch geodetic coordinates ([K] tensors): the
    station's J2000 position and velocity and the J2000 -> SEZ rotation."""
    r_bf = geodetic_to_body_fixed(lat_deg, lon_deg, height_km, frame.radius_km, frame.flattening)

    def pos(t):
        return apply_dcm_t(frame.dcm_from_j2000(t), r_bf)

    r_st, v_st = torch.func.jvp(pos, (t_tdb,), (torch.ones_like(t_tdb),))
    sez = torch.matmul(sez_dcm(lat_deg, lon_deg), frame.dcm_from_j2000(t_tdb))
    return r_st, v_st, sez


def light_time_backdate(rv6, r_st):
    """States rv6 [K, 6] moved back along their velocity by the downlink
    light time tau = rho(t - tau) / c, from two fixed-point iterations
    with the station position r_st [K, 3] at t (the reference's
    `_light_time_backdate`, ground_station.py:252-266; linear in velocity,
    the tau^2 a / 2 term is ~mm at LEO ranges). Differentiable, so H
    includes the correction."""
    r, v = rv6[:, 0:3], rv6[:, 3:6]
    tau = norm(r - r_st)[:, None] / SPEED_OF_LIGHT_KM_S
    tau = norm(r - tau * v - r_st)[:, None] / SPEED_OF_LIGHT_KM_S
    return torch.cat([r - tau * v, v], dim=-1)


def observe(rv6, r_st, v_st, sez, types: Sequence[str], lt=None):
    """Noiseless one-way observables [K, T] of spacecraft states rv6
    [K, 6] (J2000) against the station geometry of `station_geometry`.
    `lt` ([K] tensor, or a bool for every row): rows where it is true
    (> 0) see the state backdated by the light time."""
    if isinstance(lt, bool):
        lt = torch.ones_like(rv6[:, 0]) if lt else None
    if lt is not None:
        rv6 = torch.where(lt[:, None] > 0, light_time_backdate(rv6, r_st), rv6)
    rho = apply_dcm(sez, rv6[:, 0:3] - r_st)
    rho_dot = apply_dcm(sez, rv6[:, 3:6] - v_st)
    rng = norm(rho)
    table = {
        MeasurementType.RANGE_KM: lambda: rng,
        MeasurementType.DOPPLER_KM_S: lambda: torch.sum(rho * rho_dot, dim=-1) / rng,
        MeasurementType.AZIMUTH_DEG: lambda: torch.remainder(
            torch.atan2(rho[:, 1], -rho[:, 0]) * _R2D, 360.0),
        MeasurementType.ELEVATION_DEG: lambda: torch.asin(rho[:, 2] / rng) * _R2D,
        MeasurementType.X_KM: lambda: rv6[:, 0],
        MeasurementType.Y_KM: lambda: rv6[:, 1],
        MeasurementType.Z_KM: lambda: rv6[:, 2],
    }
    return torch.stack([table[t]() for t in types], dim=-1)


@dataclass
class GroundStation:
    """A tracking ground station."""

    name: str
    latitude_deg: float
    longitude_deg: float
    height_km: float
    frame: Frame = Frames.IAU_EARTH
    elevation_mask_deg: float = 0.0
    measurement_types: Tuple[str, ...] = (
        MeasurementType.RANGE_KM,
        MeasurementType.DOPPLER_KM_S,
    )
    # two-way integration time (None or 0: one-way observables)
    integration_time_s: Optional[float] = None
    light_time_correction: bool = False
    stochastic_noises: Dict[str, StochasticNoise] = field(default_factory=dict)

    # -- DSN builtins, IAU_EARTH geodetic coordinates (the reference's
    # ground_station.py:120-136) ------------------------------------------
    @classmethod
    def dss65_madrid(cls, elevation_mask_deg=5.0, frame=Frames.IAU_EARTH):
        return cls("Madrid", 40.427_222, 4.250_556, 0.834_939, frame,
                   elevation_mask_deg).with_dsn_defaults()

    @classmethod
    def dss34_canberra(cls, elevation_mask_deg=5.0, frame=Frames.IAU_EARTH):
        return cls("Canberra", -35.398_333, 148.981_944, 0.691_750, frame,
                   elevation_mask_deg).with_dsn_defaults()

    @classmethod
    def dss13_goldstone(cls, elevation_mask_deg=5.0, frame=Frames.IAU_EARTH):
        return cls("Goldstone", 35.247_164, 243.205, 1.071_149, frame,
                   elevation_mask_deg).with_dsn_defaults()

    def with_dsn_defaults(self) -> "GroundStation":
        self.stochastic_noises = {
            MeasurementType.RANGE_KM: StochasticNoise.default_range_km(),
            MeasurementType.DOPPLER_KM_S: StochasticNoise.default_doppler_km_s(),
        }
        return self

    # ------------------------------------------------------------------
    def _geometry(self, t_tdb):
        k = dict(dtype=torch.float64, device=t_tdb.device)
        lat, lon, hgt = (torch.full(t_tdb.shape, float(x), **k)
                         for x in (self.latitude_deg, self.longitude_deg, self.height_km))
        return station_geometry(t_tdb, lat, lon, hgt, self.frame)

    def _one_way(self, t_tdb, rv6, types):
        """[K, T] observables at TDB epochs t_tdb [K] of states rv6 [K, 6],
        backdated by the light time if the station corrects for it."""
        return observe(rv6, *self._geometry(t_tdb), types, lt=self.light_time_correction)

    def two_way_fn(self, types: Optional[Sequence[str]] = None):
        """`h2(t_tdb [K], rv6_t [K, 6], rv6_tm [K, 6]) -> [K, T]`: the
        two-way observable, the average of the one-way values at the end
        (t) and the start (t - T_int) of the integration interval."""
        types = tuple(types or self.measurement_types)
        t_int = float(self.integration_time_s or 0.0)

        def h2(t, rv6_t, rv6_tm):
            v1 = self._one_way(t, rv6_t, types)
            v0 = self._one_way(t - t_int, rv6_tm, types)
            return 0.5 * (v0 + v1)

        return h2

    def batch_values(self, ts_tdb_s, ys6, types: Optional[Sequence[str]] = None, *,
                     device="cuda"):
        """Noiseless one-way observations (light time as the station says)
        and elevations (without it) over a strand, computed on `device`:
        numpy (values [K, T], elevation_deg [K])."""
        types = tuple(types or self.measurement_types)
        t, y = _on(ts_tdb_s, ys6, device)
        geo = self._geometry(t)
        if not self.light_time_correction:
            out = observe(y, *geo, types + (MeasurementType.ELEVATION_DEG,)).cpu().numpy()
            return out[:, :-1], out[:, -1]
        vals = observe(y, *geo, types, lt=True).cpu().numpy()
        el = observe(y, *geo, (MeasurementType.ELEVATION_DEG,)).cpu().numpy()
        return vals, el[:, 0]

    def batch_azel(self, ts_tdb_s, ys6, *, device="cuda"):
        """(azimuth_deg [K], elevation_deg [K]) over a sample grid, computed
        on `device`, as numpy."""
        t, y = _on(ts_tdb_s, ys6, device)
        out = self._one_way(t, y, (MeasurementType.AZIMUTH_DEG,
                                   MeasurementType.ELEVATION_DEG)).cpu().numpy()
        return out[:, 0], out[:, 1]


def _on(ts, ys6, device):
    k = dict(dtype=torch.float64, device=device)
    return torch.as_tensor(np.asarray(ts), **k), torch.as_tensor(np.asarray(ys6)[:, :6], **k)
