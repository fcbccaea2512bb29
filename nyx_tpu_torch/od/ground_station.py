"""Ground stations: geometry, visibility, one-way and two-way observables.

Torch port of nyx_tpu/od/ground_station.py. Observables are batched over
epochs: `station_geometry` gives each epoch's station position and velocity
in J2000 and the J2000 -> SEZ rotation, and `observe` the range, range rate,
azimuth, elevation or position of a spacecraft state against it, optionally
backdated by the downlink light time (`light_time_backdate`, per row). The
station velocity is d/dt of `frame.dcm_from_j2000(t).T @ r_bf`, taken with
`torch.func.jvp` over time as the reference takes it with `jax.jvp`. The OD
filter gathers the geometry by tracker index (per-row latitude, longitude
and height) and differentiates `observe` alone. A two-way observable
(`two_way_fn`) is the average of the one-way values at t - T_int and t. The
station's body is its frame's: its radius and flattening shape the geodetic
conversion, its orientation model the rotation (IAU_MOON stations sit on a
sphere of 1,737.4 km).

A station tracks a spacecraft about another body through
`with_target_frame`: a table of that body's state about the station's
(`target_center_offset`, a `DeviceTrajectory` from the almanac) is added to
every spacecraft state before the geometry. `require_same_center` refuses a
device set that cannot observe states about a given body. Also here:
azimuth-dependent terrain masks (`TerrainMask`), timestamp noise, the
measurement-type editors, the YAML `load` / `load_many` / `load_named` /
`save` (through `io/config.py`), and the single-station geometry that the
OD host loop calls (`body_fixed_position`, `inertial_posvel`, `sez_state`,
`measurement_fn`, `measurement_covar`), batched over epochs as the rest.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import SPEED_OF_LIGHT_KM_S
from ..cosmic.frames import Frame, Frames
from ..cosmic.rotations import apply_dcm, apply_dcm_t
from ..errors import ConfigError
from ..time import Epoch
from ..xmath import FORWARD_AD, norm
from .interlink import DeviceTrajectory, _on, is_interlink
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

    with FORWARD_AD:
        r_st, v_st = torch.func.jvp(pos, (t_tdb,), (torch.ones_like(t_tdb),))
    sez = torch.matmul(sez_dcm(lat_deg, lon_deg), frame.dcm_from_j2000(t_tdb))
    return r_st, v_st, sez


def tracked_center(device) -> int:
    """NAIF id of the body whose states `device` observes: a station's
    body, or the target of its centre-offset table; an interlink
    transmitter's trajectory's centre; None for a device without a frame
    (a GNSS position device observes the state in its own frame)."""
    off = getattr(device, "target_center_offset", None)
    if off is not None:
        return off.center
    if is_interlink(device):
        return device.dev_traj.center
    frame = getattr(device, "frame", None)
    return None if frame is None else frame.center


def require_same_center(devices, state_frame: Frame) -> None:
    """Raise ConfigError unless every device observes states about the
    centre of `state_frame` (`tracked_center`): a station subtracts its
    position about its own body from the spacecraft state, so a station on
    another body needs `with_target_frame` to that centre."""
    for d in devices:
        center = tracked_center(d)
        if center is not None and center != state_frame.center:
            raise ConfigError(
                f"device {d.name} observes states about body {center} but the spacecraft "
                f"state is in {state_frame}: give the station with_target_frame to that centre")


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
class TerrainMask:
    """Azimuth-dependent minimum elevation: breakpoints (azimuth_deg,
    min_elevation_deg); between breakpoints the mask holds the value of
    the region's start azimuth (a step function wrapping at 360 deg).
    `from_flat_terrain` is the constant mask."""

    azimuths_deg: np.ndarray
    elevations_deg: np.ndarray

    def __post_init__(self):
        az = np.mod(np.asarray(self.azimuths_deg, dtype=np.float64), 360.0)
        el = np.asarray(self.elevations_deg, dtype=np.float64)
        order = np.argsort(az)
        self.azimuths_deg, self.elevations_deg = az[order], el[order]

    @classmethod
    def from_flat_terrain(cls, elevation_deg: float) -> "TerrainMask":
        return cls(np.array([0.0]), np.array([float(elevation_deg)]))

    def min_elevation_at(self, az_deg):
        """Minimum visible elevation (deg) at the azimuth(s)."""
        az = np.mod(np.asarray(az_deg, dtype=np.float64), 360.0)
        idx = np.searchsorted(self.azimuths_deg, az, side="right") - 1
        # azimuths below the first breakpoint wrap to the last region
        idx = np.where(idx < 0, len(self.azimuths_deg) - 1, idx)
        return self.elevations_deg[idx]


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
    timestamp_noise_s: Optional[StochasticNoise] = None
    stochastic_noises: Dict[str, StochasticNoise] = field(default_factory=dict)
    # an azimuth-dependent elevation mask on top of elevation_mask_deg
    terrain_mask: Optional[TerrainMask] = None
    terrain_mask_ignored: bool = False
    # cross-body tracking: the trajectory's centre about the station's body
    # (see with_target_frame), added to every spacecraft state
    target_center_offset: Optional[DeviceTrajectory] = None

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

    def with_msr_type(self, mtype: str, noise: StochasticNoise) -> "GroundStation":
        out = replace(self, measurement_types=tuple(dict.fromkeys(self.measurement_types + (mtype,))))
        out.stochastic_noises = dict(self.stochastic_noises)
        out.stochastic_noises[mtype] = noise
        return out

    def without_msr_type(self, mtype: str) -> "GroundStation":
        out = replace(self, measurement_types=tuple(t for t in self.measurement_types if t != mtype))
        out.stochastic_noises = dict(self.stochastic_noises)
        out.stochastic_noises.pop(mtype, None)
        return out

    def perfect(self) -> "GroundStation":
        """A copy with noiseless measurements."""
        out = replace(self)
        out.stochastic_noises = {t: StochasticNoise.zero() for t in self.measurement_types}
        return out

    def with_target_frame(self, almanac, center: int, start: Epoch, end: Epoch,
                          step_s: float = 300.0) -> "GroundStation":
        """A copy that tracks a trajectory about `center` (a NAIF id, 301
        for a lunar orbiter tracked from the Earth): `center`'s state about
        the station's body every `step_s` over [start - 2 step, end + 2
        step], positions from `almanac.position` and velocities by central
        differences over 2 s, in a Hermite table."""
        t0 = start.to_tdb_seconds() - 2 * step_s
        t1 = end.to_tdb_seconds() + 2 * step_s
        ts = np.arange(t0, t1 + step_s, step_s)
        body = self.frame.center
        rs = almanac.position(center, body, ts)
        h = 2.0
        vs = (almanac.position(center, body, ts + h) - almanac.position(center, body, ts - h)) / (2.0 * h)
        out = replace(self, target_center_offset=DeviceTrajectory(
            ts, np.concatenate([rs, vs], axis=1), int(center)))
        out.stochastic_noises = self.stochastic_noises
        return out

    def _shift_to_station_center(self, t_tdb, rv6):
        """States rv6 [K, 6] about the trajectory's centre moved onto the
        station's body (unchanged without an offset table)."""
        if self.target_center_offset is None:
            return rv6
        return rv6 + self.target_center_offset.state_at(t_tdb)

    # -- geometry ----------------------------------------------------------
    def body_fixed_position(self, *, device="cuda") -> torch.Tensor:
        """The station's body-fixed position [3] (km), a float64 tensor on
        `device`."""
        k = dict(dtype=torch.float64, device=device)
        lat, lon, hgt = (torch.tensor(float(x), **k)
                         for x in (self.latitude_deg, self.longitude_deg, self.height_km))
        return geodetic_to_body_fixed(lat, lon, hgt, self.frame.radius_km, self.frame.flattening)

    def inertial_posvel(self, t_tdb):
        """(position [K, 3], velocity [K, 3]) of the station in the J2000
        frame of its body at TDB epochs t_tdb [K] (a float64 tensor); the
        velocity is d/dt of the body-fixed rotation by forward mode."""
        r_st, v_st, _ = self._geometry(t_tdb)
        return r_st, v_st

    def sez_state(self, t_tdb, rv6):
        """(rho [K, 3], rho_dot [K, 3]): the topocentric South-East-Zenith
        position and velocity of states rv6 [K, 6] (J2000, about the
        trajectory's centre, moved onto the station's body by the offset
        table if there is one)."""
        r_st, v_st, sez = self._geometry(t_tdb)
        rv6 = self._shift_to_station_center(t_tdb, rv6)
        return apply_dcm(sez, rv6[:, 0:3] - r_st), apply_dcm(sez, rv6[:, 3:6] - v_st)

    def measurement_fn(self, types: Optional[Sequence[str]] = None):
        """`h(t_tdb [K], rv6 [K, 6]) -> [K, T]`: `measurement_fn_at` at the
        epochs t_tdb."""
        return lambda t, rv6: self.measurement_fn_at(t, types)(rv6)

    def measurement_fn_at(self, t_tdb, types: Optional[Sequence[str]] = None):
        """`h(rv6 [K, 6]) -> [K, T]`: the one-way computed observation of
        states rv6 [K, 6] (about the trajectory's centre) at the fixed TDB
        epochs t_tdb [K], backdated by the light time where the station
        corrects for it; the station's geometry and the offset table are
        evaluated once, outside whatever transform differentiates h."""
        types = tuple(types or self.measurement_types)
        geo = self._geometry(t_tdb)
        off = None if self.target_center_offset is None else self.target_center_offset.state_at(t_tdb)

        def h(rv6):
            return observe(rv6 if off is None else rv6 + off, *geo, types, lt=self.light_time_correction)

        return h

    def measurement_covar(self, types: Optional[Sequence[str]] = None) -> np.ndarray:
        """The diagonal measurement covariance [T, T] of `types`."""
        types = tuple(types or self.measurement_types)
        return np.diag([self.stochastic_noises[t].covariance() for t in types])

    def _geometry(self, t_tdb):
        k = dict(dtype=torch.float64, device=t_tdb.device)
        lat, lon, hgt = (torch.full(t_tdb.shape, float(x), **k)
                         for x in (self.latitude_deg, self.longitude_deg, self.height_km))
        return station_geometry(t_tdb, lat, lon, hgt, self.frame)

    def azimuth_elevation_range(self, t_tdb, rv6):
        """(azimuth_deg, elevation_deg, range_km, range_rate_km_s), each [K],
        without the light time."""
        out = observe(self._shift_to_station_center(t_tdb, rv6), *self._geometry(t_tdb),
                      (MeasurementType.AZIMUTH_DEG, MeasurementType.ELEVATION_DEG,
                       MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S))
        return out[:, 0], out[:, 1], out[:, 2], out[:, 3]

    def two_way_fn(self, types: Optional[Sequence[str]] = None):
        """`h2(t_tdb [K], rv6_t [K, 6], rv6_tm [K, 6]) -> [K, T]`: the
        two-way observable, the average of the one-way values at the end
        (t) and the start (t - T_int) of the integration interval."""
        h = self.measurement_fn(types)
        t_int = float(self.integration_time_s or 0.0)

        def h2(t, rv6_t, rv6_tm):
            return 0.5 * (h(t - t_int, rv6_tm) + h(t, rv6_t))

        return h2

    def batch_values(self, ts_tdb_s, ys6, types: Optional[Sequence[str]] = None, *,
                     device="cuda"):
        """Noiseless one-way observations (light time as the station says)
        and elevations (without it) over a strand, computed on `device`:
        numpy (values [K, T], elevation_deg [K])."""
        types = tuple(types or self.measurement_types)
        t, y = _on(ts_tdb_s, ys6, device)
        y = self._shift_to_station_center(t, y)
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
        az, el, _, _ = self.azimuth_elevation_range(t, y)
        return az.cpu().numpy(), el.cpu().numpy()

    @property
    def active_terrain_mask(self) -> Optional[TerrainMask]:
        """The terrain mask, or None where there is none or it is ignored."""
        return None if self.terrain_mask_ignored else self.terrain_mask

    def min_elevation_deg(self, az_deg):
        """Minimum visible elevation (deg) at the azimuth(s): the flat
        elevation mask, raised by the active terrain mask."""
        min_el = np.full(np.shape(az_deg), self.elevation_mask_deg)
        if self.active_terrain_mask is not None:
            min_el = np.maximum(min_el, self.active_terrain_mask.min_elevation_at(az_deg))
        return min_el

    def visible(self, az_deg, el_deg):
        """Host-side visibility: the flat elevation mask and, unless
        ignored, the terrain mask."""
        return np.asarray(el_deg) >= self.min_elevation_deg(az_deg)

    def elevation_of(self, t_tdb_s: float, rv6, *, device="cuda") -> float:
        """Elevation (deg) of one state at one TDB epoch, on `device`."""
        t, y = _on([t_tdb_s], np.asarray(rv6, dtype=np.float64)[None], device)
        return float(self.azimuth_elevation_range(t, y)[1][0])

    def measure_instantaneous(self, epoch: Epoch, rv6, rng_np: np.random.Generator,
                              noise_state=None, *, device="cuda"):
        """A simulated noisy measurement dict at `epoch`, or None below the
        elevation mask: the noise of `noise_state` if given, else the
        types' white noise alone."""
        t, y = _on([epoch.to_tdb_seconds()], np.asarray(rv6, dtype=np.float64)[None], device)
        if float(self.azimuth_elevation_range(t, y)[1][0]) < self.elevation_mask_deg:
            return None
        vals = self.measurement_fn()(t, y)[0].cpu().numpy()
        t_tai = epoch.to_tai_seconds()
        out = {}
        for j, mtype in enumerate(self.measurement_types):
            noise = 0.0
            if noise_state is not None:
                noise = noise_state.sample(mtype, t_tai, rng_np)
            elif mtype in self.stochastic_noises:
                sn = self.stochastic_noises[mtype]
                if sn.white_noise is not None:
                    noise = sn.white_noise.sample(rng_np)
            out[mtype] = float(vals[j]) + noise
        return out

    # -- YAML --------------------------------------------------------------
    @classmethod
    def load(cls, path) -> "GroundStation":
        """The first station of a YAML document."""
        from ..io.config import load_ground_stations

        return load_ground_stations(path)[0]

    @classmethod
    def load_many(cls, path):
        from ..io.config import load_ground_stations

        return load_ground_stations(path)

    @classmethod
    def load_named(cls, path) -> Dict[str, "GroundStation"]:
        from ..io.config import load_ground_stations

        return {g.name: g for g in load_ground_stations(path)}

    def save(self, path) -> str:
        from ..io.config import save_ground_stations

        return save_ground_stations([self], path)

