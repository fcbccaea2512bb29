"""GNSS position pseudo-measurements.

Port of nyx_tpu/od/position.py:22-77 (the reference's od/position/): a
navigation solution observes the spacecraft's X, Y and Z position
directly, always visible. The device runs through the OD host loop
(`KalmanODProcess`) and the tracking simulator; `ScanKalmanOD` does not
take it, as the reference's does not. Observables are batched over
epochs: t_tdb [K], states rv6 [K, 6].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..xmath import norm
from .interlink import _on
from .msr import MeasurementType
from .noise import StochasticNoise, WhiteNoise

_COLUMN = {MeasurementType.X_KM: 0, MeasurementType.Y_KM: 1, MeasurementType.Z_KM: 2}


@dataclass
class PositionDevice:
    """An always-visible X/Y/Z position device."""

    name: str = "gnss"
    sigma_km: float = 1e-3  # 1 m per axis
    measurement_types: Tuple[str, ...] = (
        MeasurementType.X_KM,
        MeasurementType.Y_KM,
        MeasurementType.Z_KM,
    )
    integration_time_s: Optional[float] = None
    elevation_mask_deg: float = -90.0  # never gated
    stochastic_noises: Dict[str, StochasticNoise] = field(default_factory=dict)
    frame: object = None
    # no terrain: see GroundStation.active_terrain_mask
    active_terrain_mask = None

    def __post_init__(self):
        if not self.stochastic_noises:
            self.stochastic_noises = {t: StochasticNoise(WhiteNoise(self.sigma_km))
                                      for t in self.measurement_types}

    def azimuth_elevation_range(self, t_tdb, rv6):
        """(azimuth_deg, elevation_deg, range_km, range_rate_km_s), each [K],
        as a ground station's: always visible at 90 deg, the range the
        distance from the frame's origin, no range rate."""
        zero = torch.zeros_like(t_tdb)
        return zero, torch.full_like(t_tdb, 90.0), norm(rv6[:, 0:3]), zero

    def measurement_fn(self, types=None):
        """`h(t_tdb [K], rv6 [K, 6]) -> [K, T]`: `measurement_fn_at` at the
        epochs t_tdb."""
        return lambda t, rv6: self.measurement_fn_at(t, types)(rv6)

    def measurement_fn_at(self, t_tdb, types=None):
        """`h(rv6 [K, 6]) -> [K, T]`: the position components (they need no
        epoch)."""
        cols = [_COLUMN[t] for t in tuple(types or self.measurement_types)]
        return lambda rv6: rv6[:, cols]

    def batch_values(self, ts_tdb_s, ys6, types=None, *, device="cuda"):
        """Noiseless positions and a constant 90 deg elevation over a
        strand, as numpy (values [K, T], elevation_deg [K])."""
        t, y = _on(ts_tdb_s, ys6, device)
        return self.measurement_fn(types)(t, y).cpu().numpy(), np.full(t.shape[0], 90.0)

    def batch_azel(self, ts_tdb_s, ys6, *, device="cuda"):
        """(zeros [K], 90 deg [K]): always visible."""
        k = len(np.asarray(ts_tdb_s))
        return np.zeros(k), np.full(k, 90.0)

    def min_elevation_deg(self, az_deg):
        return np.full(np.shape(az_deg), self.elevation_mask_deg)

    def measurement_covar(self, types=None) -> np.ndarray:
        types = tuple(types or self.measurement_types)
        return np.diag([self.stochastic_noises[t].covariance() for t in types])
