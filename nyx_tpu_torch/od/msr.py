"""Measurement types and the tracking-data container.

Host-side numpy copy of the core of nyx_tpu/od/msr.py: `MeasurementType`,
`Measurement` and `TrackingDataArc` (struct-of-arrays: epochs as float64
TAI seconds past J2000, an integer tracker index, and a dense [M, T] value
matrix with NaN marking absent types). Range moduli, the arc filters and
parquet export are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..time import Epoch


class MeasurementType:
    """Measurement type tags. Values are km / km/s / deg."""

    RANGE_KM = "range_km"
    DOPPLER_KM_S = "doppler_km_s"
    AZIMUTH_DEG = "azimuth_deg"
    ELEVATION_DEG = "elevation_deg"
    X_KM = "x_km"
    Y_KM = "y_km"
    Z_KM = "z_km"


@dataclass
class Measurement:
    """One epoch's observations from one tracker."""

    tracker: str
    epoch: Epoch
    data: Dict[str, float] = field(default_factory=dict)


@dataclass
class TrackingDataArc:
    """Chronologically sorted measurements.

    epochs_tai_s: [M] float64 TAI s past J2000, non-decreasing
    tracker_idx:  [M] int index into `trackers`
    values:       [M, T] float64, NaN = type absent at that epoch
    types:        T measurement-type tags (column order of `values`)
    force_reject: residual-versus-reference mode (every row rejected)
    """

    trackers: Tuple[str, ...]
    types: Tuple[str, ...]
    epochs_tai_s: np.ndarray
    tracker_idx: np.ndarray
    values: np.ndarray
    force_reject: bool = False

    @classmethod
    def from_measurements(cls, measurements: List[Measurement]) -> "TrackingDataArc":
        measurements = sorted(measurements, key=lambda m: m.epoch.to_tai_seconds())
        trackers = tuple(dict.fromkeys(m.tracker for m in measurements))
        types = tuple(dict.fromkeys(t for m in measurements for t in m.data.keys()))
        tmap = {t: i for i, t in enumerate(trackers)}
        M, T = len(measurements), len(types)
        epochs = np.array([m.epoch.to_tai_seconds() for m in measurements])
        tidx = np.array([tmap[m.tracker] for m in measurements], dtype=np.int64)
        vals = np.full((M, T), np.nan)
        for i, m in enumerate(measurements):
            for j, t in enumerate(types):
                if t in m.data:
                    vals[i, j] = m.data[t]
        return cls(trackers, types, epochs, tidx, vals)

    def __len__(self) -> int:
        return len(self.epochs_tai_s)
