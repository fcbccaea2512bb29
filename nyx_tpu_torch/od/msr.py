"""Measurement types and the tracking-data container.

Host-side numpy copy of nyx_tpu/od/msr.py:20-295: `MeasurementType`,
`Measurement` and `TrackingDataArc` (struct-of-arrays: epochs as float64
TAI seconds past J2000, an integer tracker index, and a dense [M, T] value
matrix with NaN marking absent types), with the arc's range moduli, its set
operations (epoch, offset, tracker and type filters, downsampling, splits at
gaps, the residual-versus-reference mode) and its parquet I/O.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..time import Duration, Epoch


def _secs(x) -> float:
    return x.to_seconds() if isinstance(x, Duration) else float(x)


class MeasurementType:
    """Measurement type tags. Values are km / km/s / deg."""

    RANGE_KM = "range_km"
    DOPPLER_KM_S = "doppler_km_s"
    AZIMUTH_DEG = "azimuth_deg"
    ELEVATION_DEG = "elevation_deg"
    X_KM = "x_km"
    Y_KM = "y_km"
    Z_KM = "z_km"
    #: raw radiometric frequencies (Hz, Hz/s): never simulated or filtered;
    #: the TDM reader turns them into Doppler (`od/tdm.py`)
    RECEIVE_FREQ_HZ = "receive_freq"
    TRANSMIT_FREQ_HZ = "transmit_freq"
    TRANSMIT_FREQ_RATE_HZ_S = "transmit_freq_rate"

    ALL = (RANGE_KM, DOPPLER_KM_S, AZIMUTH_DEG, ELEVATION_DEG, X_KM, Y_KM, Z_KM,
           RECEIVE_FREQ_HZ, TRANSMIT_FREQ_HZ, TRANSMIT_FREQ_RATE_HZ_S)
    ANGLES = (AZIMUTH_DEG, ELEVATION_DEG)
    FREQUENCIES = (RECEIVE_FREQ_HZ, TRANSMIT_FREQ_HZ, TRANSMIT_FREQ_RATE_HZ_S)
    UNITS = {
        RANGE_KM: "km", DOPPLER_KM_S: "km/s", AZIMUTH_DEG: "deg", ELEVATION_DEG: "deg",
        X_KM: "km", Y_KM: "km", Z_KM: "km", RECEIVE_FREQ_HZ: "Hz", TRANSMIT_FREQ_HZ: "Hz",
        TRANSMIT_FREQ_RATE_HZ_S: "Hz/s",
    }


@dataclass
class Measurement:
    """One epoch's observations from one tracker."""

    tracker: str
    epoch: Epoch
    data: Dict[str, float] = field(default_factory=dict)

    def observation(self, types: Sequence[str]) -> np.ndarray:
        """The values of `types` (NaN where absent)."""
        return np.array([self.data.get(t, np.nan) for t in types])

    def availability(self, types: Sequence[str]) -> np.ndarray:
        return np.array([t in self.data for t in types])


@dataclass
class TrackingDataArc:
    """Chronologically sorted measurements.

    epochs_tai_s: [M] float64 TAI s past J2000, non-decreasing
    tracker_idx:  [M] int index into `trackers`
    values:       [M, T] float64, NaN = type absent at that epoch
    types:        T measurement-type tags (column order of `values`)
    moduli:       optional per-type ambiguity modulus (range ambiguity)
    force_reject: residual-versus-reference mode (every row rejected)
    """

    trackers: Tuple[str, ...]
    types: Tuple[str, ...]
    epochs_tai_s: np.ndarray
    tracker_idx: np.ndarray
    values: np.ndarray
    moduli: Optional[Dict[str, float]] = None
    force_reject: bool = False

    @classmethod
    def from_measurements(cls, measurements: List[Measurement], moduli=None) -> "TrackingDataArc":
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
        return cls(trackers, types, epochs, tidx, vals, moduli)

    def __len__(self) -> int:
        return len(self.epochs_tai_s)

    def __iter__(self):
        for i in range(len(self)):
            yield self.measurement(i)

    def measurement(self, i: int) -> Measurement:
        data = {t: float(self.values[i, j]) for j, t in enumerate(self.types)
                if np.isfinite(self.values[i, j])}
        return Measurement(self.trackers[self.tracker_idx[i]],
                           Epoch.from_tai_seconds_j2000(float(self.epochs_tai_s[i])), data)

    @property
    def start_epoch(self) -> Optional[Epoch]:
        return Epoch.from_tai_seconds_j2000(float(self.epochs_tai_s[0])) if len(self) else None

    @property
    def end_epoch(self) -> Optional[Epoch]:
        return Epoch.from_tai_seconds_j2000(float(self.epochs_tai_s[-1])) if len(self) else None

    def unique_types(self) -> Tuple[str, ...]:
        present = ~np.all(np.isnan(self.values), axis=0)
        return tuple(t for t, p in zip(self.types, present) if p)

    def unique_aliases(self) -> Tuple[str, ...]:
        return tuple(self.trackers[i] for i in np.unique(self.tracker_idx))

    # -- set operations ------------------------------------------------
    def _mask(self, keep: np.ndarray) -> "TrackingDataArc":
        return TrackingDataArc(self.trackers, self.types, self.epochs_tai_s[keep],
                               self.tracker_idx[keep], self.values[keep], self.moduli,
                               self.force_reject)

    def resid_vs_ref_check(self) -> "TrackingDataArc":
        """A copy whose processing computes residuals against the pure
        propagation: every measurement is rejected."""
        return replace(self, force_reject=True)

    def filter_by_epoch(self, start: Epoch, end: Epoch) -> "TrackingDataArc":
        s, e = start.to_tai_seconds(), end.to_tai_seconds()
        return self._mask((self.epochs_tai_s >= s) & (self.epochs_tai_s <= e))

    def filter_by_offset(self, start_offset_s=0.0, end_offset_s=None) -> "TrackingDataArc":
        """The measurements within [start, end] offsets (seconds or
        Durations) from the arc's first."""
        t0 = float(self.epochs_tai_s[0]) if len(self) else 0.0
        rel = self.epochs_tai_s - t0
        keep = rel >= _secs(start_offset_s)
        if end_offset_s is not None:
            keep &= rel <= _secs(end_offset_s)
        return self._mask(keep)

    def exclude_by_epoch(self, start: Epoch, end: Epoch) -> "TrackingDataArc":
        s, e = start.to_tai_seconds(), end.to_tai_seconds()
        return self._mask((self.epochs_tai_s < s) | (self.epochs_tai_s > e))

    def _tracker_ids(self, aliases: Sequence[str]):
        aliases = set(aliases)
        return [i for i, t in enumerate(self.trackers) if t in aliases]

    def filter_by_tracker(self, aliases: Sequence[str]) -> "TrackingDataArc":
        return self._mask(np.isin(self.tracker_idx, self._tracker_ids(aliases)))

    def reject_by_tracker(self, aliases: Sequence[str]) -> "TrackingDataArc":
        return self._mask(~np.isin(self.tracker_idx, self._tracker_ids(aliases)))

    def filter_by_type(self, types: Sequence[str]) -> "TrackingDataArc":
        """Only the columns of `types`; rows left with none go. The copy is
        not in residual-versus-reference mode, as the reference's."""
        cols = [j for j, t in enumerate(self.types) if t in set(types)]
        vals = np.full_like(self.values, np.nan)
        vals[:, cols] = self.values[:, cols]
        keep = ~np.all(np.isnan(vals), axis=1)
        return TrackingDataArc(self.trackers, self.types, self.epochs_tai_s[keep],
                               self.tracker_idx[keep], vals[keep], self.moduli)

    def downsample(self, step) -> "TrackingDataArc":
        """At most one measurement per tracker per `step` interval."""
        step_s = _secs(step)
        keep = np.zeros(len(self), dtype=bool)
        last: Dict[int, float] = {}
        for i in range(len(self)):
            trk, t = int(self.tracker_idx[i]), float(self.epochs_tai_s[i])
            if trk not in last or t - last[trk] >= step_s - 1e-9:
                keep[i] = True
                last[trk] = t
        return self._mask(keep)

    def split_by_gap(self, min_gap) -> List["TrackingDataArc"]:
        """The arc cut wherever consecutive epochs are more than `min_gap`
        apart."""
        if len(self) == 0:
            return [self]
        cuts = np.where(np.diff(self.epochs_tai_s) > _secs(min_gap))[0] + 1
        out = []
        for chunk in np.split(np.arange(len(self)), cuts):
            keep = np.zeros(len(self), dtype=bool)
            keep[chunk] = True
            out.append(self._mask(keep))
        return out

    # -- parquet I/O ---------------------------------------------------
    def to_parquet(self, path) -> str:
        """One row a measurement: `epoch_tai_s`, `tracker` and a column a
        type (NaN where absent); the moduli, if any, in the metadata."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols = {"epoch_tai_s": self.epochs_tai_s,
                "tracker": [self.trackers[i] for i in self.tracker_idx]}
        for j, t in enumerate(self.types):
            cols[t] = self.values[:, j]
        meta = {b"generator": b"nyx_tpu_torch"}
        if self.moduli:
            meta[b"moduli"] = json.dumps(self.moduli).encode()
        pq.write_table(pa.table(cols).replace_schema_metadata(meta), str(path),
                       compression="zstd")
        return str(path)

    @classmethod
    def from_parquet(cls, path) -> "TrackingDataArc":
        import pyarrow.parquet as pq

        table = pq.read_table(str(path))
        epochs = np.asarray(table["epoch_tai_s"], dtype=np.float64)
        names = [str(x) for x in table["tracker"].to_pylist()]
        trackers = tuple(dict.fromkeys(names))
        tmap = {t: i for i, t in enumerate(trackers)}
        tidx = np.array([tmap[t] for t in names], dtype=np.int64)
        types = tuple(n for n in table.column_names if n not in ("epoch_tai_s", "tracker"))
        vals = np.stack([np.asarray(table[t], dtype=np.float64) for t in types], axis=-1)
        meta = table.schema.metadata or {}
        moduli = json.loads(meta[b"moduli"].decode()) if b"moduli" in meta else None
        order = np.argsort(epochs, kind="stable")
        return cls(trackers, types, epochs[order], tidx[order], vals[order], moduli)

    def __str__(self):
        return (f"TrackingDataArc: {len(self)} measurements from {len(self.trackers)} "
                f"trackers over [{self.start_epoch}, {self.end_epoch}]")
