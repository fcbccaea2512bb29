"""CCSDS Tracking Data Messages (TDM, KVN) read and written.

Port of nyx_tpu/od/tdm.py:37-272 (the reference's io_ccsds_tdm.rs): one
META/DATA segment per tracker, PARTICIPANT_1 the tracker; a two-way PATH
(1,2,1) halves range and Doppler on read and doubles them on write; range
units must be km. Frequency observables (RECEIVE_FREQ, TRANSMIT_FREQ,
TRANSMIT_FREQ_RATE) are read alone and turned into integrated-Doppler
range rate through the turnaround ratio; CORRECTION_<keyword> metadata is
added to its observable. `TrackingDataArc.to_tdm` and `from_tdm` are
attached here, as the reference attaches them. Host-only.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional

import numpy as np

from ..time import Epoch
from .msr import Measurement, MeasurementType, TrackingDataArc
from ..errors import InputOutputError

#: CCSDS TDM keyword <-> MeasurementType (types.rs ccsds_tdm_name)
TDM_NAMES = {
    MeasurementType.RANGE_KM: "RANGE",
    MeasurementType.DOPPLER_KM_S: "DOPPLER_INTEGRATED",
    MeasurementType.AZIMUTH_DEG: "ANGLE_1",
    MeasurementType.ELEVATION_DEG: "ANGLE_2",
    MeasurementType.RECEIVE_FREQ_HZ: "RECEIVE_FREQ",
    MeasurementType.TRANSMIT_FREQ_HZ: "TRANSMIT_FREQ",
    MeasurementType.TRANSMIT_FREQ_RATE_HZ_S: "TRANSMIT_FREQ_RATE",
}
TDM_TYPES = {v: k for k, v in TDM_NAMES.items()}


def write_tdm(arc: TrackingDataArc, path, spacecraft_name: str = "SPACECRAFT",
              two_way: bool = False) -> str:
    """Write the arc as a KVN TDM, one segment per tracker."""
    lines: List[str] = []
    lines.append("CCSDS_TDM_VERS = 2.0")
    lines.append(f"CREATION_DATE = {datetime.datetime.now(datetime.UTC).strftime('%Y-%m-%dT%H:%M:%S')}")
    lines.append("ORIGINATOR = nyx_tpu_torch")
    scale = 2.0 if two_way else 1.0

    for trk_i, tracker in enumerate(arc.trackers):
        mask = arc.tracker_idx == trk_i
        if not np.any(mask):
            continue
        lines.append("")
        lines.append("META_START")
        lines.append("\tTIME_SYSTEM = UTC")
        lines.append(f"\tPARTICIPANT_1 = {tracker}")
        lines.append(f"\tPARTICIPANT_2 = {spacecraft_name}")
        lines.append("\tMODE = SEQUENTIAL")
        lines.append("\tPATH = 1,2,1" if two_way else "\tPATH = 1,2")
        lines.append("\tRANGE_UNITS = km")
        lines.append("\tANGLE_TYPE = AZEL")
        lines.append("META_STOP")
        lines.append("")
        lines.append("DATA_START")
        for i in np.where(mask)[0]:
            epoch = Epoch.from_tai_seconds_j2000(float(arc.epochs_tai_s[i]))
            iso = epoch.isoformat("UTC").split(" ")[0]  # bare ISO, no scale tag
            for j, t in enumerate(arc.types):
                v = arc.values[i, j]
                if np.isfinite(v) and t in TDM_NAMES:
                    sc = scale if t in (MeasurementType.RANGE_KM,
                                        MeasurementType.DOPPLER_KM_S) else 1.0
                    lines.append(f"\t{TDM_NAMES[t]} = {iso} {v * sc:.12e}")
        lines.append("DATA_STOP")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def read_tdm(path, aliases: Optional[Dict[str, str]] = None) -> TrackingDataArc:
    """Parse a KVN TDM into a TrackingDataArc (io_ccsds_tdm.rs:86-418).

    RECEIVE_FREQ/TRANSMIT_FREQ(+RATE) observables are converted to
    integrated-Doppler range-rate using the TURNAROUND_NUMERATOR /
    TURNAROUND_DENOMINATOR metadata (CCSDS TDM v2 section 3.5.2.8.2,
    io_ccsds_tdm.rs:261-370): with M2 the turnaround ratio and f_T the
    rate-extrapolated transmit frequency,
    ``rho_dot = (f_T * M2 - f_R) * c / (2 * f_T * M2)``. Frequency data
    without a turnaround ratio is dropped with a warning.
    CORRECTION_<keyword> metadata values are added to each observable
    (io_ccsds_tdm.rs:276-296).
    """
    import warnings

    measurements: List[Measurement] = []
    in_data = False
    tracker = ""
    time_system = "UTC"
    divider = 1.0
    metadata: Dict[str, str] = {}
    range_modulus = None

    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("COMMENT"):
                continue
            if line == "DATA_START":
                in_data = True
                continue
            if line == "DATA_STOP":
                in_data = False
                continue

            if not in_data:
                if "=" in line:
                    k, v = (s.strip() for s in line.split("=", 1))
                    metadata[k] = v
                if line.startswith("PARTICIPANT_1"):
                    tracker = line.split("=", 1)[1].strip()
                    if aliases and tracker in aliases:
                        tracker = aliases[tracker]
                elif line.startswith("TIME_SYSTEM"):
                    time_system = line.split("=", 1)[1].strip().upper()
                    if time_system not in ("UTC", "TAI", "TDB", "TT"):
                        raise InputOutputError(
                            f"TDM time scale {time_system} not supported"
                        )
                elif line.startswith("PATH"):
                    n_path = line.split("=", 1)[1].count(",") + 1
                    if n_path == 2:
                        divider = 1.0
                    elif n_path == 3:
                        divider = 2.0  # two-way: stored value is round-trip
                    else:
                        raise InputOutputError(f"{n_path} TDM paths unsupported")
                elif line.startswith("RANGE_UNITS"):
                    units = line.split("=", 1)[1].strip().lower()
                    if units != "km":
                        raise InputOutputError(f"RANGE_UNITS {units} not supported (km only)")
                continue

            # data line: KEYWORD = EPOCH VALUE
            if "=" not in line:
                continue
            keyword, rest = (s.strip() for s in line.split("=", 1))
            if keyword not in TDM_TYPES:
                continue
            parts = rest.split()
            if len(parts) == 3 and parts[1] in ("UTC", "TAI", "TDB", "TT"):
                parts = [parts[0], parts[2]]  # tolerate a scale tag
            if len(parts) != 2:
                continue
            iso, value = parts
            epoch = _parse_epoch(iso, time_system)
            mtype = TDM_TYPES[keyword]
            v = float(value)
            if mtype in (MeasurementType.RANGE_KM, MeasurementType.DOPPLER_KM_S):
                v /= divider
            if (
                measurements
                and measurements[-1].tracker == tracker
                and abs(
                    measurements[-1].epoch.to_tai_seconds() - epoch.to_tai_seconds()
                )
                < 1e-7
            ):
                measurements[-1].data[mtype] = v
            else:
                measurements.append(Measurement(tracker, epoch, {mtype: v}))

    # CORRECTION_<name> metadata: additive corrections per observable
    for mtype, kw in TDM_NAMES.items():
        corr = metadata.get(f"CORRECTION_{kw}")
        if corr is not None:
            try:
                c = float(corr)
            except ValueError:
                warnings.warn(f"invalid correction value for CORRECTION_{kw}")
                continue
            for m in measurements:
                if mtype in m.data:
                    m.data[mtype] += c

    # Frequency observables -> integrated Doppler via the turnaround ratio
    has_freq = any(
        t in m.data for m in measurements for t in MeasurementType.FREQUENCIES
    )
    if has_freq:
        turnaround = None
        num = metadata.get("TURNAROUND_NUMERATOR")
        den = metadata.get("TURNAROUND_DENOMINATOR")
        if num is not None and den is not None:
            try:
                turnaround = float(int(num)) / float(int(den))
            except ValueError:
                turnaround = None
        if turnaround is None:
            warnings.warn(
                "TDM contains frequency data but no valid TURNAROUND_"
                "NUMERATOR/DENOMINATOR metadata; dropping frequency data"
            )
            for m in measurements:
                for t in MeasurementType.FREQUENCIES:
                    m.data.pop(t, None)
        else:
            from ..constants import SPEED_OF_LIGHT_KM_S

            last_f = None
            last_epoch = None
            last_rate = 0.0
            for m in measurements:
                rate = m.data.get(MeasurementType.TRANSMIT_FREQ_RATE_HZ_S)
                if rate is not None:
                    if last_f is not None and last_epoch is not None:
                        dt = m.epoch.to_tai_seconds() - last_epoch.to_tai_seconds()
                        last_f = last_f + last_rate * dt
                    last_epoch = m.epoch
                    last_rate = rate
                f_t = m.data.get(MeasurementType.TRANSMIT_FREQ_HZ)
                if f_t is not None:
                    last_f = f_t
                    last_epoch = m.epoch
                f_r = m.data.get(MeasurementType.RECEIVE_FREQ_HZ)
                if f_r is None:
                    for t in MeasurementType.FREQUENCIES:
                        m.data.pop(t, None)
                    continue
                if last_f is None:
                    warnings.warn(
                        f"receive frequency at {m.epoch} before any transmit "
                        "frequency; ignoring"
                    )
                    for t in MeasurementType.FREQUENCIES:
                        m.data.pop(t, None)
                    continue
                dt = m.epoch.to_tai_seconds() - last_epoch.to_tai_seconds()
                f_t_now = last_f + last_rate * dt
                # CCSDS TDM v2 3.5.2.8.2 two-way Doppler shift
                shift_hz = f_t_now * turnaround - f_r
                rho_dot = shift_hz * SPEED_OF_LIGHT_KM_S / (2.0 * f_t_now * turnaround)
                for t in MeasurementType.FREQUENCIES:
                    m.data.pop(t, None)
                m.data[MeasurementType.DOPPLER_KM_S] = rho_dot
        measurements = [m for m in measurements if m.data]

    moduli = None
    if metadata.get("RANGE_MODULUS"):
        try:
            rm = float(metadata["RANGE_MODULUS"])
            if rm > 0.0:
                moduli = {MeasurementType.RANGE_KM: rm}
        except ValueError:
            pass
    return TrackingDataArc.from_measurements(measurements, moduli=moduli)


def _parse_epoch(iso: str, scale: str) -> Epoch:
    date, _, time = iso.partition("T")
    y, mo, d = (int(x) for x in date.split("-"))
    hh, mm, ss = time.split(":")
    return Epoch.from_gregorian(y, mo, d, int(hh), int(mm), float(ss), scale)


# attach as TrackingDataArc methods for reference API parity
def _to_tdm(self, path, spacecraft_name="SPACECRAFT", two_way=False):
    return write_tdm(self, path, spacecraft_name, two_way)


def _from_tdm(cls, path, aliases=None):
    return read_tdm(path, aliases)


TrackingDataArc.to_tdm = _to_tdm
TrackingDataArc.from_tdm = classmethod(_from_tdm)
