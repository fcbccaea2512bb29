"""Epochs and durations (port of the core of nyx_tpu/time.py).

The host-side `Epoch` keeps two-part precision (integer TAI seconds past
J2000 + fractional seconds); device code works with plain float64 seconds
past J2000 in one scale (TAI or TDB). Scales: TAI (canonical), TT, TDB, UTC,
GPS. The host code is copied from the reference, ISO strings (`isoformat`,
`from_str`) and Gregorian output included, with Julian dates, GPS seconds,
hifitime's `Unit` and `Duration`'s arithmetic; only the tensor branch of
`tdb_minus_tt` uses torch.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch

from .errors import ConfigError

SECONDS_PER_DAY = 86_400.0
TT_MINUS_TAI = 32.184
GPS_MINUS_TAI = -19.0

# Julian date of the J2000 epoch (2000-01-01T12:00:00 TT == JD 2451545.0 TT).
# The TAI variant is anchored: t = 0 is 2000-01-01T12:00:00 TAI.
JD_J2000 = 2_451_545.0
MJD_OFFSET = 2_400_000.5

# Leap seconds: the IERS table as (year, month, day, TAI-UTC seconds).
_LEAP_TABLE = [
    (1972, 1, 1, 10), (1972, 7, 1, 11), (1973, 1, 1, 12), (1974, 1, 1, 13),
    (1975, 1, 1, 14), (1976, 1, 1, 15), (1977, 1, 1, 16), (1978, 1, 1, 17),
    (1979, 1, 1, 18), (1980, 1, 1, 19), (1981, 7, 1, 20), (1982, 7, 1, 21),
    (1983, 7, 1, 22), (1985, 7, 1, 23), (1988, 1, 1, 24), (1990, 1, 1, 25),
    (1991, 1, 1, 26), (1992, 7, 1, 27), (1993, 7, 1, 28), (1994, 7, 1, 29),
    (1996, 1, 1, 30), (1997, 7, 1, 31), (1999, 1, 1, 32), (2006, 1, 1, 33),
    (2009, 1, 1, 34), (2012, 7, 1, 35), (2015, 7, 1, 36), (2017, 1, 1, 37),
]


def _days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 (proleptic Gregorian), Howard Hinnant's algorithm."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _civil_from_days(z: int):
    """Inverse of _days_from_civil."""
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


# Seconds from Unix epoch (1970-01-01T00:00) to J2000 (2000-01-01T12:00), same scale.
_J2000_MINUS_UNIX_S = _days_from_civil(2000, 1, 1) * SECONDS_PER_DAY + 43_200.0

# Leap table in "seconds past J2000 UTC-as-if-TAI" for lookup.
_LEAP_S = [
    (_days_from_civil(y, m, d) * SECONDS_PER_DAY - _J2000_MINUS_UNIX_S, float(dt))
    for (y, m, d, dt) in _LEAP_TABLE
]


def tai_minus_utc(utc_s_past_j2000: float) -> float:
    """TAI-UTC offset (leap seconds) at a UTC instant given in s past J2000."""
    off = 0.0
    for thresh, dt in _LEAP_S:
        if utc_s_past_j2000 >= thresh:
            off = dt
        else:
            break
    return off


def tdb_minus_tt(tt_s_past_j2000):
    """TDB - TT in seconds, standard USNO sinusoidal approximation (~us
    accurate). Works on floats and torch tensors."""
    days = tt_s_past_j2000 / SECONDS_PER_DAY
    g = 6.239996 + 0.0172019699 * days  # mean anomaly of Earth orbit, rad
    if isinstance(tt_s_past_j2000, (float, int)):
        return 0.001657 * math.sin(g + 0.01671 * math.sin(g))
    return 0.001657 * torch.sin(g + 0.01671 * torch.sin(g))


class Unit:
    """Duration constructors mirroring hifitime's `Unit` (seconds-based)."""

    Nanosecond = 1e-9
    Microsecond = 1e-6
    Millisecond = 1e-3
    Second = 1.0
    Minute = 60.0
    Hour = 3600.0
    Day = SECONDS_PER_DAY
    Week = 7 * SECONDS_PER_DAY


@dataclass(frozen=True, order=True)
class Duration:
    """A span of time, stored as float64 seconds."""

    seconds: float

    @classmethod
    def from_seconds(cls, s: float) -> "Duration":
        return cls(float(s))

    @classmethod
    def from_minutes(cls, m: float) -> "Duration":
        return cls(m * 60.0)

    @classmethod
    def from_hours(cls, h: float) -> "Duration":
        return cls(h * 3600.0)

    @classmethod
    def from_days(cls, d: float) -> "Duration":
        return cls(d * SECONDS_PER_DAY)

    def to_seconds(self) -> float:
        return self.seconds

    def to_unit(self, unit: float) -> float:
        """This span in `unit` (a `Unit` constant)."""
        return self.seconds / unit

    @property
    def days(self) -> float:
        return self.seconds / SECONDS_PER_DAY

    def is_negative(self) -> bool:
        return self.seconds < 0

    def __add__(self, other):
        if isinstance(other, Duration):
            return Duration(self.seconds + other.seconds)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Duration):
            return Duration(self.seconds - other.seconds)
        return NotImplemented

    def __neg__(self):
        return Duration(-self.seconds)

    def __mul__(self, k):
        return Duration(self.seconds * k)

    __rmul__ = __mul__

    def __truediv__(self, k):
        if isinstance(k, Duration):
            return self.seconds / k.seconds
        return Duration(self.seconds / k)

    def __abs__(self):
        return Duration(abs(self.seconds))

    def __str__(self):
        s = abs(self.seconds)
        sign = "-" if self.seconds < 0 else ""
        if s >= SECONDS_PER_DAY:
            return f"{sign}{s / SECONDS_PER_DAY:.6f} days"
        if s >= 3600:
            return f"{sign}{s / 3600:.6f} h"
        if s >= 60:
            return f"{sign}{s / 60:.6f} min"
        return f"{sign}{s:.9f} s"


@dataclass(frozen=True, order=True)
class Epoch:
    """An instant, stored as two-part TAI seconds past J2000 (int + fraction)."""

    tai_int: int
    tai_frac: float  # in [0, 1)

    @staticmethod
    def _make(total_s: float) -> "Epoch":
        i = math.floor(total_s)
        return Epoch(int(i), total_s - i)

    @staticmethod
    def _make2(i: int, f: float) -> "Epoch":
        di = math.floor(f)
        return Epoch(i + int(di), f - di)

    @classmethod
    def from_tai_seconds_j2000(cls, s: float) -> "Epoch":
        return cls._make(s)

    @classmethod
    def from_tt_seconds_j2000(cls, s: float) -> "Epoch":
        return cls._make(s - TT_MINUS_TAI)

    @classmethod
    def from_tdb_seconds_j2000(cls, s: float) -> "Epoch":
        # invert TDB->TT by one fixed-point iteration (offset varies slowly)
        tt = s - tdb_minus_tt(s)
        tt = s - tdb_minus_tt(tt)
        return cls.from_tt_seconds_j2000(tt)

    @classmethod
    def from_gps_seconds_j2000(cls, s: float) -> "Epoch":
        return cls._make(s - GPS_MINUS_TAI)

    @classmethod
    def from_utc_seconds_j2000(cls, s: float) -> "Epoch":
        return cls._make(s + tai_minus_utc(s))

    @classmethod
    def from_jde_tai(cls, jd: float) -> "Epoch":
        return cls._make((jd - JD_J2000) * SECONDS_PER_DAY)

    @classmethod
    def from_mjd_tai(cls, mjd: float) -> "Epoch":
        return cls._make((mjd + MJD_OFFSET - JD_J2000) * SECONDS_PER_DAY)

    @classmethod
    def from_jde_tdb(cls, jd: float) -> "Epoch":
        return cls.from_tdb_seconds_j2000((jd - JD_J2000) * SECONDS_PER_DAY)

    @classmethod
    def from_jde_utc(cls, jd: float) -> "Epoch":
        return cls.from_utc_seconds_j2000((jd - JD_J2000) * SECONDS_PER_DAY)

    @classmethod
    def from_gregorian(cls, y, mo, d, h=0, mi=0, s=0.0, scale="UTC") -> "Epoch":
        days = _days_from_civil(y, mo, d)
        sec = days * SECONDS_PER_DAY - _J2000_MINUS_UNIX_S + h * 3600 + mi * 60 + s
        scale = scale.upper()
        if scale == "UTC":
            return cls.from_utc_seconds_j2000(sec)
        if scale == "TAI":
            return cls._make(sec)
        if scale == "TT":
            return cls.from_tt_seconds_j2000(sec)
        if scale == "TDB":
            return cls.from_tdb_seconds_j2000(sec)
        if scale == "GPS":
            return cls._make(sec - GPS_MINUS_TAI)
        raise ConfigError(f"unknown time scale {scale}")

    @classmethod
    def from_gregorian_utc(cls, y, mo, d, h=0, mi=0, s=0.0) -> "Epoch":
        return cls.from_gregorian(y, mo, d, h, mi, s, "UTC")

    @classmethod
    def from_gregorian_tai(cls, y, mo, d, h=0, mi=0, s=0.0) -> "Epoch":
        return cls.from_gregorian(y, mo, d, h, mi, s, "TAI")

    _ISO_RE = re.compile(
        r"^(\d{4})-(\d{2})-(\d{2})[T ](\d{2}):(\d{2}):(\d{2}(?:\.\d+)?)"
        r"\s*(UTC|TAI|TT|TDB|GPS|Z)?$"
    )

    @classmethod
    def from_str(cls, s: str) -> "Epoch":
        """An epoch from an ISO string, `YYYY-MM-DDTHH:MM:SS[.f] [scale]`
        (UTC when the scale is left out or `Z`)."""
        m = cls._ISO_RE.match(s.strip())
        if not m:
            raise ConfigError(f"cannot parse epoch {s!r}")
        y, mo, d, h, mi = (int(m.group(i)) for i in range(1, 6))
        sec = float(m.group(6))
        scale = m.group(7) or "UTC"
        if scale == "Z":
            scale = "UTC"
        return cls.from_gregorian(y, mo, d, h, mi, sec, scale)

    def to_tai_seconds(self) -> float:
        """Seconds past J2000 in TAI (collapsed to a single f64)."""
        return self.tai_int + self.tai_frac

    def to_tt_seconds(self) -> float:
        return self.to_tai_seconds() + TT_MINUS_TAI

    def to_tdb_seconds(self) -> float:
        tt = self.to_tt_seconds()
        return tt + tdb_minus_tt(tt)

    def to_gps_seconds(self) -> float:
        return self.to_tai_seconds() + GPS_MINUS_TAI

    def to_utc_seconds(self) -> float:
        tai = self.to_tai_seconds()
        # the leap offset at the UTC instant, by fixed point
        off = tai_minus_utc(tai)
        off = tai_minus_utc(tai - off)
        return tai - off

    def to_jde_tai(self) -> float:
        return JD_J2000 + self.to_tai_seconds() / SECONDS_PER_DAY

    def to_mjd_tai(self) -> float:
        return self.to_jde_tai() - MJD_OFFSET

    def to_jde_tt(self) -> float:
        return JD_J2000 + self.to_tt_seconds() / SECONDS_PER_DAY

    def to_jde_tdb(self) -> float:
        return JD_J2000 + self.to_tdb_seconds() / SECONDS_PER_DAY

    def to_jde_utc(self) -> float:
        return JD_J2000 + self.to_utc_seconds() / SECONDS_PER_DAY

    def to_gregorian(self, scale="UTC"):
        """(year, month, day, hour, minute, seconds) in `scale`."""
        scale = scale.upper()
        if scale == "UTC":
            sec = self.to_utc_seconds()
        elif scale == "TAI":
            sec = self.to_tai_seconds()
        elif scale == "TT":
            sec = self.to_tt_seconds()
        elif scale == "TDB":
            sec = self.to_tdb_seconds()
        elif scale == "GPS":
            sec = self.to_gps_seconds()
        else:
            raise ConfigError(f"unknown time scale {scale}")
        unix_s = sec + _J2000_MINUS_UNIX_S
        days = math.floor(unix_s / SECONDS_PER_DAY)
        sod = unix_s - days * SECONDS_PER_DAY
        y, mo, d = _civil_from_days(int(days))
        h = int(sod // 3600)
        mi = int((sod - h * 3600) // 60)
        s = sod - h * 3600 - mi * 60
        return y, mo, d, h, mi, s

    def isoformat(self, scale="UTC") -> str:
        y, mo, d, h, mi, s = self.to_gregorian(scale)
        return f"{y:04d}-{mo:02d}-{d:02d}T{h:02d}:{mi:02d}:{s:09.6f} {scale}"

    def __add__(self, other):
        if isinstance(other, Duration):
            return Epoch._make2(self.tai_int, self.tai_frac + other.seconds)
        if isinstance(other, (int, float)):  # seconds
            return Epoch._make2(self.tai_int, self.tai_frac + other)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Epoch):
            return Duration((self.tai_int - other.tai_int) + (self.tai_frac - other.tai_frac))
        if isinstance(other, Duration):
            return Epoch._make2(self.tai_int, self.tai_frac - other.seconds)
        if isinstance(other, (int, float)):
            return Epoch._make2(self.tai_int, self.tai_frac - other)
        return NotImplemented

    def __str__(self):
        return self.isoformat("UTC")


J2000_TAI = Epoch(0, 0.0)
