"""ASN.1 DER encoding of core types (X.690).

The port's own copy of nyx_tpu/io/der.py (pure Python), on the port's
`Spacecraft`, `Thruster`, `Orbit`, `Frame` and `Epoch`, raising the port's
`InputOutputError`.

Counterpart of the reference's `der` (RustCrypto) derive impls:
`Spacecraft`/`Thruster` Encode/Decode (cosmic/spacecraft.rs:700-786),
`MeasurementType` as `der::Enumerated` (od/msr/types.rs:34-57). The
reference uses DER as an ops interchange format for states; this module
implements the subset of X.690 needed for that — SEQUENCE, INTEGER,
BOOLEAN, ENUMERATED, UTF8String and canonical base-2 REAL (§8.5, DER
canonical form: mantissa zero or odd, scaling factor 0) — in pure Python,
plus `spacecraft_to_der`/`spacecraft_from_der` round-trips.
"""

from __future__ import annotations

import math
from typing import Tuple

from ..errors import InputOutputError
from ..od.msr import MeasurementType

# tags
TAG_BOOLEAN = 0x01
TAG_INTEGER = 0x02
TAG_REAL = 0x09
TAG_ENUMERATED = 0x0A
TAG_UTF8STRING = 0x0C
TAG_SEQUENCE = 0x30

#: MeasurementType -> ASN.1 ENUMERATED discriminant (types.rs:36-57 repr).
#: Keyed by the port's MeasurementType tags: the reference's table names
#: the position types "x", "y", "z", which are not its own tags ("x_km").
MEASUREMENT_TYPE_ENUM = {
    MeasurementType.RANGE_KM: 0,
    MeasurementType.DOPPLER_KM_S: 1,
    MeasurementType.AZIMUTH_DEG: 2,
    MeasurementType.ELEVATION_DEG: 3,
    MeasurementType.RECEIVE_FREQ_HZ: 4,
    MeasurementType.TRANSMIT_FREQ_HZ: 5,
    MeasurementType.X_KM: 6,
    MeasurementType.Y_KM: 7,
    MeasurementType.Z_KM: 8,
    MeasurementType.TRANSMIT_FREQ_RATE_HZ_S: 9,
}
MEASUREMENT_TYPE_FROM_ENUM = {v: k for k, v in MEASUREMENT_TYPE_ENUM.items()}


# ---------------------------------------------------------------------------
# primitive encoders
# ---------------------------------------------------------------------------
def _len_octets(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + _len_octets(len(content)) + content


def encode_bool(v: bool) -> bytes:
    return _tlv(TAG_BOOLEAN, b"\xff" if v else b"\x00")


def _int_content(v: int) -> bytes:
    n = max(1, (v.bit_length() + 8) // 8)
    return v.to_bytes(n, "big", signed=True)


def encode_integer(v: int) -> bytes:
    return _tlv(TAG_INTEGER, _int_content(int(v)))


def encode_enumerated(v: int) -> bytes:
    return _tlv(TAG_ENUMERATED, _int_content(int(v)))


def encode_utf8(s: str) -> bytes:
    return _tlv(TAG_UTF8STRING, s.encode("utf-8"))


def encode_real(x: float) -> bytes:
    """Canonical DER base-2 REAL (X.690 §8.5 + §11.3.1): mantissa odd (or
    zero), scaling factor F = 0, minimal two's-complement exponent."""
    x = float(x)
    if x == 0.0:
        if math.copysign(1.0, x) < 0:  # §8.5.9 minus-zero
            return _tlv(TAG_REAL, b"\x43")
        return _tlv(TAG_REAL, b"")
    if math.isinf(x):
        return _tlv(TAG_REAL, b"\x40" if x > 0 else b"\x41")
    if math.isnan(x):
        return _tlv(TAG_REAL, b"\x42")
    sign = 1 if x < 0 else 0
    m, e = math.frexp(abs(x))  # abs(x) = m * 2**e, m in [0.5, 1)
    mant = int(m * (1 << 53))
    e -= 53
    while mant & 1 == 0:
        mant >>= 1
        e += 1
    exp_bytes = e.to_bytes(max(1, (e.bit_length() + 8) // 8), "big", signed=True)
    if len(exp_bytes) > 3:
        raise InputOutputError(f"REAL exponent too wide: {x}")
    info = 0x80 | (sign << 6) | (len(exp_bytes) - 1)
    mant_bytes = mant.to_bytes((mant.bit_length() + 7) // 8, "big")
    return _tlv(TAG_REAL, bytes([info]) + exp_bytes + mant_bytes)


def encode_sequence(*children: bytes) -> bytes:
    return _tlv(TAG_SEQUENCE, b"".join(children))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
class DerReader:
    """Sequential TLV reader over a DER byte string."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def _read_tlv(self) -> Tuple[int, bytes]:
        data, p = self.data, self.pos
        if p + 2 > len(data):
            raise InputOutputError("DER: truncated TLV header")
        tag = data[p]
        first = data[p + 1]
        p += 2
        if first < 0x80:
            length = first
        else:
            n = first & 0x7F
            if n == 0 or p + n > len(data):
                raise InputOutputError("DER: bad length octets")
            length = int.from_bytes(data[p : p + n], "big")
            p += n
        if p + length > len(data):
            raise InputOutputError("DER: content overruns buffer")
        content = bytes(data[p : p + length])
        self.pos = p + length
        return tag, content

    def _expect(self, want: int) -> bytes:
        tag, content = self._read_tlv()
        if tag != want:
            raise InputOutputError(f"DER: expected tag {want:#x}, got {tag:#x}")
        return content

    def read_bool(self) -> bool:
        return self._expect(TAG_BOOLEAN) != b"\x00"

    def read_integer(self) -> int:
        return int.from_bytes(self._expect(TAG_INTEGER), "big", signed=True)

    def read_enumerated(self) -> int:
        return int.from_bytes(self._expect(TAG_ENUMERATED), "big", signed=True)

    def read_utf8(self) -> str:
        return self._expect(TAG_UTF8STRING).decode("utf-8")

    def read_real(self) -> float:
        content = self._expect(TAG_REAL)
        if not content:
            return 0.0
        info = content[0]
        if info == 0x40:
            return math.inf
        if info == 0x41:
            return -math.inf
        if info == 0x42:
            return math.nan
        if info == 0x43:
            return -0.0
        if not info & 0x80:
            raise InputOutputError("DER: decimal REAL encoding unsupported")
        base_bits = (info >> 4) & 0x3
        if base_bits != 0:
            raise InputOutputError("DER: only base-2 REAL supported")
        scale = (info >> 2) & 0x3
        n_exp = (info & 0x3) + 1
        if n_exp == 4:  # 0b11: next octet carries the exponent length
            n_exp = content[1]
            exp = int.from_bytes(content[2 : 2 + n_exp], "big", signed=True)
            mant = int.from_bytes(content[2 + n_exp :], "big")
        else:
            exp = int.from_bytes(content[1 : 1 + n_exp], "big", signed=True)
            mant = int.from_bytes(content[1 + n_exp :], "big")
        val = math.ldexp(mant << scale, exp)
        return -val if info & 0x40 else val

    def read_sequence(self) -> "DerReader":
        return DerReader(self._expect(TAG_SEQUENCE))


# ---------------------------------------------------------------------------
# Spacecraft / Orbit codecs (cosmic/spacecraft.rs:700-786 field order)
# ---------------------------------------------------------------------------
def orbit_to_der(orbit) -> bytes:
    r, v = orbit.r_km, orbit.v_km_s
    return encode_sequence(
        *[encode_real(c) for c in r],
        *[encode_real(c) for c in v],
        encode_real(orbit.epoch.to_tai_seconds()),
        encode_utf8(f"{orbit.frame.center}:{orbit.frame.orientation}"),
    )


def orbit_from_der(rd: DerReader):
    import numpy as np

    from ..cosmic.frames import Frame
    from ..cosmic.orbit import Orbit
    from ..time import Epoch

    seq = rd.read_sequence()
    vals = [seq.read_real() for _ in range(7)]
    center_s, orient_s = seq.read_utf8().split(":")
    frame = Frame(center=int(center_s), orientation=int(orient_s))
    epoch = Epoch.from_tai_seconds_j2000(vals[6])
    return Orbit(
        np.asarray(vals[0:3]), np.asarray(vals[3:6]), epoch, frame
    )


def spacecraft_to_der(sc) -> bytes:
    """Spacecraft -> DER bytes, mirroring the reference's field order:
    orbit, mass, srp, drag, guidance mode, optional thruster
    (spacecraft.rs:769-783)."""
    parts = [
        orbit_to_der(sc.orbit),
        encode_sequence(  # mass
            encode_real(sc.dry_mass_kg), encode_real(sc.prop_mass_kg)
        ),
        encode_sequence(  # srp
            encode_real(sc.srp_area_m2), encode_real(sc.cr)
        ),
        encode_sequence(  # drag
            encode_real(sc.drag_area_m2), encode_real(sc.cd)
        ),
        encode_enumerated(int(sc.mode)),
        encode_bool(sc.thruster is not None),
    ]
    if sc.thruster is not None:
        parts.append(
            encode_sequence(
                encode_real(sc.thruster.thrust_N),
                encode_real(sc.thruster.isp_s),
            )
        )
    return encode_sequence(*parts)


def spacecraft_from_der(data: bytes):
    from ..cosmic.spacecraft import Spacecraft, Thruster

    rd = DerReader(data).read_sequence()
    orbit = orbit_from_der(rd)
    mass = rd.read_sequence()
    dry, prop = mass.read_real(), mass.read_real()
    srp = rd.read_sequence()
    srp_area, cr = srp.read_real(), srp.read_real()
    drag = rd.read_sequence()
    drag_area, cd = drag.read_real(), drag.read_real()
    mode = rd.read_enumerated()
    thruster = None
    if rd.read_bool():
        t = rd.read_sequence()
        thruster = Thruster(thrust_N=t.read_real(), isp_s=t.read_real())
    return Spacecraft(
        orbit,
        dry_mass_kg=dry,
        prop_mass_kg=prop,
        srp_area_m2=srp_area,
        cr=cr,
        drag_area_m2=drag_area,
        cd=cd,
        thruster=thruster,
        mode=mode,
    )
