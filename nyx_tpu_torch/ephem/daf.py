"""NAIF DAF / SPK / binary-PCK reader (host-side, numpy).

A from-scratch parser for the kernel formats the reference consumes through
ANISE (de440s.bsp, earth *.bpc — SURVEY.md §7 foundations). Supports the DAF
container (little/big endian), SPK segment types 2 (Chebyshev position) and
3 (Chebyshev position+velocity), and binary PCK type 2 (Chebyshev Euler
angles). Segment data is exposed as numpy arrays ready for device-table
construction.

Copied from nyx_tpu/ephem/daf.py (host-only numpy, no JAX); the byte layout
is the same, so each package reads the other's files.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
from ..errors import InputOutputError

RECLEN = 1024


@dataclass
class Segment:
    target: int  # SPK: target body; PCK: body-fixed frame class id
    center: int  # SPK: center body; PCK: inertial frame id
    frame: int  # SPK reference frame id (1 = J2000)
    data_type: int
    t_start: float  # ET (TDB) seconds past J2000
    t_stop: float
    start_word: int  # 1-indexed double-precision word address
    end_word: int


@dataclass
class ChebyshevRecords:
    """Uniform Chebyshev records covering [init, init + n*intlen]."""

    init: float
    intlen: float
    coeffs: np.ndarray  # [n_records, n_components, degree+1]

    @property
    def n_records(self) -> int:
        return self.coeffs.shape[0]

    @property
    def degree(self) -> int:
        return self.coeffs.shape[2] - 1


class DAF:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        raw = self.path.read_bytes()
        if len(raw) < RECLEN:
            raise InputOutputError(f"{path}: not a DAF file (too small)")
        self.idword = raw[0:8].decode("ascii", "replace").strip()
        if not self.idword.startswith("DAF/"):
            raise InputOutputError(f"{path}: bad DAF id word {self.idword!r}")
        locfmt = raw[88:96].decode("ascii", "replace")
        if "LTL" in locfmt:
            self._end = "<"
        elif "BIG" in locfmt:
            self._end = ">"
        else:
            raise InputOutputError(f"{path}: unknown binary format {locfmt!r}")
        i4 = np.dtype(self._end + "i4")
        self.nd = int(np.frombuffer(raw[8:12], i4)[0])
        self.ni = int(np.frombuffer(raw[12:16], i4)[0])
        self.fward = int(np.frombuffer(raw[76:80], i4)[0])
        self.bward = int(np.frombuffer(raw[80:84], i4)[0])
        self._raw = raw
        self._f8 = np.dtype(self._end + "f8")
        self.summaries = self._read_summaries()

    def _record(self, recno: int) -> bytes:
        off = (recno - 1) * RECLEN
        return self._raw[off : off + RECLEN]

    def _read_summaries(self):
        ss = self.nd + (self.ni + 1) // 2  # doubles per summary
        out = []
        recno = self.fward
        while recno > 0:
            rec = np.frombuffer(self._record(recno), self._f8)
            nxt, _prev, nsum = int(rec[0]), int(rec[1]), int(rec[2])
            for i in range(nsum):
                s = rec[3 + i * ss : 3 + (i + 1) * ss]
                dc = s[: self.nd]
                ic = np.frombuffer(
                    s[self.nd :].tobytes(), np.dtype(self._end + "i4")
                )[: self.ni]
                out.append((dc.copy(), ic.copy()))
            recno = nxt
        return out

    def words(self, start: int, end: int) -> np.ndarray:
        """Double-precision words [start, end], 1-indexed inclusive."""
        return np.frombuffer(
            self._raw, self._f8, count=end - start + 1, offset=(start - 1) * 8
        )


def _chebyshev_from_type2(daf: DAF, seg: Segment, n_components: int) -> ChebyshevRecords:
    data = daf.words(seg.start_word, seg.end_word)
    init, intlen, rsize, n = data[-4], data[-3], int(data[-2]), int(data[-1])
    body = data[: rsize * n].reshape(n, rsize)
    # each record: MID, RADIUS, then n_components * (deg+1) coefficients
    ncoef = (rsize - 2) // n_components
    coeffs = body[:, 2:].reshape(n, n_components, ncoef)
    return ChebyshevRecords(float(init), float(intlen), coeffs.copy())


class SPK(DAF):
    """SPK kernel: planetary/spacecraft ephemeris segments."""

    def __init__(self, path):
        super().__init__(path)
        if "SPK" not in self.idword and "NIO" not in self.idword:
            raise InputOutputError(f"{path}: not an SPK ({self.idword})")
        self.segments: List[Segment] = []
        for dc, ic in self.summaries:
            self.segments.append(
                Segment(
                    target=int(ic[0]),
                    center=int(ic[1]),
                    frame=int(ic[2]),
                    data_type=int(ic[3]),
                    t_start=float(dc[0]),
                    t_stop=float(dc[1]),
                    start_word=int(ic[4]),
                    end_word=int(ic[5]),
                )
            )

    def segment_for(self, target: int, t_tdb_s: float | None = None) -> Segment:
        cands = [s for s in self.segments if s.target == target]
        if t_tdb_s is not None:
            cands = [s for s in cands if s.t_start <= t_tdb_s <= s.t_stop]
        if not cands:
            raise KeyError(f"no segment for body {target}")
        return cands[0]

    def chebyshev_records(self, seg: Segment) -> ChebyshevRecords:
        if seg.data_type == 2:
            return _chebyshev_from_type2(self, seg, 3)
        if seg.data_type == 3:
            return _chebyshev_from_type2(self, seg, 6)
        raise NotImplementedError(f"SPK type {seg.data_type}")

    def position(self, target: int, center: int, t_tdb_s: float) -> np.ndarray:
        """Single-epoch position of target rel center, chaining segments."""
        chain_t = self._chain_to_ssb(target, t_tdb_s)
        chain_c = self._chain_to_ssb(center, t_tdb_s)
        return chain_t - chain_c

    def _eval_segment(self, seg: Segment, t: float) -> np.ndarray:
        rec = self.chebyshev_records(seg)
        i = int(np.clip((t - rec.init) // rec.intlen, 0, rec.n_records - 1))
        tau = 2.0 * (t - rec.init - i * rec.intlen) / rec.intlen - 1.0
        deg = rec.degree
        tj = np.polynomial.chebyshev.chebvander(np.array([tau]), deg)[0]
        return rec.coeffs[i, 0:3] @ tj

    def _chain_to_ssb(self, body: int, t: float) -> np.ndarray:
        pos = np.zeros(3)
        while body != 0:
            seg = self.segment_for(body, t)
            pos = pos + self._eval_segment(seg, t)
            body = seg.center
        return pos


class BPC(DAF):
    """Binary PCK: body orientation as Chebyshev Euler angles (type 2)."""

    def __init__(self, path):
        super().__init__(path)
        self.segments: List[Segment] = []
        for dc, ic in self.summaries:
            self.segments.append(
                Segment(
                    target=int(ic[0]),  # body-fixed frame class id (e.g. 3000)
                    center=int(ic[1]),  # inertial frame id
                    frame=int(ic[1]),
                    data_type=int(ic[2]),
                    t_start=float(dc[0]),
                    t_stop=float(dc[1]),
                    start_word=int(ic[3]),
                    end_word=int(ic[4]),
                )
            )

    def chebyshev_records(self, seg: Segment) -> ChebyshevRecords:
        if seg.data_type == 2:
            return _chebyshev_from_type2(self, seg, 3)
        raise NotImplementedError(f"PCK type {seg.data_type}")
