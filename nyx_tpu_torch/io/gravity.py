"""Gravity potential coefficient loaders.

Counterpart of the reference's `GravityFieldData` (nyx-core/src/io/gravity.rs:
43-160,504-560): loads GMAT COF (e.g. JGM-3), SHADR .tab (e.g. GRAIL JGGRX)
and EGM2008 ASCII files, gzipped or plain, plus the analytic `from_j2`
constructor, and stores fully normalized C/S as dense numpy [N+1, M+1]
arrays.

Copied from nyx_tpu/io/gravity.py (host-only, no JAX), the three loaders
sharing the routine that fills the dense arrays.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_FLOAT_RE = re.compile(r"[-+]?\d*\.\d+(?:[eEdD][-+]?\d+)?")


def _open_text(path, gunzipped: bool):
    p = Path(path)
    if gunzipped or p.suffix == ".gz":
        return gzip.open(p, "rt")
    return open(p, "r")


@dataclass
class GravityFieldData:
    """Normalized spherical-harmonic coefficients for one body."""

    c_nm: np.ndarray  # [N+1, M+1] fully normalized
    s_nm: np.ndarray
    mu_km3_s2: float
    radius_km: float
    frame: object = None  # body-fixed Frame the coefficients live in

    @property
    def max_degree(self) -> int:
        return self.c_nm.shape[0] - 1

    @property
    def max_order(self) -> int:
        return self.c_nm.shape[1] - 1

    def truncated(self, degree: int, order: int) -> "GravityFieldData":
        return GravityFieldData(
            self.c_nm[: degree + 1, : order + 1].copy(),
            self.s_nm[: degree + 1, : order + 1].copy(),
            self.mu_km3_s2,
            self.radius_km,
            self.frame,
        )

    @classmethod
    def from_j2(cls, j2: float, frame=None, mu_km3_s2=None, radius_km=None) -> "GravityFieldData":
        """Single C20 term, stored verbatim as the *normalized* C20 (pass
        -J2/sqrt(5)), as the reference's from_j2 (io/gravity.rs:117-128)
        stores its argument directly."""
        c = np.zeros((3, 1))
        c[2, 0] = j2
        if frame is not None:
            mu_km3_s2 = mu_km3_s2 or frame.mu_km3_s2
            radius_km = radius_km or frame.radius_km
        return cls(c, np.zeros((3, 1)), mu_km3_s2, radius_km, frame)

    @classmethod
    def from_cof(
        cls, path, degree: int | None = None, order: int | None = None,
        gunzipped: bool = False, frame=None,
    ) -> "GravityFieldData":
        """GMAT COF format (POTFIELD header + RECOEF lines, normalized)."""
        mu = radius = None
        rows = []
        with _open_text(path, gunzipped) as f:
            for line in f:
                if line.startswith("POTFIELD"):
                    toks = line.split()
                    # POTFIELD deg ord flag mu_m3_s2 radius_m normalized
                    mu = float(toks[4]) / 1e9
                    radius = float(toks[5]) / 1e3
                elif line.startswith("RECOEF"):
                    body = line[6:]
                    vals = [float(v.replace("D", "e")) for v in _FLOAT_RE.findall(body[9:])]
                    rows.append((int(body[:5]), int(body[5:9]), vals[0], vals[1] if len(vals) > 1 else 0.0))
        c_nm, s_nm = _dense(rows, degree, order)
        if frame is not None:
            mu = mu or frame.mu_km3_s2
            radius = radius or frame.radius_km
        return cls(c_nm, s_nm, mu, radius, frame)

    @classmethod
    def from_shadr(
        cls, path, degree: int | None = None, order: int | None = None,
        gunzipped: bool = False, frame=None,
    ) -> "GravityFieldData":
        """SHADR .tab format (header line: radius_km, mu, uncertainty, degree,
        order, normalized, ref_lon, ref_lat; then n, m, C, S, sigmas)."""
        with _open_text(path, gunzipped) as f:
            header = f.readline().replace("D", "e").replace(",", " ").split()
            radius = float(header[0])
            mu = float(header[1])
            if mu > 1e9:  # given in m^3/s^2
                mu /= 1e9
            if radius > 1e5:  # given in m
                radius /= 1e3
            rows = []
            for line in f:
                toks = line.replace("D", "e").replace(",", " ").split()
                if len(toks) < 4:
                    continue
                rows.append((int(float(toks[0])), int(float(toks[1])), float(toks[2]), float(toks[3])))
        c_nm, s_nm = _dense(rows, degree, order)
        return cls(c_nm, s_nm, mu, radius, frame)

    @classmethod
    def from_egm2008(cls, path, degree=None, order=None, gunzipped=False, frame=None):
        """EGM2008 ASCII: n m C S sigmaC sigmaS per line."""
        rows = []
        with _open_text(path, gunzipped) as f:
            for line in f:
                toks = line.replace("D", "e").split()
                if len(toks) < 4:
                    continue
                rows.append((int(toks[0]), int(toks[1]), float(toks[2]), float(toks[3])))
        c_nm, s_nm = _dense(rows, degree, order)
        # EGM2008's own constants unless a frame overrides them
        mu = frame.mu_km3_s2 if frame is not None else 398_600.4415
        radius = frame.radius_km if frame is not None else 6_378.1363
        return cls(c_nm, s_nm, mu, radius, frame)


def _dense(rows, degree, order):
    """Dense [N+1, M+1] C and S (C00 = 1) from (n, m, C, S) rows, keeping
    those within `degree` and `order` (None: all)."""
    rows = [r for r in rows if (degree is None or r[0] <= degree) and (order is None or r[1] <= order)]
    max_n = max((r[0] for r in rows), default=0)
    max_m = max((r[1] for r in rows), default=0)
    c_nm = np.zeros((max_n + 1, max_m + 1))
    s_nm = np.zeros((max_n + 1, max_m + 1))
    c_nm[0, 0] = 1.0
    for n, m, c, s in rows:
        c_nm[n, m] = c
        s_nm[n, m] = s
    return c_nm, s_nm
