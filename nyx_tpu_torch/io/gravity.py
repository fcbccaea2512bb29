"""Gravity potential coefficient loaders.

Counterpart of the reference's `GravityFieldData` (nyx-core/src/io/gravity.rs:
43-160,504-560): loads GMAT COF (e.g. JGM-3), gzipped or plain, and stores
fully normalized C/S as dense numpy [N+1, M+1] arrays.

The COF loader copied from nyx_tpu/io/gravity.py (host-only, no JAX);
the SHADR and EGM2008 loaders, `from_j2` and `truncated` are not ported yet.
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

    @classmethod
    def from_cof(
        cls, path, degree: int | None = None, order: int | None = None,
        gunzipped: bool = False, frame=None,
    ) -> "GravityFieldData":
        """GMAT COF format (POTFIELD header + RECOEF lines, normalized)."""
        mu = radius = None
        max_n = max_m = 0
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
                    n = int(body[:5])
                    m = int(body[5:9])
                    vals = [float(v.replace("D", "e")) for v in _FLOAT_RE.findall(body[9:])]
                    c = vals[0]
                    s = vals[1] if len(vals) > 1 else 0.0
                    if degree is not None and n > degree:
                        continue
                    if order is not None and m > order:
                        continue
                    rows.append((n, m, c, s))
                    max_n = max(max_n, n)
                    max_m = max(max_m, m)
        c_nm = np.zeros((max_n + 1, max_m + 1))
        s_nm = np.zeros((max_n + 1, max_m + 1))
        c_nm[0, 0] = 1.0
        for n, m, c, s in rows:
            c_nm[n, m] = c
            s_nm[n, m] = s
        if frame is not None:
            mu = mu or frame.mu_km3_s2
            radius = radius or frame.radius_km
        return cls(c_nm, s_nm, mu, radius, frame)
