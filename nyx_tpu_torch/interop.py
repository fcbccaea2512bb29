"""Carrying tables and states from the JAX package into the port.

These take numpy arrays and plain numbers only, so this module imports
neither JAX nor `nyx_tpu`. Tests use them to hold the port against the
reference on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .cosmic.frames import Frames
from .dynamics.gravity import Harmonics
from .ephem.almanac import EphemTable


def harmonics_from_tables(xs, diag, N: int, M: int, mu: float, radius: float,
                          precision: str, j2: float, j3: float) -> Harmonics:
    """The port's Harmonics (an Earth field, in IAU_EARTH) from the
    reference object's `_tables` (xs, diag, N, M) and constants, so both
    compute from identical rows."""
    xs = {k: np.asarray(v) for k, v in xs.items()}
    return Harmonics(
        _tables=(xs, np.asarray(diag), int(N), int(M)),
        mu_km3_s2=float(mu),
        radius_km=float(radius),
        max_degree=int(N),
        max_order=int(M),
        frame=Frames.IAU_EARTH,
        precision=precision,
        j2=float(j2),
        j3=float(j3),
    )


def ephem_table_from_numpy(t0: float, intlen: float, coeffs, bodies, *, device) -> EphemTable:
    """An EphemTable from the reference table's arrays."""
    return EphemTable(
        t0=float(t0),
        intlen=float(intlen),
        coeffs=torch.tensor(np.asarray(coeffs), dtype=torch.float64, device=device),
        bodies=tuple(int(b) for b in bodies),
    )


def states_from_numpy(y0, *, device) -> torch.Tensor:
    """Injected initial states [B, 9] as a float64 tensor on `device`."""
    y0 = np.asarray(y0, dtype=np.float64)
    if y0.ndim != 2 or y0.shape[1] != 9:
        raise ValueError(f"initial states must be [B, 9], got {y0.shape}")
    return torch.as_tensor(y0, dtype=torch.float64, device=device)
