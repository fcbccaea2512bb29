"""Monte Carlo helpers: seeded unit vectors and delta-v error models.

Copied from nyx_tpu/mc/helpers.py (the counterpart of the reference's
mc/helpers.rs:25-68): host numpy, so the same `numpy.random.Generator`
seed gives the same draws to the bit in both packages. Batched-first: every
function accepts either a single vector or an ensemble [B, 3].
"""

from __future__ import annotations

import numpy as np
from ..errors import MonteCarloError


def unit_vector_from_seed(rng: np.random.Generator, n: int = None):
    """Uniformly distributed unit vector(s) by sphere point picking
    (helpers.rs:25-32). Returns [3] (n=None) or [n, 3]."""
    size = () if n is None else (n,)
    u = rng.uniform(0.0, 1.0, size)
    v = rng.uniform(0.0, 1.0, size)
    theta = 2.0 * np.pi * u
    phi = np.arccos(2.0 * v - 1.0)
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=-1,
    )


def dv_pointing_error(cur_pointing, dv, error_prct3s: float,
                      rng: np.random.Generator):
    """Apply a Normal pointing error to a delta-v vector (km/s), matching
    helpers.rs:37-66: draw a new angle about the current pointing with a
    1-sigma of error_prct3s/3, scale the delta-v direction by its cosine.
    Batched over leading axes."""
    if not (0.0 <= error_prct3s < 1.0):
        raise MonteCarloError(
            f"pointing error percentage must be in [0, 1), got {error_prct3s}"
        )
    cur_pointing = np.asarray(cur_pointing, dtype=np.float64)
    dv = np.asarray(dv, dtype=np.float64)
    dv_mag = np.linalg.norm(dv, axis=-1, keepdims=True)
    if np.any(dv_mag < np.finfo(np.float64).eps):
        raise MonteCarloError("delta-v vector is nil, cannot apply a pointing error")
    dv_hat = dv / dv_mag
    cur_mag = np.linalg.norm(cur_pointing, axis=-1, keepdims=True)
    cur_angle = np.arccos(
        np.clip(
            np.sum(cur_pointing * dv_hat, axis=-1, keepdims=True) / cur_mag,
            -1.0,
            1.0,
        )
    )
    new_angle = rng.normal(cur_angle, error_prct3s / 3.0)
    return dv_hat * np.cos(new_angle) * dv_mag


def dv_execution_error(cur_pointing, dv, pointing_3s: float, mag_3s: float,
                       rng: np.random.Generator):
    """Delta-v with both pointing and magnitude execution errors
    (helpers.rs:69-80)."""
    dv_p = dv_pointing_error(cur_pointing, dv, pointing_3s, rng)
    mag = np.linalg.norm(dv_p, axis=-1, keepdims=True)
    new_mag = rng.normal(mag, mag_3s / 3.0)
    return new_mag * (dv_p / mag)
