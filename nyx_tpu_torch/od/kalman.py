"""State-noise compensation for the Kalman filters.

Port of `ProcessNoise` from nyx_tpu/od/kalman.py:38-86 (the reference's
od/snc.rs): a diagonal acceleration PSD, optionally decaying and in a
local frame, gated by the time since the last measurement, with
chronological switchover by start epoch. `ScanKalmanOD` evaluates it for
every row on the device (`ScanKalmanOD._snc_q`). The host form
`q_matrix` and the host-loop `KalmanFilter` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ProcessNoise:
    """Piecewise state-noise compensation.

    Diagonal acceleration PSD q [km^2/s^4] (3,), optionally exponentially
    decaying and/or expressed in a local frame (RIC/VNC), gated by
    `disable_time_s` (no SNC when the time since the last measurement
    exceeds it), with optional chronological switchover via `start_epoch`.
    """

    q_diag_km2_s4: np.ndarray  # (3,) acceleration variances
    disable_time_s: float = 7200.0
    local_frame: Optional[str] = None  # None (inertial), 'ric', 'vnc'
    decay_tau_s: Optional[np.ndarray] = None  # (3,) exponential decay
    start_epoch_tai_s: Optional[float] = None

    @classmethod
    def from_diag(cls, q_diag, disable_time_s=7200.0) -> "ProcessNoise":
        return cls(np.asarray(q_diag, dtype=np.float64), disable_time_s)

    @classmethod
    def from_velocity_km_s(cls, velocity_noise, over_s, disable_time_s=7200.0):
        """SNC from an expected velocity error accumulated over a duration:
        q_ii = (dv_i / T)^2."""
        v = np.asarray(velocity_noise, dtype=np.float64)
        return cls((v / over_s) ** 2, disable_time_s)
