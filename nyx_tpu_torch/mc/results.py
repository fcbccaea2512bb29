"""Monte Carlo results (torch port of the core of nyx_tpu/mc/results.py).

Final states, statuses and step counts as host numpy arrays. Trajectory
capture, Hermite interpolation and parquet export are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..cosmic.spacecraft import Spacecraft
from ..propagators.integrator import DONE
from ..time import Epoch


@dataclass
class Results:
    epoch0: Epoch
    end_epoch: Epoch
    template: Spacecraft
    y_final: np.ndarray  # [B, 9]
    status: np.ndarray  # [B]
    n_accepted: np.ndarray  # [B]
    n_rejected: np.ndarray  # [B]
    y_initial: Optional[np.ndarray] = None  # [B, 9] dispersed initial states

    @property
    def n_runs(self) -> int:
        return self.y_final.shape[0]

    @property
    def n_ok(self) -> int:
        return int(np.sum(self.status == DONE))
