"""Monte Carlo results (torch port of the core of nyx_tpu/mc/results.py).

Final states, statuses and step counts as host numpy arrays, and the
statistics of a StateParameter over the final states. Trajectory capture,
Hermite interpolation and parquet export are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..cosmic.spacecraft import Spacecraft
from ..md import param as param_mod
from ..propagators.integrator import DONE
from ..time import Epoch


@dataclass
class Results:
    epoch0: Epoch
    end_epoch: Epoch
    template: Spacecraft
    y_final: np.ndarray  # [B, N]: N = 9, or 10 with the guidance mode last
    status: np.ndarray  # [B]
    n_accepted: np.ndarray  # [B]
    n_rejected: np.ndarray  # [B]
    y_initial: Optional[np.ndarray] = None  # [B, N] dispersed initial states
    iterations: int = 0  # host-loop iterations of the propagation

    @property
    def n_runs(self) -> int:
        return self.y_final.shape[0]

    @property
    def n_ok(self) -> int:
        return int(np.sum(self.status == DONE))

    def final_values_of(self, parameter: str) -> np.ndarray:
        """[B] values of a StateParameter at each run's final state."""
        y = torch.tensor(self.y_final, dtype=torch.float64)
        return param_mod.value(parameter, y, self.template.frame.mu).numpy()

    def dispersion_values_of(self, parameter: str) -> tuple[float, float]:
        """(mean, standard deviation) of a StateParameter over the final
        states."""
        vals = self.final_values_of(parameter)
        return float(np.mean(vals)), float(np.std(vals))
