"""Filter estimates, and initial estimates from local-frame sigmas.

Host-side numpy copy of nyx_tpu/od/estimate.py: `KfEstimate` (:23-75) and
`SpacecraftUncertainty.to_estimate` (:148-198), whose local-frame rotation
is host numpy as in the reference (it keeps seeded draws from a rotated,
degenerate covariance the same on every platform). Residuals, the
Keplerian covariance and randomized estimates are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cosmic.spacecraft import Spacecraft
from ..time import Epoch

STATE_DIM = 9


@dataclass
class KfEstimate:
    """Nominal state + deviation + covariances."""

    nominal: Spacecraft
    state_deviation: np.ndarray  # [9]
    covar: np.ndarray  # [9, 9]
    covar_bar: np.ndarray  # [9, 9] pre-update
    stm: np.ndarray  # [9, 9] Phi since previous estimate
    predicted: bool = False

    @classmethod
    def from_covar(cls, nominal: Spacecraft, covar) -> "KfEstimate":
        covar = np.asarray(covar, dtype=np.float64)
        return cls(nominal=nominal, state_deviation=np.zeros(STATE_DIM), covar=covar.copy(),
                   covar_bar=covar.copy(), stm=np.eye(STATE_DIM), predicted=False)

    @classmethod
    def from_diag(cls, nominal: Spacecraft, diag) -> "KfEstimate":
        return cls.from_covar(nominal, np.diag(np.asarray(diag, dtype=np.float64)))

    @property
    def epoch(self) -> Epoch:
        return self.nominal.epoch

    def state(self) -> Spacecraft:
        """Best estimate = nominal + deviation."""
        return self.nominal.set_vector(self.nominal.epoch,
                                       self.nominal.to_vector() + self.state_deviation)

    def sigma_for(self, index: int) -> float:
        return float(np.sqrt(self.covar[index, index]))


@dataclass
class SpacecraftUncertainty:
    """An initial estimate from local-frame sigmas (`to_estimate`)."""

    nominal: Spacecraft
    frame: str = "ric"  # 'ric', 'vnc' or 'inertial'
    x_km: float = 0.0
    y_km: float = 0.0
    z_km: float = 0.0
    vx_km_s: float = 0.0
    vy_km_s: float = 0.0
    vz_km_s: float = 0.0
    cr: float = 0.0
    cd: float = 0.0
    prop_mass_kg: float = 0.0

    def to_estimate(self) -> KfEstimate:
        sig_pos = np.array([self.x_km, self.y_km, self.z_km])
        sig_vel = np.array([self.vx_km_s, self.vy_km_s, self.vz_km_s])
        p6 = np.diag(np.concatenate([sig_pos, sig_vel]) ** 2)
        if self.frame.lower() in ("ric", "vnc"):
            r = np.asarray(self.nominal.orbit.r_km, dtype=np.float64)
            v = np.asarray(self.nominal.orbit.v_km_s, dtype=np.float64)
            if self.frame.lower() == "ric":
                rhat = r / np.linalg.norm(r)
                h = np.cross(r, v)
                chat = h / np.linalg.norm(h)
                dcm3 = np.stack([rhat, np.cross(chat, rhat), chat])
            else:
                vhat = v / np.linalg.norm(v)
                h = np.cross(r, v)
                nhat = h / np.linalg.norm(h)
                dcm3 = np.stack([vhat, nhat, np.cross(vhat, nhat)])
            dcm6 = np.zeros((6, 6))
            dcm6[0:3, 0:3] = dcm3
            dcm6[3:6, 3:6] = dcm3
            # sigmas defined in the local frame: P_inertial = D^T P_local D
            p6 = dcm6.T @ p6 @ dcm6
        p = np.zeros((STATE_DIM, STATE_DIM))
        p[0:6, 0:6] = p6
        p[6, 6] = self.cr**2
        p[7, 7] = self.cd**2
        p[8, 8] = self.prop_mass_kg**2
        return KfEstimate.from_covar(self.nominal, p)
