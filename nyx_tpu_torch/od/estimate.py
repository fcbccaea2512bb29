"""Filter estimates, residuals, and initial estimates from local-frame sigmas.

Host-side numpy copy of nyx_tpu/od/estimate.py:22-224: `KfEstimate` with its
sigma checks, its Keplerian covariance (the element map's Jacobian by
`torch.func.jacfwd`, where the reference takes `jax.jacfwd`) and its
covariance in RIC or VNC; `Residual`; and `SpacecraftUncertainty`, whose
local-frame rotation and randomized draw are host numpy as in the
reference (see `to_estimate_randomized`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..cosmic.orbit import keplerian_from_cartesian, ric_dcm, vnc_dcm
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

    def within_sigma(self, truth: Spacecraft, num_sigmas: float) -> bool:
        """Is the truth's position and velocity within `num_sigmas` of the
        best estimate, axis by axis?"""
        err = truth.to_vector() - self.state().to_vector()
        sig = np.sqrt(np.diag(self.covar))
        return bool(np.all(np.abs(err[:6]) <= num_sigmas * sig[:6]))

    def deviation_within_sigma(self, num_sigmas: float) -> bool:
        """Is the filter's own deviation within `num_sigmas` of its
        covariance (no truth needed)?"""
        sig = np.sqrt(np.diag(self.covar))
        return bool(np.all(np.abs(self.state_deviation) <= num_sigmas * sig))

    def within_3sigma(self) -> bool:
        return self.deviation_within_sigma(3.0)

    def keplerian_covar(self) -> np.ndarray:
        """6x6 covariance of (sma km, ecc, inc, raan, aop, ta in degrees):
        the Cartesian covariance through the Jacobian of the osculating
        element map, by forward mode."""
        mu = self.nominal.orbit.frame.mu_km3_s2

        def elems(rv6):
            k = keplerian_from_cartesian(rv6[0:3], rv6[3:6], mu)
            return torch.stack([k["sma"], k["ecc"]] + [torch.rad2deg(k[n]) for n in
                                                       ("inc", "raan", "aop", "ta")])

        rv6 = torch.tensor(self.nominal.to_vector()[:6], dtype=torch.float64)
        jac = torch.func.jacfwd(elems)(rv6).numpy()
        return jac @ self.covar[0:6, 0:6] @ jac.T

    def covar_in_frame(self, local_frame: str) -> np.ndarray:
        """6x6 position/velocity covariance rotated into RIC or VNC."""
        r, v = (torch.tensor(np.asarray(x, dtype=np.float64)) for x in
                (self.nominal.orbit.r_km, self.nominal.orbit.v_km_s))
        dcm3 = (ric_dcm(r, v) if local_frame.lower() == "ric" else vnc_dcm(r, v)).numpy()
        dcm6 = np.zeros((6, 6))
        dcm6[0:3, 0:3] = dcm3
        dcm6[3:6, 3:6] = dcm3
        return dcm6 @ self.covar[0:6, 0:6] @ dcm6.T


@dataclass
class Residual:
    """Pre- and post-fit residuals and the rejection ratio of one
    measurement; `real_obs` and `computed_obs` are the observed and
    computed values."""

    epoch: Epoch
    tracker: str
    msr_types: tuple
    prefit: np.ndarray
    postfit: np.ndarray
    ratio: float
    rejected: bool
    real_obs: Optional[np.ndarray] = None
    computed_obs: Optional[np.ndarray] = None

    def __str__(self):
        tag = "REJECTED " if self.rejected else ""
        return f"{tag}residual at {self.epoch} [{self.tracker}]: prefit {self.prefit}, ratio {self.ratio:.3f}"


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

    def to_estimate_randomized(self, rng: np.random.Generator):
        """(estimate, dispersed truth): the nominal moved by one draw from
        the uncertainty. The draw is L z, L the Cholesky factor of the
        covariance's nonzero block and z nine standard normals from `rng`,
        not `rng.multivariate_normal`: its SVD is discontinuous on a
        rotationally degenerate covariance (isotropic sigmas), so a 1e-16
        difference in the rotated matrix gave a wholly different (equally
        valid) draw. Cholesky is continuous in the matrix."""
        est = self.to_estimate()
        p = np.asarray(est.covar)
        mask = np.diag(p) > 0.0
        l_f = np.zeros_like(p)
        if mask.any():
            l_f[np.ix_(mask, mask)] = np.linalg.cholesky(p[np.ix_(mask, mask)])
        draw = l_f @ rng.standard_normal(STATE_DIM)
        truth = self.nominal.set_vector(self.nominal.epoch, self.nominal.to_vector() + draw)
        return est, truth
