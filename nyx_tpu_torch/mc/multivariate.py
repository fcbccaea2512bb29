"""Multivariate-normal spacecraft sampling in parameter space.

Torch port of nyx_tpu/mc/multivariate.py: dispersions on StateParameters
(orbital elements, Cr/Cd/mass) are mapped into the 9-dim Cartesian state
through the Jacobian of the parameters wrt the state (`torch.func.jacfwd`,
float64 on the CPU), the covariance is rotated with the pseudo-inverse, and
samples are drawn with an SVD square root, the reference's scheme.
`from_covariance` takes a Cartesian covariance directly (a 6x6 is
zero-padded to 9x9). Draws come from an explicit `torch.Generator`; they
are not the JAX package's draws.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..cosmic.spacecraft import Spacecraft
from ..md import param as param_mod
from .dispersion import StateDispersion


class MvnSpacecraft:
    def __init__(self, template: Spacecraft, dispersions: Sequence[StateDispersion]):
        self.template = template
        self.dispersions = list(dispersions)
        frame = template.frame
        self.mu = frame.mu
        self.radius_km = frame.radius_km or 0.0
        self._nominal = template.to_vector()

        params = [d.parameter for d in self.dispersions]

        def param_vec(y):
            return torch.stack([param_mod.value(p, y, self.mu, self.radius_km) for p in params])

        nominal = torch.tensor(self._nominal, dtype=torch.float64, device="cpu")
        jac = torch.func.jacfwd(param_vec)(nominal).numpy()  # [n_params, 9]
        # Cartesian covariance: pinv(J) diag(sigma^2) pinv(J)^T
        sigmas = np.array([d.std_dev for d in self.dispersions])
        means = np.array([d.mean for d in self.dispersions])
        jinv = np.linalg.pinv(jac)
        self.covar = jinv @ np.diag(sigmas**2) @ jinv.T  # [9, 9]
        self.mean_shift = jinv @ means

        self.sqrt_covar = _svd_sqrt(self.covar)

    @classmethod
    def new(cls, template: Spacecraft, dispersions) -> "MvnSpacecraft":
        return cls(template, dispersions)

    @classmethod
    def from_covariance(cls, template: Spacecraft, covar) -> "MvnSpacecraft":
        """Zero-mean dispersions with the Cartesian covariance `covar`
        ([n, n], n <= 9, zero-padded to the 9x9 state covariance)."""
        self = object.__new__(cls)
        self.template = template
        self.dispersions = []
        frame = template.frame
        self.mu = frame.mu
        self.radius_km = frame.radius_km or 0.0
        self._nominal = template.to_vector()
        covar = np.asarray(covar, dtype=np.float64)
        n = covar.shape[0]
        self.covar = np.zeros((9, 9))
        self.covar[:n, :n] = covar
        self.mean_shift = np.zeros(9)
        self.sqrt_covar = _svd_sqrt(self.covar)
        return self

    def sample(self, n: int, generator: torch.Generator, *, device,
               dtype=torch.float64) -> torch.Tensor:
        """Draw n dispersed state vectors [n, 9]. The normal draws come from
        `generator` on the CPU, so a seed gives the same lanes on any device."""
        z = torch.randn((n, 9), generator=generator, dtype=torch.float64, device="cpu")
        mean = torch.from_numpy(self._nominal + self.mean_shift)
        states = mean + z @ torch.from_numpy(self.sqrt_covar).T
        return states.to(device=device, dtype=dtype)


def _svd_sqrt(covar: np.ndarray) -> np.ndarray:
    """U sqrt(S) of the SVD of a symmetric PSD covariance, for sampling."""
    u, s, _vt = np.linalg.svd(covar, hermitian=True)
    return u @ np.diag(np.sqrt(np.maximum(s, 0.0)))
