"""Multivariate-normal spacecraft sampling in parameter space.

Torch port of nyx_tpu/mc/multivariate.py: dispersions on StateParameters
(orbital elements, Cr/Cd/mass) are mapped into the 9-dim Cartesian state
through the Jacobian of the parameters wrt the state (`torch.func.jacfwd`,
float64 on the CPU), the covariance is rotated with the pseudo-inverse, and
samples are drawn with an SVD square root, the reference's scheme. Draws come
from an explicit `torch.Generator`; they are not the JAX package's draws.
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
        self._nominal = template.to_vector()

        params = [d.parameter for d in self.dispersions]

        def param_vec(y):
            return torch.stack([param_mod.value(p, y, self.mu) for p in params])

        nominal = torch.tensor(self._nominal, dtype=torch.float64, device="cpu")
        jac = torch.func.jacfwd(param_vec)(nominal).numpy()  # [n_params, 9]
        # Cartesian covariance: pinv(J) diag(sigma^2) pinv(J)^T
        sigmas = np.array([d.std_dev for d in self.dispersions])
        means = np.array([d.mean for d in self.dispersions])
        jinv = np.linalg.pinv(jac)
        self.covar = jinv @ np.diag(sigmas**2) @ jinv.T  # [9, 9]
        self.mean_shift = jinv @ means

        u, s, _vt = np.linalg.svd(self.covar, hermitian=True)
        self.sqrt_covar = u @ np.diag(np.sqrt(np.maximum(s, 0.0)))

    def sample(self, n: int, generator: torch.Generator, *, device,
               dtype=torch.float64) -> torch.Tensor:
        """Draw n dispersed state vectors [n, 9]. The normal draws come from
        `generator` on the CPU, so a seed gives the same lanes on any device."""
        z = torch.randn((n, 9), generator=generator, dtype=torch.float64, device="cpu")
        mean = torch.from_numpy(self._nominal + self.mean_shift)
        states = mean + z @ torch.from_numpy(self.sqrt_covar).T
        return states.to(device=device, dtype=dtype)
