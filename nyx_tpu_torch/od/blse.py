"""Batch least-squares estimation.

Port of nyx_tpu/od/blse.py:27-167 (the reference's od/blse/): iterative
normal equations (H^T W H) dx0 = H^T W dy about the initial epoch, with an
optional Levenberg-Marquardt damping schedule, converging on the norm of
the position correction. Each iteration propagates the reference with its
state-carried STM through the arc on `device` and maps every measurement's
partials (by `torch.func.jacfwd`) back to the initial epoch through the
accumulated Phi(t_i, t0); the 6x6 normal equations are solved on the host,
as the reference solves them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .msr import TrackingDataArc

STATE_DIM = 9
EST_DIM = 6  # position and velocity alone are estimated


class BLSSolver:
    NormalEquations = "normal_eq"
    LevenbergMarquardt = "lm"


@dataclass
class BLSSolution:
    estimated_state: object
    covariance: np.ndarray
    num_iterations: int
    final_rms: float
    final_corr_pos_km: float
    converged: bool

    def __str__(self):
        return (
            f"BLSSolution({'converged' if self.converged else 'NOT converged'} "
            f"in {self.num_iterations} iters, rms {self.final_rms:.3e}, "
            f"last pos corr {self.final_corr_pos_km:.3e} km)"
        )


class BatchLeastSquares:
    def __init__(self, prop, solver: str = BLSSolver.NormalEquations, max_iterations: int = 10,
                 tolerance_pos_km: float = 1e-4, lm_lambda_init: float = 1e-3, almanac=None, *,
                 device="cuda"):
        self.prop = prop
        self.solver = solver
        self.max_iterations = max_iterations
        self.tolerance_pos_km = tolerance_pos_km
        self.lm_lambda_init = lm_lambda_init
        self.almanac = almanac
        self.device = torch.device(device)
        self._h_cache = {}

    def _h_fns(self, device, types):
        """(h, jac) of the one-way observation [m] and its partials [m, 9]
        as functions of (t_tdb [1], y9 [9])."""
        key = (id(device), types)
        if key not in self._h_cache:
            h_rv = device.measurement_fn(types)

            def h(t, y9):
                return h_rv(t, y9[None, 0:6])[0]

            self._h_cache[key] = (h, torch.func.jacfwd(h, argnums=1))
        return self._h_cache[key]

    def estimate(self, initial_guess, arc: TrackingDataArc, devices: Sequence) -> BLSSolution:
        dev_map = {d.name: d for d in devices}
        f64 = dict(dtype=torch.float64, device=self.device)
        guess = initial_guess
        lam = self.lm_lambda_init
        prev_rms = np.inf
        converged = False
        it = 0
        corr_pos = np.nan
        rms = np.nan
        htwh = np.zeros((EST_DIM, EST_DIM))

        for it in range(1, self.max_iterations + 1):
            # the reference and its STM through the arc, accumulating
            # Phi(t_i, t0) and the partials mapped to t0
            instance = self.prop.with_state(guess.with_stm(), self.almanac, device=self.device)
            phi0 = np.eye(STATE_DIM)
            htwh = np.zeros((EST_DIM, EST_DIM))
            htwy = np.zeros(EST_DIM)
            sq_sum = 0.0
            m_count = 0
            for i in range(len(arc)):
                msr = arc.measurement(i)
                device = dev_map.get(msr.tracker)
                if device is None:
                    continue
                dt = (msr.epoch - instance.state.epoch).to_seconds()
                if abs(dt) > 1e-9:
                    instance.state.stm = np.eye(STATE_DIM)
                    nominal = instance.for_duration(dt)
                    phi0 = nominal.stm @ phi0
                else:
                    nominal = instance.state
                types = tuple(t for t in device.measurement_types if t in msr.data)
                if not types:
                    continue
                h_fn, jac_fn = self._h_fns(device, types)
                t_tdb = torch.tensor([msr.epoch.to_tdb_seconds()], **f64)
                y9 = torch.as_tensor(nominal.to_vector(), **f64)
                both = torch.cat([h_fn(t_tdb, y9)[:, None], jac_fn(t_tdb, y9)], dim=1).cpu().numpy()
                computed, h_tilde = both[:, 0], both[:, 1:]
                dy = msr.observation(types) - computed
                h0 = (h_tilde @ phi0)[:, :EST_DIM]  # partials with respect to x(t0)
                w = np.diag(1.0 / np.maximum(np.diag(device.measurement_covar(types)), 1e-32))
                htwh += h0.T @ w @ h0
                htwy += h0.T @ w @ dy
                sq_sum += float(dy @ w @ dy)
                m_count += len(types)

            rms = np.sqrt(sq_sum / max(m_count, 1))
            a = htwh.copy()
            if self.solver == BLSSolver.LevenbergMarquardt:
                lam = lam * 10.0 if rms > prev_rms else max(lam / 10.0, 1e-12)
                a += lam * np.diag(np.diag(htwh))
            try:
                dx0 = np.linalg.solve(a, htwy)
            except np.linalg.LinAlgError:
                dx0 = np.linalg.pinv(a) @ htwy
            corr_pos = float(np.linalg.norm(dx0[:3]))

            vec = guess.to_vector()
            vec[:EST_DIM] += dx0
            guess = guess.set_vector(guess.epoch, vec)
            prev_rms = rms
            if corr_pos < self.tolerance_pos_km:
                converged = True
                break

        try:
            cov6 = np.linalg.inv(htwh)
        except np.linalg.LinAlgError:
            cov6 = np.linalg.pinv(htwh)
        cov = np.zeros((STATE_DIM, STATE_DIM))
        cov[:EST_DIM, :EST_DIM] = cov6
        return BLSSolution(estimated_state=guess, covariance=cov, num_iterations=it,
                           final_rms=float(rms), final_corr_pos_km=corr_pos, converged=converged)
