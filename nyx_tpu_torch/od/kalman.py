"""State-noise compensation and the sequential Kalman filter.

Port of nyx_tpu/od/kalman.py:30-242 (the reference's od/kalman/ and
od/snc.rs): `KalmanVariant` (EKF or CKF); `ProcessNoise`, a diagonal
acceleration PSD, optionally decaying and in a local frame, gated by the
time since the last measurement, with chronological switchover by start
epoch, whose host form `q_matrix` gives the 9x9 noise of one gap
(`ScanKalmanOD._snc_q` evaluates the same for every row on the device);
and `KalmanFilter`, the filter of the OD host loop (`od/process.py`):
time updates P = Phi P Phi^T + Q, measurement updates with the whitened
residual ratio |L^-1 r| / sqrt(m) against a sigma gate, the gain
K = P H^T S^-1 and the Joseph-form covariance, and the EKF's fold of the
deviation into the reference.

The filter keeps its deviation and covariance as float64 tensors on its
device. A measurement update computes the gated and the updated estimates
there without a host sync, and brings the results to the host in one
transfer, where the gate picks one; the estimates it returns
(`KfEstimate`, `Residual`) are host numpy, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..cosmic.orbit import ric_dcm, vnc_dcm
from .estimate import KfEstimate, Residual

STATE_DIM = 9


class KalmanVariant:
    """EKF or CKF."""

    ReferenceUpdate = "ekf"  # fold each update into the reference trajectory
    DeviationTracking = "ckf"  # track the deviation only


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

    def q_matrix(self, dt_s: float, nominal=None, elapsed_s: float = 0.0) -> np.ndarray:
        """The 9x9 integrated process noise Gamma q Gamma^T over a gap of
        `dt_s`, `elapsed_s` after the SNC's anchor (host numpy); zero for a
        gap of 0 or longer than the disable time. `nominal` (a Spacecraft)
        orients a local frame."""
        q = np.zeros((STATE_DIM, STATE_DIM))
        if dt_s <= 0.0 or dt_s > self.disable_time_s:
            return q
        qd = np.asarray(self.q_diag_km2_s4, dtype=np.float64).copy()
        if self.decay_tau_s is not None:
            qd = qd * np.exp(-elapsed_s / np.asarray(self.decay_tau_s, dtype=np.float64))
        q3 = np.diag(qd)
        if self.local_frame is not None and nominal is not None:
            r, v = (torch.tensor(np.asarray(x, dtype=np.float64))
                    for x in (nominal.orbit.r_km, nominal.orbit.v_km_s))
            dcm = (ric_dcm(r, v) if self.local_frame.lower() == "ric" else vnc_dcm(r, v)).numpy()
            q3 = dcm.T @ q3 @ dcm
        q[0:3, 0:3] = q3 * dt_s**4 / 4.0
        q[0:3, 3:6] = q3 * dt_s**3 / 2.0
        q[3:6, 0:3] = q3 * dt_s**3 / 2.0
        q[3:6, 3:6] = q3 * dt_s**2
        return q


#: the reference's alias (a 3-axis acceleration SNC)
ProcessNoise3D = ProcessNoise


class KalmanFilter:
    """The sequential filter: the previous estimate, the SNC models and the
    variant, its deviation and covariance kept on `device`."""

    def __init__(self, prev_estimate: KfEstimate, process_noise: Sequence[ProcessNoise] = (),
                 variant: str = KalmanVariant.ReferenceUpdate, *, device="cuda"):
        if isinstance(process_noise, ProcessNoise):
            process_noise = (process_noise,)
        self.process_noise = tuple(process_noise)
        self.variant = variant
        self.device = torch.device(device)
        self._f64 = dict(dtype=torch.float64, device=self.device)
        self.prev_estimate = prev_estimate
        self._dx = torch.as_tensor(np.asarray(prev_estimate.state_deviation), **self._f64)
        self._p = torch.as_tensor(np.asarray(prev_estimate.covar), **self._f64)
        # the epoch at which SNC was first exercised, which anchors its decay
        self._snc_init_tai_s = None
        #: the gain [9, m] of the latest accepted measurement update (None
        #: after a rejection or before any update)
        self.last_gain = None

    def _snc_q(self, epoch_tai_s, dt_s, nominal) -> np.ndarray:
        """The 9x9 process noise of the gap ending at `epoch_tai_s`: the
        last SNC whose start epoch has passed, decaying from its start (or
        from the filter's first SNC epoch)."""
        active = None
        for snc in self.process_noise:
            if snc.start_epoch_tai_s is None or snc.start_epoch_tai_s <= epoch_tai_s:
                active = snc
        if active is None:
            return np.zeros((STATE_DIM, STATE_DIM))
        if self._snc_init_tai_s is None:
            self._snc_init_tai_s = epoch_tai_s
        anchor = (active.start_epoch_tai_s if active.start_epoch_tai_s is not None
                  else self._snc_init_tai_s)
        return active.q_matrix(dt_s, nominal, elapsed_s=max(0.0, epoch_tai_s - anchor))

    def _predict(self, nominal, stm, dt_s):
        """(Phi dx, Phi P Phi^T + Q, Phi) on the device."""
        phi = torch.as_tensor(np.asarray(stm, dtype=np.float64), **self._f64)
        q = torch.as_tensor(self._snc_q(nominal.epoch.to_tai_seconds(), dt_s, nominal), **self._f64)
        return phi @ self._dx, phi @ self._p @ phi.T + q, phi

    def time_update(self, nominal, stm, dt_s: float) -> KfEstimate:
        """Covariance mapping over one gap: P = Phi P Phi^T + Q."""
        dx_bar, p_bar, _ = self._predict(nominal, stm, dt_s)
        self._dx, self._p = dx_bar, p_bar
        host = torch.cat([dx_bar, p_bar.reshape(-1)]).cpu().numpy()
        p = host[STATE_DIM:].reshape(STATE_DIM, STATE_DIM)
        est = KfEstimate(nominal=nominal, state_deviation=host[:STATE_DIM], covar=p,
                         covar_bar=p.copy(), stm=np.asarray(stm, dtype=np.float64).copy(),
                         predicted=True)
        self.prev_estimate = est
        return est

    def measurement_update(self, nominal, real_obs, computed_obs, r_matrix, h_tilde, stm,
                           dt_s: float, resid_rejection_sigmas: Optional[float] = 3.0,
                           tracker: str = "", msr_types: tuple = ()):
        """(estimate, residual) of one measurement: the time update over the
        gap, the residual ratio, and unless the gate rejects it the gain,
        the update and the Joseph-form covariance. `real_obs`,
        `computed_obs` [m] and `h_tilde` [m, 9] may be tensors or arrays."""
        f64 = self._f64
        dx_bar, p_bar, _ = self._predict(nominal, stm, dt_s)
        h = torch.as_tensor(h_tilde, **f64).reshape(-1, STATE_DIM)
        m = h.shape[0]
        real = torch.as_tensor(real_obs, **f64).reshape(m)
        comp = torch.as_tensor(computed_obs, **f64).reshape(m)
        r_mat = torch.as_tensor(np.asarray(r_matrix, dtype=np.float64), **f64)
        prefit = real - comp - h @ dx_bar

        def update(k_gain):
            """(the updated deviation, the postfit, the Joseph-form covariance)."""
            dx_hat = dx_bar + k_gain @ prefit
            ikh = torch.eye(STATE_DIM, **f64) - k_gain @ h
            p_hat = ikh @ p_bar @ ikh.T + k_gain @ r_mat @ k_gain.T
            return dx_hat, real - comp - h @ dx_hat, 0.5 * (p_hat + p_hat.T)

        # one solve of S [w, K^T] = [r, H P^T]: the residual ratio
        # |L^-1 r| / sqrt(m) = sqrt(r^T S^-1 r / m), L the Cholesky factor
        # of S (an S that is not positive definite falls back to R alone),
        # and the gain K = P H^T S^-1
        s_mat = h @ p_bar @ h.T + r_mat
        sol, s_info = torch.linalg.solve_ex(s_mat, torch.cat([prefit[:, None], h @ p_bar.T], dim=1))
        quad = torch.dot(prefit, sol[:, 0])
        r_only = torch.sum(prefit**2 / torch.clamp(torch.diagonal(r_mat), min=1e-32))
        pd = (s_info == 0) & (quad > 0.0) & torch.isfinite(quad)
        ratio = torch.sqrt(torch.where(pd, quad, r_only) / m)
        k_gain = sol[:, 1:].T
        dx_hat, postfit, p_hat = update(k_gain)

        parts = [ratio[None], s_info[None].to(torch.float64), dx_bar, p_bar.reshape(-1), dx_hat,
                 p_hat.reshape(-1), k_gain.reshape(-1), prefit, postfit, real, comp]
        host = torch.cat(parts).cpu().numpy()
        sizes = [1, 1, STATE_DIM, STATE_DIM**2, STATE_DIM, STATE_DIM**2, STATE_DIM * m, m, m, m, m]
        (ratio_h, s_info_h, dx_bar_h, p_bar_h, dx_hat_h, p_hat_h, k_h, prefit_h, postfit_h,
         real_h, comp_h) = np.split(host, np.cumsum(sizes)[:-1])
        ratio_h = float(ratio_h[0])
        p_bar_h = p_bar_h.reshape(STATE_DIM, STATE_DIM)
        stm_h = np.asarray(stm, dtype=np.float64).copy()
        epoch = nominal.epoch

        if resid_rejection_sigmas is not None and ratio_h > resid_rejection_sigmas:
            # rejected: the time update alone
            self._dx, self._p = dx_bar, p_bar
            est = KfEstimate(nominal=nominal, state_deviation=dx_bar_h, covar=p_bar_h,
                             covar_bar=p_bar_h.copy(), stm=stm_h, predicted=True)
            self.prev_estimate = est
            self.last_gain = None
            resid = Residual(epoch, tracker, msr_types, prefit_h, prefit_h.copy(), ratio_h, True,
                             real_obs=real_h, computed_obs=comp_h)
            return est, resid

        if s_info_h[0] != 0:
            # singular S: the pseudo-inverse gain
            k_gain = p_bar @ h.T @ torch.linalg.pinv(s_mat)
            dx_hat, postfit, p_hat = update(k_gain)
            dx_hat_h, p_hat_h, k_h, postfit_h = (x.cpu().numpy().reshape(-1)
                                                 for x in (dx_hat, p_hat, k_gain, postfit))
        p_hat_h = p_hat_h.reshape(STATE_DIM, STATE_DIM)
        est = KfEstimate(nominal=nominal, state_deviation=dx_hat_h, covar=p_hat_h,
                         covar_bar=p_bar_h, stm=stm_h, predicted=False)
        self._p = p_hat
        if self.variant == KalmanVariant.ReferenceUpdate:
            # EKF: fold the deviation into the reference
            est.nominal = est.state()
            est.state_deviation = np.zeros(STATE_DIM)
            self._dx = torch.zeros(STATE_DIM, **f64)
        else:
            self._dx = dx_hat
        self.prev_estimate = est
        self.last_gain = k_h.reshape(STATE_DIM, m).copy()
        resid = Residual(epoch, tracker, msr_types, prefit_h, postfit_h, ratio_h, False,
                         real_obs=real_h, computed_obs=comp_h)
        return est, resid
