"""Hyperbolic B-plane: B.R, B.T, linearized time of flight, and targeting.

Torch port of nyx_tpu/cosmic/bplane.py (the reference's BPlane,
cosmic/bplane.rs:40-150, and try_achieve_b_plane, :328). `bplane_from_rv`
is a batched function with no host sync, in-place write or branch on a
value, so `BPlane.from_orbit` takes its Jacobian with one
`torch.func.jacfwd`, where the reference takes `jax.jacfwd`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.linalg import vector_norm

from ..errors import StateError, TargetingError
from .orbit import Orbit

__all__ = ["bplane_from_rv", "BPlane", "BPlaneTarget", "try_achieve_b_plane"]


def bplane_from_rv(r, v, mu: float):
    """(b_r_km, b_t_km, ltof_s, str_dcm [..., 3, 3]) of hyperbolic states
    r, v [..., 3] (bplane.rs:57-137): S along the incoming asymptote,
    T = S x K, R = S x T, B = b (sqrt(1 - 1/e^2) e_hat - n_hat / e) with b
    the semi-minor axis."""
    rmag = vector_norm(r, dim=-1)
    vmag = vector_norm(v, dim=-1)
    h = torch.linalg.cross(r, v, dim=-1)
    hmag = vector_norm(h, dim=-1)
    rdotv = torch.sum(r * v, dim=-1)
    e_vec = ((vmag**2 - mu / rmag)[..., None] * r - rdotv[..., None] * v) / mu
    ecc = vector_norm(e_vec, dim=-1)
    e_hat = e_vec / ecc[..., None]
    h_hat = h / hmag[..., None]
    n_hat = torch.linalg.cross(h_hat, e_hat, dim=-1)

    fact = torch.sqrt(1.0 - (1.0 / ecc) ** 2)  # incoming asymptote factor
    s = e_hat / ecc[..., None] + fact[..., None] * n_hat
    s_hat = s / vector_norm(s, dim=-1, keepdim=True)

    energy = vmag**2 / 2.0 - mu / rmag
    sma = -mu / (2.0 * energy)  # < 0 for hyperbolic
    semi_minor = torch.abs(sma) * torch.sqrt(ecc**2 - 1.0)
    b_vec = semi_minor[..., None] * (fact[..., None] * e_hat - n_hat / ecc[..., None])

    zero = torch.zeros_like(s_hat[..., 0])
    k_hat = torch.stack([zero, zero, torch.ones_like(zero)], dim=-1)
    t = torch.linalg.cross(s_hat, k_hat, dim=-1)
    t_hat = t / vector_norm(t, dim=-1, keepdim=True)
    r_hat = torch.linalg.cross(s_hat, t_hat, dim=-1)

    b_r = torch.sum(b_vec * r_hat, dim=-1)
    b_t = torch.sum(b_vec * t_hat, dim=-1)
    ltof = torch.sum(b_vec * s_hat, dim=-1) / vmag
    str_dcm = torch.stack([s_hat, t_hat, r_hat], dim=-2)
    return b_r, b_t, ltof, str_dcm


@dataclass
class BPlane:
    """Host-facing B-plane values and Jacobians (bplane.rs:40-54)."""

    b_r_km: float
    b_t_km: float
    ltof_s: float
    str_dcm: np.ndarray  # inertial -> B-plane rows (S, T, R)
    jacobian_rv: np.ndarray  # d(b_r, b_t, ltof)/d[r, v]  [3, 6]
    epoch: object = None
    frame: object = None

    @classmethod
    def from_orbit(cls, orbit: Orbit) -> "BPlane":
        if orbit.ecc <= 1.0:
            raise StateError(f"B-plane requires a hyperbolic orbit, ecc = {orbit.ecc:.6f}")
        mu = orbit.frame.mu
        rv = torch.from_numpy(np.concatenate([orbit.r_km, orbit.v_km_s]).astype(np.float64))

        def f(rv6):
            b_r, b_t, ltof, _ = bplane_from_rv(rv6[0:3], rv6[3:6], mu)
            return torch.stack([b_r, b_t, ltof])

        vals = f(rv).numpy()
        jac = torch.func.jacfwd(f)(rv).numpy()
        dcm = bplane_from_rv(rv[0:3], rv[3:6], mu)[3].numpy()
        return cls(b_r_km=float(vals[0]), b_t_km=float(vals[1]), ltof_s=float(vals[2]),
                   str_dcm=dcm, jacobian_rv=jac, epoch=orbit.epoch, frame=orbit.frame)

    def jacobian(self) -> np.ndarray:
        """d(BR, BT, LTOF)/d(vx, vy, vz) (bplane.rs:150-166)."""
        return self.jacobian_rv[:, 3:6]

    @property
    def b_mag_km(self) -> float:
        return float(np.hypot(self.b_r_km, self.b_t_km))

    @property
    def theta_deg(self) -> float:
        """B-plane angle from T (clock angle)."""
        return float(np.degrees(np.arctan2(self.b_r_km, self.b_t_km)))

    def __str__(self):
        return f"BPlane: B.R = {self.b_r_km:.3f} km, B.T = {self.b_t_km:.3f} km, LTOF = {self.ltof_s:.3f} s"


@dataclass
class BPlaneTarget:
    """Desired B-plane (bplane.rs BPlaneTarget): BR/BT (km) and tolerances."""

    b_r_km: float
    b_t_km: float
    tol_b_r_km: float = 1e-3
    tol_b_t_km: float = 1e-3

    @classmethod
    def from_bt_br(cls, b_t_km, b_r_km) -> "BPlaneTarget":
        return cls(b_r_km=b_r_km, b_t_km=b_t_km)


def try_achieve_b_plane(orbit: Orbit, target: BPlaneTarget, max_iter: int = 25):
    """Newton iteration on the velocity to hit a desired (BR, BT) at the
    orbit's epoch (bplane.rs:328-420). Returns (delta_v [3] km/s, BPlane)."""
    v = np.asarray(orbit.v_km_s, dtype=np.float64).copy()
    total_dv = np.zeros(3)
    for _ in range(max_iter):
        bp = BPlane.from_orbit(Orbit(orbit.r_km.copy(), v, orbit.epoch, orbit.frame))
        err = np.array([target.b_r_km - bp.b_r_km, target.b_t_km - bp.b_t_km])
        if abs(err[0]) < target.tol_b_r_km and abs(err[1]) < target.tol_b_t_km:
            return total_dv, bp
        dv = np.linalg.pinv(bp.jacobian()[0:2, :]) @ err  # d(BR, BT)/dv [2, 3]
        v = v + dv
        total_dv = total_dv + dv
    raise TargetingError(f"B-plane targeting did not converge in {max_iter} iterations; residual {err}")
