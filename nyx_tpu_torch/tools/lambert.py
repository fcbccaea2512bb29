"""Lambert's problem: Izzo's algorithm (Revisiting Lambert's problem, 2015).

Torch port of nyx_tpu/tools/lambert.py:23-348 (the reference's
tools/lambert/, mod.rs:41-170, izzo.rs:44, godding.rs:44). The core solver
`lambert_izzo_rv` runs over batched tensors, branchless and with fixed
iteration counts, so a whole porkchop grid is one device solve with no host
sync; `izzo` calls it on one transfer on the host in float64, and `gooding`
is the reference's universal-variable bisection in numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.linalg import vector_norm

from ..cosmic.orbit import Orbit
from ..errors import LambertError

TAU = 2.0 * np.pi


class TransferKind:
    """Direction of motion selection (tools/lambert/mod.rs:41-82).

    `n_revs(M)` requests an M-revolution transfer — the reference declares
    TransferKind::NRevs but returns MultiRevNotSupported; here the Izzo
    solver actually handles it (left/right branch selectable)."""

    Auto = "auto"
    ShortWay = "short"
    LongWay = "long"

    @staticmethod
    def n_revs(m: int) -> tuple:
        return ("nrevs", int(m))


@dataclass
class LambertInput:
    """Departure/arrival states; TOF = difference of their epochs
    (mod.rs:85-120)."""

    initial_state: Orbit
    final_state: Orbit

    @classmethod
    def from_planetary_states(cls, initial_state, final_state) -> "LambertInput":
        if initial_state.frame.center != final_state.frame.center:
            raise LambertError("Lambert requires both states in the same frame")
        return cls(initial_state, final_state)

    @property
    def mu_km3_s2(self) -> float:
        return self.initial_state.frame.mu

    @property
    def tof_s(self) -> float:
        return (self.final_state.epoch - self.initial_state.epoch).to_seconds()


@dataclass
class LambertSolution:
    """(mod.rs:124-170)."""

    v_init_km_s: np.ndarray
    v_final_km_s: np.ndarray
    phi_rad: float
    input: LambertInput

    def v_inf_outgoing_km_s(self) -> np.ndarray:
        return self.input.initial_state.v_km_s - self.v_init_km_s

    def v_inf_incoming_km_s(self) -> np.ndarray:
        return self.input.final_state.v_km_s - self.v_final_km_s

    def transfer_orbit(self) -> Orbit:
        s = self.input.initial_state
        return Orbit(s.r_km.copy(), self.v_init_km_s.copy(), s.epoch, s.frame)

    def arrival_orbit(self) -> Orbit:
        s = self.input.final_state
        return Orbit(s.r_km.copy(), self.v_final_km_s.copy(), s.epoch, s.frame)

    def c3_km2_s2(self) -> float:
        return float(np.sum(self.v_inf_outgoing_km_s() ** 2))

    def v_inf_outgoing_declination_deg(self) -> float:
        v = -self.v_inf_outgoing_km_s()
        return float(np.degrees(np.arcsin(v[2] / np.linalg.norm(v))))

    def v_inf_outgoing_right_ascension_deg(self) -> float:
        v = -self.v_inf_outgoing_km_s()
        return float(np.degrees(np.arctan2(v[1], v[0])))


def _tof_curve(x, lam, n_rev: float = 0.0):
    """Non-dimensional time of flight T(x) (Izzo eq. 18-22) for elliptic
    (|x| < 1) and hyperbolic (x > 1) arcs: both branches are evaluated on
    clipped domains and one is picked, so neither branch's NaN reaches a
    cell that takes the other."""
    y = torch.sqrt(1.0 - lam**2 * (1.0 - x**2))
    battin_small = torch.abs(1.0 - x) < 1e-10
    # elliptic branch
    x_e = torch.clamp(x, -0.999999999999, 0.999999999999)
    y_e = torch.sqrt(1.0 - lam**2 * (1.0 - x_e**2))
    psi_e = torch.arccos(torch.clamp(x_e * y_e + lam * (1.0 - x_e**2), -1.0, 1.0))
    t_e = (psi_e + n_rev * math.pi) / torch.sqrt(torch.abs(1.0 - x_e**2)) - x_e + lam * y_e
    t_e = t_e / (1.0 - x_e**2)
    # hyperbolic branch
    x_h = torch.clamp(x, min=1.000000000001)
    y_h = torch.sqrt(1.0 - lam**2 * (1.0 - x_h**2))
    arg = x_h * y_h - lam * (x_h**2 - 1.0)
    psi_h = torch.arccosh(torch.clamp(arg, min=1.0))
    t_h = (-psi_h / torch.sqrt(torch.abs(1.0 - x_h**2)) - x_h + lam * y_h) / (1.0 - x_h**2)
    t = torch.where(x < 1.0, t_e, t_h)
    # parabolic limit (Battin's series around x = 1): 2F1(3, 1, 5/2, s1)
    # truncated after 12 terms
    eta = y - lam * x
    s1 = 0.5 * (1.0 - lam - x * eta)
    q = torch.ones_like(x)
    f = torch.ones_like(x)
    for k in range(12):
        q = q * s1 * (3.0 + k) * (1.0 + k) / ((2.5 + k) * (k + 1.0))
        f = f + q
    t_b = (eta**3 * f + 4.0 * lam * eta) / 2.0
    return torch.where(battin_small, t_b, t)


def lambert_izzo_rv(r1, r2, tof_s, mu: float, long_way=False, iters: int = 20, n_rev: int = 0,
                    branch: str = "right"):
    """Lambert by Izzo's Householder iterations over batched tensors: r1, r2
    [..., 3] km, tof_s [...] s, `long_way` a bool or a bool tensor [...].
    A fixed `iters` iterations with no early exit, so a grid of any size
    runs with no host sync. `n_rev > 0` solves the multi-revolution problem
    (`branch` "left": the larger semi-major axis, "right": the smaller;
    Izzo 2015 eq. 31's initial guesses).

    Returns (v1 [..., 3], v2 [..., 3]) km/s."""
    r1 = torch.as_tensor(r1, dtype=torch.float64)
    r2 = torch.as_tensor(r2, dtype=torch.float64, device=r1.device)
    tof_s = torch.as_tensor(tof_s, dtype=torch.float64, device=r1.device)
    c = vector_norm(r2 - r1, dim=-1)
    r1n = vector_norm(r1, dim=-1)
    r2n = vector_norm(r2, dim=-1)
    s = 0.5 * (r1n + r2n + c)

    ir1 = r1 / r1n[..., None]
    ir2 = r2 / r2n[..., None]
    ih = torch.linalg.cross(ir1, ir2, dim=-1)
    ih = ih / vector_norm(ih, dim=-1, keepdim=True)

    lam2 = 1.0 - c / s
    if isinstance(long_way, torch.Tensor):
        sign = 1.0 - 2.0 * long_way.to(device=r1.device, dtype=torch.float64)
    else:
        sign = -1.0 if long_way else 1.0
    lam = torch.sqrt(lam2) * sign
    sign3 = sign[..., None] if isinstance(sign, torch.Tensor) else sign
    it1 = sign3 * torch.linalg.cross(ih, ir1, dim=-1)
    it2 = sign3 * torch.linalg.cross(ih, ir2, dim=-1)

    t = torch.sqrt(2.0 * mu / s**3) * tof_s
    if n_rev == 0:
        # initial guess (Izzo eq. 30)
        t0 = torch.arccos(torch.clamp(lam, -1.0, 1.0)) + lam * torch.sqrt(1.0 - lam2)
        t1 = 2.0 / 3.0 * (1.0 - lam**3)
        x0 = torch.where(
            t >= t0,
            (t0 / t) ** (2.0 / 3.0) - 1.0,
            torch.where(t < t1, 5.0 / 2.0 * t1 * (t1 - t) / (t * (1.0 - lam**5)) + 1.0,
                        (t0 / t) ** torch.log2(t1 / t0) - 1.0),
        )
    else:
        m_pi = n_rev * math.pi
        if branch == "left":
            term = ((m_pi + math.pi) / (8.0 * t)) ** (2.0 / 3.0)
        else:
            term = ((8.0 * t) / m_pi) ** (2.0 / 3.0)
        x0 = (term - 1.0) / (term + 1.0)

    # Householder third-order iterations (Izzo's algorithm 2)
    x = x0
    for _ in range(iters):
        tx = _tof_curve(x, lam, float(n_rev))
        y = torch.sqrt(1.0 - lam2 * (1.0 - x**2))
        umx2 = 1.0 - x**2
        dt = (3.0 * tx * x - 2.0 + 2.0 * lam**3 * x / y) / umx2
        ddt = (3.0 * tx + 5.0 * x * dt + 2.0 * (1.0 - lam2) * lam**3 / y**3) / umx2
        dddt = (7.0 * x * ddt + 8.0 * dt - 6.0 * (1.0 - lam2) * lam2 * lam**3 * x / y**5) / umx2
        delta = tx - t
        dt2 = dt**2
        x_new = x - delta * (dt2 - delta * ddt / 2.0) / (dt * (dt2 - delta * ddt) + dddt * delta**2 / 6.0)
        x = torch.where(torch.isfinite(x_new), x_new, x)

    y = torch.sqrt(1.0 - lam2 * (1.0 - x**2))
    gamma = torch.sqrt(mu * s / 2.0)
    rho = (r1n - r2n) / c
    sigma = torch.sqrt(torch.clamp(1.0 - rho**2, min=0.0))

    vr1 = gamma * ((lam * y - x) - rho * (lam * y + x)) / r1n
    vr2 = -gamma * ((lam * y - x) + rho * (lam * y + x)) / r2n
    vt1 = gamma * sigma * (y + lam * x) / r1n
    vt2 = gamma * sigma * (y + lam * x) / r2n
    v1 = vr1[..., None] * ir1 + vt1[..., None] * it1
    v2 = vr2[..., None] * ir2 + vt2[..., None] * it2
    return v1, v2


def _resolve_long_way(input: LambertInput, kind: str) -> bool:
    if kind == TransferKind.ShortWay:
        return False
    if kind == TransferKind.LongWay:
        return True
    # Auto: prograde transfer (mod.rs:64-77)
    r1, r2 = input.initial_state.r_km, input.final_state.r_km
    dnu = np.arctan2(r2[1], r2[0]) - np.arctan2(r1[1], r1[0])
    if dnu < 0.0:
        dnu += TAU
    return dnu > np.pi


def izzo(input: LambertInput, kind=TransferKind.Auto,
         branch: str = "right") -> LambertSolution:
    """Solve with Izzo's method (tools/lambert/izzo.rs:44). `kind` may be
    TransferKind.n_revs(M) for multi-revolution transfers (which the
    reference declares but does not solve); `branch` picks the left
    (larger-sma) or right (smaller-sma) multi-rev solution."""
    n_rev = 0
    if isinstance(kind, tuple) and kind and kind[0] == "nrevs":
        n_rev = int(kind[1])
        kind = TransferKind.Auto
    long_way = _resolve_long_way(input, kind)
    v1, v2 = lambert_izzo_rv(
        torch.from_numpy(np.asarray(input.initial_state.r_km, np.float64)),
        torch.from_numpy(np.asarray(input.final_state.r_km, np.float64)),
        input.tof_s,
        input.mu_km3_s2,
        long_way=long_way,
        n_rev=n_rev,
        branch=branch,
    )
    v1, v2 = v1.numpy(), v2.numpy()
    if not (np.all(np.isfinite(v1)) and np.all(np.isfinite(v2))):
        raise LambertError(
            f"Lambert did not converge (tof may be below the {n_rev}-rev "
            "minimum)"
        )
    if n_rev > 0:
        # reject converged-to-garbage roots: the transfer must actually
        # take tof
        sol = LambertSolution(v1, v2, 0.0, input)
        sma = sol.transfer_orbit().sma_km
        if sma <= 0.0:
            raise LambertError("multi-rev Lambert has no elliptic solution")
        period = TAU * np.sqrt(sma**3 / input.mu_km3_s2)
        # the transfer is n_rev full revolutions plus a partial arc
        if not (n_rev * period < input.tof_s < (n_rev + 1) * period * 1.001):
            raise LambertError(
                f"no {n_rev}-rev solution for tof {input.tof_s:.1f} s "
                f"(period {period:.1f} s)"
            )
    # turn angle between the radius vectors
    r1, r2 = input.initial_state.r_km, input.final_state.r_km
    cosphi = float(
        np.dot(r1, r2) / (np.linalg.norm(r1) * np.linalg.norm(r2))
    )
    phi = float(np.arccos(np.clip(cosphi, -1.0, 1.0)))
    if long_way:
        phi = TAU - phi
    return LambertSolution(v1, v2, phi + n_rev * TAU, input)


def gooding(input: LambertInput, kind=TransferKind.Auto) -> LambertSolution:
    """Solve with the universal-variable bisection the reference ships as
    Gooding's method (tools/lambert/godding.rs:44): bisect on phi (the
    squared eccentric-anomaly difference) with Stumpff-function c2/c3
    updates until the universal-variable time of flight matches, then
    recover velocities through the f/g functions. Zero-rev only, exactly
    as the reference (multi-rev raises; use izzo with
    TransferKind.n_revs)."""
    if isinstance(kind, tuple) and kind and kind[0] == "nrevs":
        raise LambertError(
            "gooding does not support multi-rev transfers; use "
            "izzo(kind=TransferKind.n_revs(M))"
        )
    r1 = np.asarray(input.initial_state.r_km, dtype=np.float64)
    r2 = np.asarray(input.final_state.r_km, dtype=np.float64)
    tof_s = input.tof_s
    mu = input.mu_km3_s2
    r1n, r2n = np.linalg.norm(r1), np.linalg.norm(r2)
    cos_dnu = float(np.dot(r1, r2)) / (r1n * r2n)
    dm = -1.0 if _resolve_long_way(input, kind) else 1.0
    a_coef = dm * np.sqrt(r1n * r2n * (1.0 + cos_dnu))
    if abs(a_coef) < 1e-12:
        raise LambertError("Lambert targets are too close (180 deg transfer)")

    phi_hi, phi_lo, phi = 4.0 * np.pi**2, -4.0 * np.pi**2, 0.0
    c2, c3 = 0.5, 1.0 / 6.0
    cur_tof, y = 0.0, 0.0
    for _ in range(1000):
        y = r1n + r2n + a_coef * (phi * c3 - 1.0) / np.sqrt(c2)
        if a_coef > 0.0 and y < 0.0:
            for _ in range(500):
                phi += 0.1
                y = r1n + r2n + a_coef * (phi * c3 - 1.0) / np.sqrt(c2)
                if y >= 0.0:
                    break
            if y < 0.0:
                raise LambertError("could not find a reasonable phi")
        chi = np.sqrt(y / c2)
        cur_tof = (chi**3 * c3 + a_coef * np.sqrt(y)) / np.sqrt(mu)
        if abs(cur_tof - tof_s) < 1e-6:
            break
        if cur_tof < tof_s:
            phi_lo = phi
        else:
            phi_hi = phi
        phi = 0.5 * (phi_hi + phi_lo)
        if phi > 1e-12:
            sp = np.sqrt(phi)
            c2 = (1.0 - np.cos(sp)) / phi
            c3 = (sp - np.sin(sp)) / sp**3
        elif phi < -1e-12:
            sp = np.sqrt(-phi)
            c2 = (1.0 - np.cosh(sp)) / phi
            c3 = (np.sinh(sp) - sp) / sp**3
        else:
            c2, c3 = 0.5, 1.0 / 6.0
    else:
        raise LambertError("Lambert (gooding) exceeded the iteration limit")

    f = 1.0 - y / r1n
    g_dot = 1.0 - y / r2n
    g = a_coef * np.sqrt(y / mu)
    v1 = (r2 - f * r1) / g
    v2 = (g_dot * r2 - r1) / g
    return LambertSolution(v1, v2, phi, input)
