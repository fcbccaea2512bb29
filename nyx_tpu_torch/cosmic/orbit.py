"""Orbital state and Keplerian elements (torch port of nyx_tpu/cosmic/orbit.py).

Element conversions are batched functions over trailing-dimension tensors,
differentiable with `torch.func`; the host `Orbit` class builds a scalar
state from elements in float64 on the CPU and reads its elements back
(`rmag_km` through `fpa_deg`, `value`) the same way. The RIC, VNC and RCN
local frames and the true -> eccentric -> mean anomaly conversions are
batched functions too. The inverse anomaly conversions and analytic
propagation (`Orbit.at_epoch`) are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..time import Epoch
from ..xmath import norm as _norm
from .frames import Frame

_TWO_PI = 2 * math.pi
_D2R = np.pi / 180.0
_EPS = 1e-12


def keplerian_from_cartesian(r, v, mu: float):
    """Osculating Keplerian elements from Cartesian state.

    r [..., 3] km, v [..., 3] km/s. Returns a dict with sma (km), ecc, inc,
    raan, aop, ta (radians in [0, 2pi)). Circular/equatorial singular cases
    resolve to 0 angles; angles come from atan2 so the map is smooth under
    forward-mode AD away from those cases.
    """
    rmag = _norm(r)
    vmag = _norm(v)
    h = torch.linalg.cross(r, v, dim=-1)
    hmag = _norm(h)
    n = torch.stack([-h[..., 1], h[..., 0], torch.zeros_like(hmag)], dim=-1)
    nmag = _norm(n)
    rdotv = torch.sum(r * v, dim=-1)
    e_vec = ((vmag**2 - mu / rmag)[..., None] * r - rdotv[..., None] * v) / mu
    ecc = _norm(e_vec)
    energy = vmag**2 / 2 - mu / rmag
    sma = -mu / (2 * energy)
    inc = torch.arccos(torch.clamp(h[..., 2] / hmag, -1.0, 1.0))

    circ = ecc < 1e-11
    equa = nmag < 1e-11

    h_unit = h / hmag[..., None]
    raan = torch.remainder(torch.atan2(n[..., 1], n[..., 0]), _TWO_PI)
    raan = torch.where(equa, 0.0, raan)

    ne = torch.sum(n * e_vec, dim=-1)
    sin_aop = torch.sum(torch.linalg.cross(n, e_vec, dim=-1) * h_unit, dim=-1)
    aop = torch.remainder(torch.atan2(sin_aop, ne), _TWO_PI)
    aop_eq = torch.remainder(torch.atan2(e_vec[..., 1], e_vec[..., 0]), _TWO_PI)
    aop = torch.where(equa, aop_eq, aop)
    aop = torch.where(circ, 0.0, aop)

    re = torch.sum(r * e_vec, dim=-1)
    sin_ta = torch.sum(torch.linalg.cross(e_vec, r, dim=-1) * h_unit, dim=-1)
    ta = torch.remainder(torch.atan2(sin_ta, re), _TWO_PI)
    ta_circ = torch.remainder(
        torch.atan2(
            torch.sum(torch.linalg.cross(n, r, dim=-1) * h_unit, dim=-1),
            torch.sum(n * r, dim=-1),
        ),
        _TWO_PI,
    )
    ta_circ_eq = torch.remainder(torch.atan2(r[..., 1], r[..., 0]), _TWO_PI)
    ta = torch.where(circ, torch.where(equa, ta_circ_eq, ta_circ), ta)
    return {"sma": sma, "ecc": ecc, "inc": inc, "raan": raan, "aop": aop, "ta": ta}


def cartesian_from_keplerian(sma, ecc, inc, raan, aop, ta, mu: float):
    """Cartesian (r [..., 3], v [..., 3]) from Keplerian elements (radians).

    Supports elliptic and hyperbolic orbits (sma < 0, ecc > 1).
    """
    p = sma * (1 - ecc**2)
    rmag = p / (1 + ecc * torch.cos(ta))
    cta, sta = torch.cos(ta), torch.sin(ta)
    r_pqw = torch.stack([rmag * cta, rmag * sta, torch.zeros_like(rmag)], dim=-1)
    f = torch.sqrt(mu / p)
    v_pqw = torch.stack([-f * sta, f * (ecc + cta), torch.zeros_like(rmag)], dim=-1)

    cr, sr = torch.cos(raan), torch.sin(raan)
    ci, si = torch.cos(inc), torch.sin(inc)
    cw, sw = torch.cos(aop), torch.sin(aop)
    row0 = torch.stack([cr * cw - sr * sw * ci, -cr * sw - sr * cw * ci, sr * si], dim=-1)
    row1 = torch.stack([sr * cw + cr * sw * ci, -sr * sw + cr * cw * ci, -cr * si], dim=-1)
    row2 = torch.stack([sw * si, cw * si, ci], dim=-1)
    dcm = torch.stack([row0, row1, row2], dim=-2)
    r = torch.einsum("...ij,...j->...i", dcm, r_pqw)
    v = torch.einsum("...ij,...j->...i", dcm, v_pqw)
    return r, v


def true_to_ecc_anomaly(ta, ecc):
    """True -> eccentric (elliptic) or hyperbolic anomaly, radians."""
    ell = torch.atan2(torch.sqrt(torch.clamp(1 - ecc**2, min=_EPS)) * torch.sin(ta),
                      ecc + torch.cos(ta))
    # hyperbolic: H = 2 atanh( sqrt((e-1)/(e+1)) tan(ta/2) )
    arg = torch.sqrt(torch.clamp((ecc - 1) / (ecc + 1), min=_EPS)) * torch.tan(ta / 2)
    hyp = 2 * torch.atanh(torch.clamp(arg, -1 + _EPS, 1 - _EPS))
    return torch.where(ecc < 1.0, ell, hyp)


def ecc_to_mean_anomaly(ea, ecc):
    """Eccentric (or hyperbolic) -> mean anomaly, radians."""
    ell = ea - ecc * torch.sin(ea)
    hyp = ecc * torch.sinh(ea) - ea
    return torch.where(ecc < 1.0, ell, hyp)


def ric_dcm(r, v):
    """DCM [..., 3, 3] from inertial to RIC (radial, in-track, cross-track)
    frame rows."""
    rhat = r / _norm(r, keepdim=True)
    h = torch.linalg.cross(r, v, dim=-1)
    chat = h / _norm(h, keepdim=True)
    ihat = torch.linalg.cross(chat, rhat, dim=-1)
    return torch.stack([rhat, ihat, chat], dim=-2)


def vnc_dcm(r, v):
    """DCM [..., 3, 3] from inertial to VNC (velocity, normal, co-normal)
    frame rows."""
    vhat = v / _norm(v, keepdim=True)
    h = torch.linalg.cross(r, v, dim=-1)
    nhat = h / _norm(h, keepdim=True)
    chat = torch.linalg.cross(vhat, nhat, dim=-1)
    return torch.stack([vhat, nhat, chat], dim=-2)


def rcn_dcm(r, v):
    """DCM [..., 3, 3] from inertial to RCN (radial, cross, normal) frame
    rows."""
    rhat = r / _norm(r, keepdim=True)
    h = torch.linalg.cross(r, v, dim=-1)
    nhat = h / _norm(h, keepdim=True)
    chat = torch.linalg.cross(nhat, rhat, dim=-1)
    return torch.stack([rhat, chat, nhat], dim=-2)


def _f64(x: float):
    return torch.tensor(x, dtype=torch.float64, device="cpu")


@dataclass
class Orbit:
    """A Cartesian orbital state at an epoch in a frame (host type); build
    with `Orbit.keplerian` (angles in degrees)."""

    r_km: np.ndarray  # (3,)
    v_km_s: np.ndarray  # (3,)
    epoch: Epoch
    frame: Frame

    @classmethod
    def cartesian(cls, x, y, z, vx, vy, vz, epoch: Epoch, frame: Frame) -> "Orbit":
        return cls(np.array([x, y, z], dtype=np.float64), np.array([vx, vy, vz], dtype=np.float64),
                   epoch, frame)

    @classmethod
    def keplerian(
        cls, sma_km, ecc, inc_deg, raan_deg, aop_deg, ta_deg, epoch: Epoch, frame: Frame
    ) -> "Orbit":
        r, v = cartesian_from_keplerian(
            _f64(sma_km), _f64(ecc), _f64(inc_deg * _D2R), _f64(raan_deg * _D2R),
            _f64(aop_deg * _D2R), _f64(ta_deg * _D2R), frame.mu,
        )
        return cls(r.numpy(), v.numpy(), epoch, frame)

    @classmethod
    def keplerian_apsis_radii(
        cls, ra_km, rp_km, inc_deg, raan_deg, aop_deg, ta_deg, epoch: Epoch, frame: Frame
    ) -> "Orbit":
        """`keplerian` from the apoapsis and periapsis radii (km)."""
        sma = (ra_km + rp_km) / 2
        ecc = (ra_km - rp_km) / (ra_km + rp_km)
        return cls.keplerian(sma, ecc, inc_deg, raan_deg, aop_deg, ta_deg, epoch, frame)

    def _vector(self):
        """[9] float64 CPU tensor: position, velocity and three zeros."""
        return torch.from_numpy(np.concatenate([self.r_km, self.v_km_s, np.zeros(3)]).astype(np.float64))

    def value(self, param: str) -> float:
        """A StateParameter of this orbit (the port's `md.param.value`),
        computed on the host in float64."""
        from ..md.param import value as param_value

        return float(param_value(param, self._vector(), self.frame.mu, self.frame.radius_km or 0.0))

    def to_cartesian_pos_vel(self) -> np.ndarray:
        return np.concatenate([self.r_km, self.v_km_s])

    @property
    def rmag_km(self) -> float:
        return float(np.linalg.norm(self.r_km))

    @property
    def vmag_km_s(self) -> float:
        return float(np.linalg.norm(self.v_km_s))

    def ric_difference(self, other: "Orbit") -> "Orbit":
        """This orbit minus `other`, in `other`'s RIC frame: an Orbit whose
        r/v are the RIC deltas."""
        dcm = ric_dcm(torch.from_numpy(np.asarray(other.r_km, np.float64)),
                      torch.from_numpy(np.asarray(other.v_km_s, np.float64))).numpy()
        dr = dcm @ (np.asarray(self.r_km) - np.asarray(other.r_km))
        dv = dcm @ (np.asarray(self.v_km_s) - np.asarray(other.v_km_s))
        return replace(self, r_km=dr, v_km_s=dv)

    # the osculating elements, each computed on the host in float64
    @property
    def sma_km(self) -> float:
        return self.value("sma")

    @property
    def ecc(self) -> float:
        return self.value("ecc")

    @property
    def inc_deg(self) -> float:
        return self.value("inc")

    @property
    def raan_deg(self) -> float:
        return self.value("raan")

    @property
    def aop_deg(self) -> float:
        return self.value("aop")

    @property
    def ta_deg(self) -> float:
        return self.value("ta")

    @property
    def ea_deg(self) -> float:
        return self.value("ea")

    @property
    def ma_deg(self) -> float:
        return self.value("ma")

    @property
    def energy_km2_s2(self) -> float:
        return self.vmag_km_s**2 / 2 - self.frame.mu / self.rmag_km

    @property
    def period_s(self) -> float:
        sma = self.sma_km
        if sma <= 0:
            return float("nan")
        return 2 * np.pi * np.sqrt(sma**3 / self.frame.mu)

    @property
    def periapsis_km(self) -> float:
        return self.value("periapsis_radius")

    @property
    def apoapsis_km(self) -> float:
        return self.value("apoapsis_radius")

    @property
    def periapsis_altitude_km(self) -> float:
        return self.periapsis_km - (self.frame.radius_km or 0.0)

    @property
    def apoapsis_altitude_km(self) -> float:
        return self.apoapsis_km - (self.frame.radius_km or 0.0)

    @property
    def hmag(self) -> float:
        return float(np.linalg.norm(np.cross(self.r_km, self.v_km_s)))

    @property
    def c3_km2_s2(self) -> float:
        return -self.frame.mu / self.sma_km

    @property
    def declination_deg(self) -> float:
        return float(np.degrees(np.arcsin(self.r_km[2] / self.rmag_km)))

    @property
    def right_ascension_deg(self) -> float:
        return float(np.degrees(np.arctan2(self.r_km[1], self.r_km[0])) % 360.0)

    @property
    def fpa_deg(self) -> float:
        rdotv = float(np.dot(self.r_km, self.v_km_s))
        return float(np.degrees(np.arcsin(rdotv / (self.rmag_km * self.vmag_km_s))))

    def __str__(self):
        return f"[{self.frame}] r={self.r_km} km v={self.v_km_s} km/s @ {self.epoch}"
