"""IERS-2010 solid-tide acceleration, degree 2 and optionally degree 3
(torch port of nyx_tpu/dynamics/solid_tides.py).

Counterpart of the reference's `SolidTides` (dynamics/solid_tides.rs:
40-249): tidal perturbers raise time-varying normalized dC_nm/dS_nm
corrections (k2/k3 Love numbers), evaluated with the same GMAT-style
normalized-Legendre accumulation. Batched over lanes and branchless. The
reference unrolls its degree 2/3 loops into one tensor per term; in eager
torch each operation is a kernel launch from the host, so here the
perturbers ride a leading axis, the seven (n, m) terms a trailing one, and
every degree-2/3 polynomial (the Legendre functions to n = 4, the
cos/sin(m lambda) chains, the raising bodies' P_nm) is a product of a
monomial basis with a constant matrix built on the host by the same
recursions: about half the launches of one tensor per term, the same
values to ~1e-15. The forward-mode STM (`torch.autograd.forward_ad`, or
`torch.func.jvp`) differentiates it as it stands, in place of the
reference's hyperdual gradient.

Dtypes follow the reference's promotion: the perturbers' positions and the
body-fixed DCM are float64, so the whole model runs in float64 even when
`r` is float32, and returns float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..constants import GM_BY_NAIF, NAIF
from ..cosmic.frames import Frame, Frames
from ..xmath import norm

_SQRT2 = math.sqrt(2.0)
# the (n, m) terms of degrees 2 and 3, in column order
_NM = tuple((n, m) for n in (2, 3) for m in range(n + 1))
# exponents (i, j) of the monomial basis x^i y^j up to degree 3 (_monomials)
_MONO = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1), (1, 2), (0, 3))


# fixed normalization factors for n in {1, 2, 3}, m in {0..n}
def _vr01(n, m):
    v = math.sqrt((n - m) * (n + m + 1.0))
    return v / _SQRT2 if m == 0 else v


def _vr11(n, m):
    v = math.sqrt((2.0 * n + 1.0) * (n + m + 2.0) * (n + m + 1.0) / (2.0 * n + 3.0))
    return v / _SQRT2 if m == 0 else v


def _b_nm(n, m):
    return math.sqrt(((2.0 * n + 1.0) * (2.0 * n - 1.0)) / ((n + m) * (n - m)))


def _c_nm(n, m):
    return math.sqrt(((2.0 * n + 1.0) * (n + m - 1.0) * (n - m - 1.0))
                     / ((n - m) * (n + m) * (2.0 * n - 3.0)))


def _column(terms):
    """A polynomial {(i, j): coefficient} as its column over _MONO."""
    return [terms.get(e, 0.0) for e in _MONO]


def _cos_sin_m(m):
    """(cos(m l), sin(m l)) as polynomials in x = cos l, y = sin l; equally
    the real and imaginary parts of (x + i y)^m."""
    return [({(0, 0): 1.0}, {}), ({(1, 0): 1.0}, {(0, 1): 1.0}),
            ({(2, 0): 1.0, (0, 2): -1.0}, {(1, 1): 2.0}),
            ({(3, 0): 1.0, (1, 2): -3.0}, {(2, 1): 3.0, (0, 3): -1.0})][m]


def _tables():
    """The constant matrices: P_nm of the raising body in (sin phi, cos
    phi) [10, 7]; cos and sin (m lambda) [10, 14] and the same chains at m
    and m - 1, the spacecraft's r_m, i_m, r_m-1, i_m-1 [10, 28], in
    (cos, sin); and the Legendre functions a_nm, a_n,m+1 and a_n+1,m+1 in
    powers of u to 4 [5, 21] (entries with m > n zero, as the reference's
    fixed-size zero-initialized array, solid_tides.rs:267)."""
    s5, s7 = math.sqrt(5.0), math.sqrt(7.0)
    p_nm = [{(0, 0): -0.5 * s5, (2, 0): 1.5 * s5}, {(1, 1): 3.0 * math.sqrt(5.0 / 3.0)},
            {(0, 2): 3.0 * math.sqrt(5.0 / 12.0)}, {(3, 0): 2.5 * s7, (1, 0): -1.5 * s7},
            {(2, 1): 7.5 * math.sqrt(7.0 / 6.0), (0, 1): -1.5 * math.sqrt(7.0 / 6.0)},
            {(1, 2): 15.0 * math.sqrt(7.0 / 60.0)}, {(0, 3): 15.0 * math.sqrt(7.0 / 360.0)}]
    trig = [_cos_sin_m(m)[k] for k in (0, 1) for _, m in _NM]
    chains = trig + [_cos_sin_m(m - 1)[k] if m else {} for k in (0, 1) for _, m in _NM]
    # the reference's recursion (solid_tides.py:146-155) on polynomials in u
    poly = np.polynomial.polynomial
    a = {(0, 0): np.array([1.0])}
    for n in range(1, 5):
        a[(n, n)] = math.sqrt(1.0 + 1.0 / (2.0 * n)) * a[(n - 1, n - 1)]
    a[(1, 0)] = np.array([0.0, math.sqrt(3.0)])
    for n in range(1, 5):
        a[(n + 1, n)] = poly.polymulx(math.sqrt(2.0 * n + 3.0) * a[(n, n)])
    for m in range(0, 4):
        for n in range(m + 2, 5):
            a[(n, m)] = poly.polysub(_b_nm(n, m) * poly.polymulx(a[(n - 1, m)]), _c_nm(n, m) * a[(n - 2, m)])
    zero = np.zeros(1)
    legendre = ([a[nm] for nm in _NM] + [a.get((n, m + 1), zero) for n, m in _NM]
                + [a[(n + 1, m + 1)] for n, m in _NM])
    leg = np.zeros((5, len(legendre)))
    for k, c in enumerate(legendre):
        leg[: len(c), k] = c
    return (np.array([_column(t) for t in p_nm]).T, np.array([_column(t) for t in trig]).T,
            np.array([_column(t) for t in chains]).T, leg)


def _monomials(x, y):
    """[..., 10] x^i y^j over _MONO."""
    x2, xy, y2 = x * x, x * y, y * y
    return torch.stack([torch.ones_like(x), x, y, x2, xy, y2, x2 * x, x2 * y, x * y2, y2 * y], dim=-1)


@dataclass(frozen=True)
class TidalPerturber:
    """The raising body and its degree-3 flag (solid_tides.rs:56-65)."""

    body: int  # NAIF id
    compute_degree_3: bool = False


@dataclass(frozen=True)
class SolidTides:
    """Solid tides on the central body (solid_tides.rs:40-54)."""

    frame: Frame  # body-fixed frame of the deformed central body
    k2: float = 0.3019
    k3: float = 0.093
    perturbers: Tuple[TidalPerturber, ...] = (
        TidalPerturber(NAIF.MOON, True),
        TidalPerturber(NAIF.SUN, False),
    )

    @classmethod
    def earth_moon_system(cls, earth_bf_frame: Frame = Frames.IAU_EARTH) -> "SolidTides":
        """Moon (degree 3 on) and Sun perturbers, k2 = 0.3019, k3 = 0.093
        (solid_tides.rs:177-230)."""
        return cls(frame=earth_bf_frame)

    def required_bodies(self):
        return tuple(p.body for p in self.perturbers)

    def _constants(self, dtype, device):
        """The constant tensors, made once per dtype and device: the
        perturbers' [P, 1] k_n gm_ratio / (2n + 1) for n = 2 and 3 (0 where
        degree 3 is off); [7] rows of m, vr01 and vr11; the matrices of
        `_tables`."""
        cache = self.__dict__.setdefault("_consts", {})
        key = (dtype, torch.device(device))
        if key not in cache:
            mu0 = self.frame.mu
            gm = [GM_BY_NAIF[p.body] / mu0 for p in self.perturbers]
            k2 = [[self.k2 / 5.0 * g] for g in gm]
            k3 = [[self.k3 / 7.0 * g if p.compute_degree_3 else 0.0] for g, p in zip(gm, self.perturbers)]
            rows = ([float(m) for _, m in _NM], [_vr01(n, m) for n, m in _NM],
                    [_vr11(n, m) for n, m in _NM])
            # a tensor made inside a torch.func transform would be its
            # wrapper, without storage, and outlive it in the cache
            with torch._C._DisableFuncTorch():
                cache[key] = tuple(torch.tensor(np.asarray(x), dtype=dtype, device=device)
                                   for x in (k2, k3) + rows + _tables())
        return cache[key]

    def _delta_cs(self, ctx, t_tdb, dcm):
        """Batched dC, dS [B, 7], columns in _NM order (solid_tides.rs:67-174)."""
        k2, k3, _, _, _, p_nm, trig = self._constants(dcm.dtype, dcm.device)[:7]
        idx = [ctx.body_index(p.body) for p in self.perturbers]
        rb = torch.matmul(dcm, ctx.table.position(idx, t_tdb)[..., None])[..., 0]  # [P, B, 3] body fixed
        r_body = norm(rb)
        s_b, t_b, sin_phi = (rb / r_body[..., None]).unbind(-1)

        cos_phi = torch.sqrt(torch.clamp(1.0 - sin_phi**2, min=0.0))
        safe = cos_phi > 1e-12
        cos_lam = torch.where(safe, s_b / torch.where(safe, cos_phi, 1.0), 1.0)
        sin_lam = torch.where(safe, t_b / torch.where(safe, cos_phi, 1.0), 0.0)

        p = torch.matmul(_monomials(sin_phi, cos_phi), p_nm)  # [P, B, 7]
        cos_ml, sin_ml = torch.matmul(_monomials(cos_lam, sin_lam), trig).split(len(_NM), dim=-1)
        r_ratio = self.frame.radius_km / r_body
        c2 = k2 * r_ratio**3
        c3 = k3 * r_ratio**4
        common_p = torch.stack([c2, c2, c2, c3, c3, c3, c3], dim=-1) * p
        return torch.sum(common_p * cos_ml, dim=0), torch.sum(common_p * sin_ml, dim=0)

    def accel(self, ctx, t_tdb, r, v):
        """[B, 3] inertial tidal acceleration (solid_tides.rs:258-388)."""
        dcm = self.frame.dcm_from_j2000(t_tdb)  # J2000 -> body fixed [B, 3, 3]
        dc, ds = self._delta_cs(ctx, t_tdb, dcm)
        _, _, m_col, vr01, vr11, _, _, chains, leg = self._constants(dcm.dtype, dcm.device)

        # an f32 r is promoted to the DCM's f64, as the reference's einsum does
        r_bf = torch.matmul(dcm, r.to(dcm.dtype)[..., None])[..., 0]
        r_ = norm(r_bf)
        s_, t_, u_ = (r_bf / r_[..., None]).unbind(-1)

        u2 = u_ * u_
        powers = torch.stack([torch.ones_like(u_), u_, u2, u2 * u_, u2 * u2], dim=-1)
        a_nm, a_z, a_w = torch.matmul(powers, leg).split(len(_NM), dim=-1)
        rm, im, rm1, im1 = torch.matmul(_monomials(s_, t_), chains).split(len(_NM), dim=-1)
        d_ = (dc * rm + ds * im) * _SQRT2
        e_ = (dc * rm1 + ds * im1) * _SQRT2
        f_ = (ds * rm1 - dc * im1) * _SQRT2
        terms = torch.stack([m_col * a_nm * e_, m_col * a_nm * f_, vr01 * a_z * d_, -(vr11 * a_w * d_)])

        req = self.frame.radius_km
        rho = req / r_
        rho3 = self.frame.mu / r_ * rho * rho * rho  # rho^(n+1) mu / r at n = 2
        scale2, scale3 = rho3 / req, rho3 * rho / req
        ax, ay, az, aw = scale2 * terms[..., :3].sum(-1) + scale3 * terms[..., 3:].sum(-1)

        a_bf = torch.stack([ax + aw * s_, ay + aw * t_, az + aw * u_], dim=-1)
        return torch.matmul(dcm.transpose(-1, -2), a_bf[..., None])[..., 0]
