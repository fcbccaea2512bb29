"""Spherical-harmonic gravity (torch port of nyx_tpu/dynamics/gravity.py).

Same normalized Pines/Jones algorithm and host-side normalization tables as
the reference. The per-degree rows are packed once (`gravity_pines.
pack_tables`) and evaluated by the hand-written CUDA kernel for float32
tensors on the card, and by its plain torch twin everywhere else (float64
evaluations, CPU tensors, or `backend="torch"`).

Derivatives are forward mode only (`torch.func.jvp`, as the OD filter's
STM and measurement partials take them): every evaluation goes through
`PinesAccel`, whose tangent is the twin's, over the same degrees or, with
`jvp_degree`, over the field cut to that degree.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..constants import NAIF
from ..cosmic.frames import iau_orient
from ..cosmic.rotations import apply_dcm, apply_dcm_t, iau_earth_dcm32_pole
from ..errors import ConfigError
from ..io.gravity import GravityFieldData
from ..xmath import norm
from .gravity_pines import pack_tables, pines_accel, pines_accel_torch, pines_tangent_torch

_SQRT2 = np.sqrt(2.0)


def _precompute(N: int, M: int):
    """Host-side normalization tables, masked safe (invalid entries -> 0)."""
    W = M + 2  # column count
    n_idx = np.arange(N + 2)[:, None].astype(np.float64)
    m_idx = np.arange(W)[None, :].astype(np.float64)

    with np.errstate(invalid="ignore", divide="ignore"):
        b_nm = np.sqrt((2 * n_idx + 1) * (2 * n_idx - 1) / ((n_idx + m_idx) * (n_idx - m_idx)))
        c_nm = np.sqrt(
            (2 * n_idx + 1)
            * (n_idx + m_idx - 1)
            * (n_idx - m_idx - 1)
            / ((n_idx - m_idx) * (n_idx + m_idx) * (2 * n_idx - 3))
        )
        vr01 = np.sqrt((n_idx - m_idx) * (n_idx + m_idx + 1))
        vr11 = np.sqrt(
            (2 * n_idx + 1) * (n_idx + m_idx + 2) * (n_idx + m_idx + 1) / (2 * n_idx + 3)
        )
    vr01[:, 0] /= _SQRT2
    vr11[:, 0] /= _SQRT2
    for t in (b_nm, c_nm, vr01, vr11):
        t[~np.isfinite(t)] = 0.0

    diag = np.ones(N + 2)
    for n in range(1, N + 2):
        diag[n] = np.sqrt(1.0 + 1.0 / (2.0 * n)) * diag[n - 1]
    return b_nm, c_nm, vr01, vr11, diag


def _j2j3_accel(mu, radius_km, j2, j3, r, pole):
    """Closed-form J2+J3 zonal acceleration in the inertial frame.

    `pole` is the body's spin axis expressed inertially; with u = r/|r| and
    s = pole.u, the Vallado vector forms are
      a_J2 = -(3/2) J2 mu R^2/r^4 [(1-5 s^2) u + 2 s pole]
      a_J3 = -(5/2) J3 mu R^3/r^5 [(3 s-7 s^3) u + 3(s^2-1/5) pole]
    """
    rmag = norm(r, keepdim=True)
    u = r / rmag
    s = torch.sum(pole * u, dim=-1, keepdim=True)
    rho2 = (radius_km / rmag) ** 2
    mu_r2 = mu / (rmag * rmag)
    c2 = -1.5 * j2 * mu_r2 * rho2
    a = c2 * ((1.0 - 5.0 * s * s) * u + (2.0 * s) * pole)
    if j3 != 0.0:
        c3 = -2.5 * j3 * mu_r2 * rho2 * (radius_km / rmag)
        a = a + c3 * ((3.0 * s - 7.0 * s**3) * u + 3.0 * (s * s - 0.2) * pole)
    return a


def tables_from_coefficients(c_nm, s_nm, precision: str):
    """(xs, diag, N, M, j2, j3): the per-degree recursion rows of a field
    with fully normalized C/S [N+1, M+1]. precision="split" moves the two
    dominant zonals out of the rows into unnormalized (j2, j3)."""
    N, M = c_nm.shape[0] - 1, c_nm.shape[1] - 1
    b_nm, c_tab, vr01, vr11, diag = _precompute(N, M)
    W = M + 2
    C = np.zeros((N + 2, W))
    S = np.zeros((N + 2, W))
    C[: N + 1, : M + 1] = c_nm
    S[: N + 1, : M + 1] = s_nm
    j2 = j3 = 0.0
    if precision == "split":
        if N >= 2:
            j2 = -np.sqrt(5.0) * C[2, 0]  # unnormalize C20
            C[2, 0] = 0.0
        if N >= 3:
            j3 = -np.sqrt(7.0) * C[3, 0]
            C[3, 0] = 0.0
    # rows for n = 2..N+1, accumulating degree q = n-1
    ns = np.arange(2, N + 2)
    qs = ns - 1
    m_cols = np.arange(W)
    in_field = m_cols[None, :] <= np.minimum(qs, M)[:, None]
    xs = dict(
        b_row=b_nm[ns],
        c_row=c_tab[ns],
        diag_n=diag[ns],
        offdiag_n=np.sqrt(2.0 * (ns - 1) + 3.0) * diag[ns - 1],
        row_mask=(m_cols[None, :] <= ns[:, None] - 2).astype(np.float64),
        C_q=C[qs] * in_field,
        S_q=S[qs] * in_field,
        vr01_q=vr01[qs],
        vr11_q=vr11[qs],
        n_is=ns.astype(np.float64),
    )
    return xs, diag, N, M, float(j2), float(j3)


@dataclass(frozen=True, eq=False)
class Harmonics:
    """A gravity-field acceleration model; build with `Harmonics.from_stor`.

    precision: "f64" (full field at the state dtype), "f32" (the same, the
    name the reference gives an f32 caller's field), "mixed" (degrees up to
    `split_degree` in f64, the rest in f32: 3 suits Earth, where J2
    dominates; bodies with large low-degree sectorials, the Moon's C22,
    want ~8) or "split" (closed-form f64
    J2+J3, the rest of the field in one f32 recursion).
    backend: "auto" runs f32 evaluations on CUDA tensors through the
    kernel; "torch" forces the plain twin everywhere (the kernel's
    cross-check on the card).
    """

    _tables: tuple  # (xs, diag, N, M) host numpy rows
    mu_km3_s2: float
    radius_km: float
    max_degree: int
    max_order: int
    frame: object = None
    precision: str = "f64"
    j2: float = 0.0
    j3: float = 0.0
    backend: str = "auto"
    # Degree through which derivatives are taken (None: the whole field):
    # the OD filter's STM stage differentiates a cut field while values
    # keep the whole one (ScanKalmanOD's stm_jvp_degree).
    jvp_degree: Optional[int] = None
    # precision="mixed": degrees <= split_degree evaluate in f64, the rest
    # in f32 (through the kernel on the card, from q_lo = split_degree)
    split_degree: int = 3
    MIXED_SPLIT_DEGREE = 3

    @classmethod
    def from_stor(cls, stor: GravityFieldData, precision: str = "f64",
                  backend: str = "auto", split_degree: int = MIXED_SPLIT_DEGREE,
                  jvp_degree: Optional[int] = None) -> "Harmonics":
        if precision not in ("f64", "f32", "mixed", "split"):
            raise ConfigError(f"unknown harmonics precision {precision!r}")
        if backend not in ("auto", "torch"):
            raise ConfigError(f"unknown harmonics backend {backend!r}")
        xs, diag, N, M, j2, j3 = tables_from_coefficients(stor.c_nm, stor.s_nm, precision)
        return cls(
            _tables=(xs, diag, N, M),
            mu_km3_s2=float(stor.mu_km3_s2),
            radius_km=float(stor.radius_km),
            max_degree=N,
            max_order=M,
            frame=stor.frame,
            precision=precision,
            j2=j2,
            j3=j3,
            backend=backend,
            jvp_degree=None if jvp_degree is None else int(jvp_degree),
            split_degree=int(split_degree),
        )

    def required_bodies(self):
        return ()

    def accel(self, ctx, t_tdb, r, v):
        """Inertial-frame acceleration: rotate to the field's frame, run the
        Pines recursion, rotate back. Runs at the dtype of `r`; with
        precision="split" and an f64 `r`, J2+J3 stay f64 and the rest of the
        field runs as one f32 recursion."""
        if self.precision == "split" and r.dtype == torch.float64:
            if self.frame.orientation == iau_orient(NAIF.EARTH):
                dcm32, pole = iau_earth_dcm32_pole(t_tdb)
            else:
                dcm = self.frame.dcm_from_j2000(t_tdb)
                pole = dcm[..., 2, :]
                dcm32 = dcm.to(torch.float32)
            a_low = _j2j3_accel(self.mu_km3_s2, self.radius_km, self.j2, self.j3, r, pole)
            r_bf32 = apply_dcm(dcm32, r.to(torch.float32))
            a32 = self.accel_body_fixed(r_bf32)
            return a_low + apply_dcm_t(dcm32, a32).to(torch.float64)
        dcm = self.frame.dcm_from_j2000(t_tdb).to(r.dtype)
        r_bf = apply_dcm(dcm, r)
        return apply_dcm_t(dcm, self.accel_body_fixed(r_bf))

    def accel_body_fixed(self, r_bf):
        """Non-spherical acceleration (km/s^2) in the body-fixed frame,
        degrees >= 1 only. r_bf: [B, 3] km. With `jvp_degree` set, the
        value is the full field's and the forward-mode derivative that of
        the field cut to degree jvp_degree, at the dtype of `r_bf`."""
        if self.jvp_degree is None:
            return self._abf_primal(r_bf)
        q_t = min(self.jvp_degree, self.max_degree)
        return PinesAccel.apply(
            r_bf, self._abf_primal, lambda r, dr: self._twin_tangent(r, dr, 0, q_t))

    def packed_table(self, q_hi: int, dtype, device):
        """The packed rows (see gravity_pines.pack_tables) as a tensor,
        cached per (q_hi, dtype, device)."""
        cache = self.__dict__.setdefault("_packed", {})
        key = (q_hi, dtype, torch.device(device))
        if key not in cache:
            xs, _, N, M = self._tables
            np_dtype = np.float32 if dtype == torch.float32 else np.float64
            tab = pack_tables(xs, N, M + 2, q_hi, np_dtype)
            # A tensor made inside a torch.func transform (a first call
            # from a tangent, say) is the transform's wrapper, without
            # storage, and would outlive it in the cache; make it plain.
            with torch._C._DisableFuncTorch():
                cache[key] = torch.as_tensor(tab, dtype=dtype, device=device)
        return cache[key]

    def pines_args(self) -> dict:
        """The keyword arguments of the Pines functions for this field."""
        _, diag, _, M = self._tables
        return dict(W=M + 2, mu=self.mu_km3_s2, radius=self.radius_km, diag1=float(diag[1]))

    def with_jvp_degree(self, q: int) -> "Harmonics":
        """Same field, its derivatives taken through the field cut to degree
        `q` (see `jvp_degree`)."""
        return replace(self, jvp_degree=int(q))

    def _abf_primal(self, r_bf):
        split = self.split_degree
        if self.precision == "mixed" and self.max_degree > split and r_bf.dtype == torch.float64:
            low = self._accel_any(r_bf, q_hi=split)
            high32 = self._accel_any(r_bf.to(torch.float32), q_lo=split)
            return low + high32.to(r_bf.dtype)
        return self._accel_any(r_bf)

    def _twin_tangent(self, r_bf, dr_bf, q_lo: int = 0, q_hi: int = 0):
        """The twin's tangent over degrees (q_lo, q_hi or N]."""
        tab = self.packed_table(q_hi, r_bf.dtype, r_bf.device)
        return pines_tangent_torch(r_bf, dr_bf, tab, q_lo, **self.pines_args())

    def _accel_any(self, r_bf, q_lo: int = 0, q_hi: int = 0):
        """Degrees q in (q_lo, q_hi or N]. A float32 evaluation on a CUDA
        tensor runs the kernel (or raises); a CPU tensor, a float64
        evaluation or backend="torch" runs the torch twin. Either way the
        tangent is the twin's, over the same degrees."""
        tab = self.packed_table(q_hi, r_bf.dtype, r_bf.device)
        kw = self.pines_args()
        if self.backend == "torch" or r_bf.dtype != torch.float32:
            def primal(r):
                return pines_accel_torch(r, tab, q_lo, **kw)
        else:
            def primal(r):
                return pines_accel(r.contiguous(), tab, q_lo, **kw)
        return PinesAccel.apply(
            r_bf, primal, lambda r, dr: self._twin_tangent(r, dr, q_lo, q_hi))


class PinesAccel(torch.autograd.Function):
    """A gravity evaluation `primal(r_bf)` whose forward-mode derivative is
    `tangent(r_bf, dr_bf)`: the kernel (which has no derivative) or the
    twin as the primal, the twin's `torch.func.jvp` as the tangent. It is
    the counterpart of the reference's `custom_jvp` around the Pallas call
    (gravity.py:353-385) and around the degree-cut field (:295-319).

    Only forward mode is defined. The setup_context form lets
    `torch.func.jvp` run it: `forward` then sees plain tensors, so the
    kernel launches inside a transform as outside one."""

    @staticmethod
    def forward(r_bf, primal, tangent):
        return primal(r_bf)

    @staticmethod
    def setup_context(ctx, inputs, output):
        r_bf, _, tangent = inputs
        ctx.save_for_forward(r_bf)
        ctx.tangent = tangent

    @staticmethod
    def jvp(ctx, dr_bf, _primal, _tangent):
        (r_bf,) = ctx.saved_tensors
        return ctx.tangent(r_bf, dr_bf)
