"""The spacecraft EOM in two hand-written CUDA kernels around the Pines launch.

`SpacecraftDynamics.make_eom` asks `plan_for` once whether its composition
is one that `csrc/eom.cu` computes: no STM, no guidance, f64 perturbations;
no orbital model, or one split-precision `Harmonics` in the IAU Earth
orientation (automatic backend, no degree cut for derivatives); at most one
`SolarPressure` whose only shadow body is the frame's centre and at most one
`Drag` with a constant or exponential density. If so, each evaluation of a
CUDA float64 state that carries no derivative (`FusedPlan.declines`) runs
as `eom_pre`, the Pines kernel and `eom_post`: three launches for ~418
(`fused_eom`). An input the kernels could compute but that does not fit
them is made to fit (a strided state is copied) or raises (a per-lane
spacecraft parameter, a Sun table of another dtype or device); it never
falls back. Every other evaluation takes the composed path, which counts
itself in `fused_eom.composed_calls`. The two paths share no code, only the
model objects their constants come from.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .. import _cuda
from ..constants import AU_KM, NAIF, RADIUS_BY_NAIF, SPEED_OF_LIGHT_M_S, MeanRadius
from ..cosmic.frames import iau_orient
from .drag import Drag
from .gravity import Harmonics
from .gravity_pines import COUNT_LOCK, pines_accel
from .srp import SolarPressure

_CORE_DIM = 9


class _Consts(ctypes.Structure):
    """`EomConsts` of csrc/eom.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_double) for n in ("epoch0_tdb", "mu", "field_mu", "field_radius", "c2_coef",
                                         "c3_coef", "sun_t0", "dry_mass_kg")]
        + [(n, ctypes.c_float) for n in ("sun_intlen", "sun_inv_intlen", "sun_last_rec",
                                          "srp_phi_over_c", "au_km", "sun_radius_km",
                                          "occ_radius_km", "srp_area_m2", "rho", "rho0", "r0_m",
                                          "inv_ref_alt_m", "drag_radius_km", "omega",
                                          "drag_area_m2")]
        + [(n, ctypes.c_int) for n in ("field", "j3", "srp", "drag", "sun_coeffs")]
        + [("sun_strides", ctypes.c_int * 3)]
    )


def _f32(x) -> float:
    return float(np.float32(x))


def _f32_inv(x) -> float:
    """1 / x as PyTorch's kernels take it for an f32 tensor divided by the
    Python number x: both rounded to f32, the quotient too."""
    return float(np.float32(1.0) / np.float32(x))


def _number(p, key: str) -> float:
    v = p[key]
    if isinstance(v, (bool, torch.Tensor)) or not isinstance(v, (int, float, np.integer, np.floating)):
        raise TypeError(f"the fused EOM takes {key} as a number, got {type(v).__name__}")
    return float(v)


@dataclass(frozen=True)
class FusedPlan:
    """The models of a composition that the fused kernels compute."""

    center: int  # the frame's centre (NAIF id)
    field: Optional[Harmonics]
    srp: Optional[SolarPressure]
    drag: Optional[Drag]
    # (context, parameters, constants) of the last `consts` call
    _last: list = dc_field(default_factory=lambda: [None], init=False, compare=False, repr=False)

    def declines(self, t_rel, y) -> bool:
        """Whether this evaluation takes the composed path: a state that is
        not a float64 tensor on a CUDA device (the kernels compute f64 states
        on the card), or an input that carries a derivative, which the
        kernels do not propagate (autograd, a forward-AD tangent, a
        torch.func transform)."""
        if not (isinstance(y, torch.Tensor) and y.is_cuda and y.dtype == torch.float64):
            return True
        if torch._C._functorch.maybe_current_level() is not None:
            return True
        return any(isinstance(x, torch.Tensor)
                   and (x.requires_grad or fwAD.unpack_dual(x).tangent is not None)
                   for x in (y, t_rel))

    def consts(self, ctx, p) -> _Consts:
        """The kernels' constants for `ctx` and the spacecraft's `p`, each
        at the precision the composed path takes it in. Raises where the
        context or the parameters do not fit the kernels: a context of
        another frame's centre, SRP without the context's float64 Sun table,
        a parameter that is not a number (per-lane values are not taken).
        The last call's constants are kept: an ensemble's evaluations repeat
        its context and parameters."""
        nums = (_number(p, "dry_mass_kg"),
                _number(p, "srp_area_m2") if self.srp is not None else 0.0,
                _number(p, "drag_area_m2") if self.drag is not None else 0.0)
        dry, srp_area, drag_area = nums
        last = self._last[0]
        if last is not None and last[0] is ctx and last[1] == nums:
            return last[2]
        if ctx.frame.center != self.center:
            raise ValueError(f"the context's frame is centred on {ctx.frame.center}, "
                             f"the dynamics' on {self.center}")
        c = _Consts(epoch0_tdb=ctx.epoch0_tdb, mu=ctx.frame.mu, dry_mass_kg=dry)
        if self.field is not None:
            h = self.field
            c.field, c.j3 = 1, int(h.j3 != 0.0)
            c.field_mu, c.field_radius = h.mu_km3_s2, h.radius_km
            c.c2_coef, c.c3_coef = -1.5 * h.j2, -2.5 * h.j3
        if self.srp is not None:
            tab = ctx.table
            if tab is None or NAIF.SUN not in tab.bodies or tab.coeffs.dtype != torch.float64:
                raise ValueError("SRP on the fused EOM needs the context's float64 Sun table")
            c.srp = 1
            c.sun_t0 = tab.t0
            c.sun_intlen, c.sun_inv_intlen = _f32(tab.intlen), _f32_inv(tab.intlen)
            c.sun_last_rec = _f32(tab.coeffs.shape[1] - 1)
            c.sun_coeffs = tab.coeffs.shape[-1]
            c.sun_strides[:] = tab.coeffs.stride()[1:]
            c.srp_phi_over_c = _f32(self.srp.phi_w_m2 / SPEED_OF_LIGHT_M_S)
            c.au_km, c.sun_radius_km = _f32(AU_KM), _f32(MeanRadius.SUN)
            c.occ_radius_km = _f32(RADIUS_BY_NAIF[self.center])
            c.srp_area_m2 = _f32(srp_area)
        if self.drag is not None:
            dens = self.drag.density
            c.drag = 2 if dens.kind == "exponential" else 1
            c.rho, c.rho0, c.r0_m = _f32(dens.rho), _f32(dens.rho0), _f32(dens.r0_m)
            c.inv_ref_alt_m = _f32_inv(dens.ref_alt_m)
            c.drag_radius_km = _f32(self.drag.frame.radius_km or 0.0)
            c.omega = _f32(Drag._EARTH_OMEGA)
            c.drag_area_m2 = _f32(drag_area)
        self._last[0] = (ctx, nums, c)
        return c


def plan_for(dyn, with_stm: bool) -> Optional[FusedPlan]:
    """The fused plan of `dyn`'s EOM, or None where the kernels do not
    compute its composition."""
    if with_stm or dyn.guidance is not None or dyn.pert_precision != "f64":
        return None
    center = dyn.orbital_dyn.frame.center
    models = dyn.orbital_dyn.models
    field = None
    if models:
        if len(models) != 1 or type(models[0]) is not Harmonics:
            return None
        field = models[0]
        if not (field.precision == "split" and field.backend == "auto"
                and field.jvp_degree is None and field.frame is not None
                and field.frame.orientation == iau_orient(NAIF.EARTH)):
            return None
    srp = drag = None
    for fm in dyn.force_models:
        if type(fm) is SolarPressure and srp is None and center != NAIF.SUN \
                and tuple(fm.shadow_bodies) == (center,):
            srp = fm
        elif type(fm) is Drag and drag is None and fm.density.kind in ("constant", "exponential"):
            drag = fm
        else:
            return None
    return FusedPlan(center, field, srp, drag)


@functools.cache
def _bind():
    lib = _cuda.load("eom").lib
    pre, post = lib.eom_pre_f64, lib.eom_post_f64
    pre.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, _Consts, ctypes.c_void_p]
    post.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, _Consts, ctypes.c_void_p]
    pre.restype = post.restype = ctypes.c_int
    return pre, post


def fused_eom(plan: FusedPlan, t_rel, y, ctx, p):
    """`ydot [..., 9]` of the state `y [..., 9]` at `t_rel` (a number, or a
    tensor that broadcasts to `y.shape[:-1]`) through `eom_pre`, the Pines
    kernel and `eom_post` (without a field, `eom_post` alone), on the
    current stream. The caller has checked `plan.declines`; a strided `y`
    is copied to a contiguous one first."""
    if y.shape[-1] != _CORE_DIM:
        raise ValueError(f"the fused EOM takes [..., {_CORE_DIM}] states, got {tuple(y.shape)}")
    c = plan.consts(ctx, p)
    shape = y.shape
    y = y.reshape(-1, _CORE_DIM).contiguous()
    t_rel = torch.as_tensor(t_rel, dtype=torch.float64, device=y.device)
    t_rel = t_rel.expand(shape[:-1]).reshape(-1).contiguous()
    if y.shape[0] == 0:
        return torch.empty_like(y).view(shape)
    a_bf = sun = None
    if plan.srp is not None:
        sun = ctx.table.coeffs[ctx.table.index_of(NAIF.SUN)]
        if sun.device != y.device:
            raise ValueError(f"the context's Sun table is on {sun.device}, the state on {y.device}")
    if plan.field is not None:
        tab = plan.field.packed_table(0, torch.float32, y.device)
        a_bf = pines_accel(eom_pre(t_rel, y, c), tab, 0, **plan.field.pines_args())
    ydot = eom_post(t_rel, y, a_bf, sun, c)
    with COUNT_LOCK:
        fused_eom.launches += 1
    return ydot.view(shape)


def eom_pre(t_rel, y, c: _Consts):
    """The Pines kernel's input `[B, 3]` f32: the IAU Earth rotation of each
    lane's epoch applied to its position cast to f32."""
    B = y.shape[0]
    r_bf = torch.empty((B, 3), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        err = _bind()[0](t_rel.data_ptr(), y.data_ptr(), r_bf.data_ptr(), B, c,
                         torch.cuda.current_stream().cuda_stream)
    _check(err, "eom_pre")
    return r_bf


def eom_post(t_rel, y, a_bf, sun, c: _Consts):
    """`ydot [B, 9]` f64 of the state from the Pines kernel's output `a_bf
    [B, 3]` f32 (None without a field) and the Sun's Chebyshev records `sun
    [n_records, 3, n_coeffs]` f64 (None without SRP)."""
    ydot = torch.empty_like(y)
    with torch.cuda.device(y.device):
        err = _bind()[1](t_rel.data_ptr(), y.data_ptr(), 0 if a_bf is None else a_bf.data_ptr(),
                         0 if sun is None else sun.data_ptr(), ydot.data_ptr(), y.shape[0], c,
                         torch.cuda.current_stream().cuda_stream)
    _check(err, "eom_post")
    return ydot


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


fused_eom.launches = 0  # fused evaluations launched
fused_eom.composed_calls = 0  # evaluations of SpacecraftDynamics' composed EOM
