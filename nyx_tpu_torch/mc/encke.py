"""Encke deviation propagation: float32 ensemble lanes around one float64 reference.

Torch port of nyx_tpu/mc/encke.py. A Monte Carlo lane differs from the
nominal by km-scale deviations while the states are ~7,000 km or more, so
the deviation carries its meaning in float32:

  1. the nominal propagates once at full quality and is resampled onto a
     uniform grid of (r, v, a) rows, interpolated in float64 by a quintic
     Hermite (`_quintic`);
  2. the two-body differential uses Encke's f(q) form, with no
     catastrophic subtraction:
       da_2b = -mu/r_ref^3 (delta - f(q) r_full),  f(q) = 1 - (1+q)^(-3/2),
     in float64 (a handful of operations);
  3. the perturbation differential is P_f32(r_full) - P_table(t), the table
     holding the same float32 perturbation function (`make_perturbation_fn`)
     at the reference, so the smooth part of the float32 evaluation error
     cancels. On the card, the lanes' and the table's gravity fields both
     run the Pines kernel, bit for bit its twin.

`propagate_fixed` is the synchronized fixed-step loop (the propagator's RK
tableau, or the AB8/AM PECE multistep `_propagate_abm`), with optional
capture; `make_encke_eom` is the deviation EOM for the adaptive integrator
at `state_dtype=torch.float32`. The reference's `lax.scan` loops are host
loops over the steps, every step's reference rows tabulated before the
loop. The reference keeps its tables a traced argument so that XLA cannot
constant-fold them with other float32 arithmetic than the lanes'; eager
torch folds nothing, so nothing here works around that.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..dynamics.gravity import Harmonics, _j2j3_accel

_F32 = torch.float32
_F64 = torch.float64


class EnckeReference(NamedTuple):
    """The reference's grid tables, on the device."""

    stride_s: float  # grid spacing, s
    r: torch.Tensor  # [K, 3] f64 positions
    v: torch.Tensor  # [K, 3] f64 velocities
    a: torch.Tensor  # [K, 3] f64 total accelerations (quintic end data)
    p32: torch.Tensor  # [K, 3] f32 perturbation (the lanes' own f32 function)


def make_perturbation_fn(dyn):
    """The float32 perturbation stack P(ctx, t_tdb, r32, v32, sc32) of the
    dynamics: the orbital models (harmonics, third bodies) and the force
    models at the dtype of r32; a split-precision field's closed-form J2+J3
    is re-added at float32 (its tables leave them out)."""
    split_harmonics = [m for m in dyn.orbital_dyn.models
                       if isinstance(m, Harmonics) and m.precision == "split"]
    force_models = dyn.force_models

    def pert(ctx, t_tdb, r32, v32, sc32):
        a = dyn.orbital_dyn.perturbation_accel(ctx, t_tdb, r32, v32)
        for h in split_harmonics:
            pole = h.frame.dcm_from_j2000(t_tdb).to(_F32)[..., 2, :]
            a = a + _j2j3_accel(float(h.mu_km3_s2), float(h.radius_km), float(h.j2),
                                float(h.j3), r32, pole)
        for fm in force_models:
            a = a + fm.force_per_mass(ctx, t_tdb, r32, v32, sc32)
        # third bodies promote to f64 (their ephemeris table is f64); the
        # lanes and the table both evaluate this function, so the trailing
        # cast keeps the common-mode cancellation and pins the lanes at f32
        return a.to(_F32)

    return pert


def _sc32(p, cr, cd, mass, device):
    """The force models' spacecraft dict at float32."""
    f32 = dict(dtype=_F32, device=device)
    return dict(cr=torch.as_tensor(cr, **f32), cd=torch.as_tensor(cd, **f32),
                srp_area_m2=float(np.float32(p["srp_area_m2"])),
                drag_area_m2=float(np.float32(p["drag_area_m2"])),
                mass_kg=torch.as_tensor(mass, **f32))


def build_reference(prop, template_sc, duration_s: float, almanac, stride_s: float = 60.0, *,
                    device="cuda") -> EnckeReference:
    """Propagate the nominal once (full quality) on `device`, past the arc's
    end by four strides, and tabulate it every `stride_s`."""
    return reference_and_final(prop, template_sc, duration_s, almanac, stride_s, device=device)[0]


def reference_and_final(prop, template_sc, duration_s: float, almanac, stride_s: float = 60.0, *,
                        device="cuda"):
    """(`build_reference`'s table, the nominal's float64 state [9] at
    `duration_s`). The nominal runs in two legs, to the arc's end and four
    strides on: the first leg is the reference's separate `for_duration`
    of the end state (the same steps, the last clamped to the end), so one
    propagation gives both."""
    from ..md.trajectory import Trajectory

    n_cap = int((duration_s + 4.0 * stride_s) / 30.0) + 256
    inst = prop.with_state(template_sc, almanac, device=device)
    final, head = inst.for_duration_with_traj(duration_s, n_capture=n_cap)
    _, tail = inst.for_duration_with_traj(4.0 * stride_s, n_capture=n_cap)
    traj = Trajectory.from_capture(template_sc.epoch,
                                   np.concatenate([head.ts, duration_s + tail.ts]),
                                   np.concatenate([head.ys, tail.ys]), template_sc)
    ts = np.arange(0.0, duration_s + stride_s * 2.5, stride_s)
    ys = traj.interpolate_many(ts)
    f64 = dict(dtype=_F64, device=device)
    r = torch.as_tensor(ys[:, 0:3], **f64)
    v = torch.as_tensor(ys[:, 3:6], **f64)
    dyn = prop.dynamics
    ctx = dyn.build_context(template_sc.epoch, duration_s, almanac, device=device)
    t_tdb = ctx.epoch0_tdb + torch.as_tensor(ts, **f64)
    p = dict(srp_area_m2=template_sc.srp_area_m2, drag_area_m2=template_sc.drag_area_m2)
    sc32 = _sc32(p, template_sc.cr, template_sc.cd, template_sc.total_mass_kg, device)
    p32 = make_perturbation_fn(dyn)(ctx, t_tdb, r.to(_F32), v.to(_F32), sc32)
    a_tot = dyn.orbital_dyn.two_body_accel(ctx, r) + p32.to(_F64)
    ref = EnckeReference(stride_s=float(stride_s), r=r, v=v, a=a_tot, p32=p32)
    return ref, final.to_vector()


def _quintic(ref: EnckeReference, t_rel):
    """float64 (r_ref, v_ref) at times `t_rel` (s, any shape): the two-point
    quintic Hermite on the grid with (r, v, a) end data."""
    h = ref.stride_s
    x = t_rel / h
    K = ref.r.shape[0]
    i = torch.clamp(torch.floor(x), 0, K - 2).long()
    s = (x - i.to(_F64))[..., None]
    r0, r1 = ref.r[i], ref.r[i + 1]
    v0, v1 = ref.v[i] * h, ref.v[i + 1] * h
    a0, a1 = ref.a[i] * h**2, ref.a[i + 1] * h**2
    s2 = s * s
    s3 = s2 * s
    s4 = s3 * s
    s5 = s4 * s
    h00 = 1 - 10 * s3 + 15 * s4 - 6 * s5
    h10 = s - 6 * s3 + 8 * s4 - 3 * s5
    h20 = 0.5 * s2 - 1.5 * s3 + 1.5 * s4 - 0.5 * s5
    h01 = 10 * s3 - 15 * s4 + 6 * s5
    h11 = -4 * s3 + 7 * s4 - 3 * s5
    h21 = 0.5 * s3 - s4 + 0.5 * s5
    r_ref = h00 * r0 + h10 * v0 + h20 * a0 + h01 * r1 + h11 * v1 + h21 * a1
    d00 = (-30 * s2 + 60 * s3 - 30 * s4) / h
    d10 = (1 - 18 * s2 + 32 * s3 - 15 * s4) / h
    d20 = (s - 4.5 * s2 + 6 * s3 - 2.5 * s4) / h
    d01 = (30 * s2 - 60 * s3 + 30 * s4) / h
    d11 = (-12 * s2 + 28 * s3 - 15 * s4) / h
    d21 = (1.5 * s2 - 4 * s3 + 2.5 * s4) / h
    v_ref = d00 * r0 + d10 * v0 + d20 * a0 + d01 * r1 + d11 * v1 + d21 * a1
    return r_ref, v_ref


def _lagrange6_p32(ref: EnckeReference, t_rel):
    """float32 perturbation-table value at times `t_rel` [B]: 6-point
    Lagrange on the grid (a cubic leaves ~1e-9 km/s^2, tens of metres a
    day)."""
    h = ref.stride_s
    x = t_rel / h
    K = ref.p32.shape[0]
    i0 = torch.clamp(torch.floor(x) - 2, 0, K - 6).long()
    s = (x - i0.to(_F64)).to(_F32)[..., None]
    out = torch.zeros(t_rel.shape + (3,), dtype=_F32, device=t_rel.device)
    for m in range(6):
        w = torch.ones_like(s)
        for j in range(6):
            if j != m:
                w = w * (s - j) / float(m - j)
        out = out + w * ref.p32[i0 + m]
    return out


def _adams_coefficients(k: int):
    """Exact Adams-Bashforth (k-step) and Adams-Moulton (k+1 nodes, used
    PECE) weights from the integrated Lagrange basis in `Fraction`s:
    (beta [k], gamma [k+1]) float64, beta on nodes s = 0, -1, .., -(k-1)
    (newest first), gamma on s = +1, 0, .., -(k-1)."""

    def weights(nodes):
        out = []
        for j, sj in enumerate(nodes):
            poly = [Fraction(1)]  # prod_{i != j} (s - s_i), coefficients low to high
            denom = Fraction(1)
            for i, si in enumerate(nodes):
                if i == j:
                    continue
                denom *= sj - si
                poly = [Fraction(0)] + poly
                for d in range(len(poly) - 1):
                    poly[d] -= si * poly[d + 1]
            integ = sum(c / (d + 1) for d, c in enumerate(poly))
            out.append(float(integ / denom))
        return np.asarray(out)

    ab_nodes = [Fraction(-i) for i in range(k)]
    return weights(ab_nodes), weights([Fraction(1)] + ab_nodes)


_ABM_K = 8  # Adams history length (AB8 predictor, AM corrector, PECE)


def propagate_fixed(dyn, ref: EnckeReference, y0_dev, duration_s: float, ctx, p, method,
                    dt_s: float = 150.0, integ: str = "rk", capture_every: int = 0):
    """Synchronized fixed-step deviation propagation of `y0_dev` [B, 9]
    float32 (deviations of position and velocity, then Cr, Cd, propellant
    mass), on its device. Every lane shares the step grid, so the reference
    state and its float32 perturbation at every stage time are tabulated
    in one batched call before the loop, and each stage hands the
    perturbation one shared epoch. `integ` "rk" takes `method`'s tableau
    with a Kahan-compensated update; "abm" the AB8/AM PECE loop (when the
    arc holds at least 16 steps). The grid lands exactly on the end: dt =
    duration / ceil(duration / dt_s).

    Returns (y_final [B, 9] f32, n_steps, cap_t, cap_y): with
    `capture_every` = k > 0, the grid is aligned so that captures tile the
    loop, and cap_t [K] f64 (s) and cap_y [K, B, 9] f32 hold every k-th
    node from t = 0 (the ABM startup's nodes all); else both are None."""
    S = method.stages
    a_tab = np.asarray(method.a_matrix)
    b_tab = np.asarray(method.b)
    c_tab = np.asarray(method.c)
    n_steps = max(1, int(np.ceil(duration_s / dt_s)))
    ce = int(capture_every)
    use_abm = integ == "abm" and n_steps >= 2 * _ABM_K
    if ce > 0:
        start = _ABM_K - 1 if use_abm else 0
        n_steps = start + ce * max(1, int(np.ceil((n_steps - start) / ce)))
    dt = float(duration_s) / n_steps
    dt32 = float(np.float32(dt))
    device = y0_dev.device
    f64 = dict(dtype=_F64, device=device)

    pert = make_perturbation_fn(dyn)
    mu = ctx.frame.mu
    sc32_ref = _sc32(p, p.get("cr_ref", 1.8), p.get("cd_ref", 2.2),
                     p.get("mass_ref_kg", p["dry_mass_kg"]), device)

    def ref_tables(flat_t):
        """(r_ref f64, v_ref f64, p32_ref f32) at shared times [T]."""
        r_ref, v_ref = _quintic(ref, flat_t)
        p32_ref = pert(ctx, ctx.epoch0_tdb + flat_t, r_ref.to(_F32), v_ref.to(_F32), sc32_ref)
        return r_ref, v_ref, p32_ref

    y0_dev = y0_dev.to(_F32)
    # the parameter columns never change in this mode (no thrust)
    sc32 = _sc32(p, y0_dev[..., 6], y0_dev[..., 7], p["dry_mass_kg"] + y0_dev[..., 8], device)

    def stage_accel(t_rel_s, y, r_ref_i, v_ref_i, p32_i):
        """[B, 9] deviation derivative at one shared stage time (0-d)."""
        dr32, dv32 = y[..., 0:3], y[..., 3:6]
        dr = dr32.to(_F64)
        r_full = r_ref_i + dr
        rr2 = torch.sum(r_ref_i * r_ref_i)
        q = torch.sum(dr * (dr + 2.0 * r_ref_i), dim=-1, keepdim=True) / rr2
        fq = 1.0 - (1.0 + q) ** (-1.5)
        rr3 = rr2 * torch.sqrt(rr2)
        da_2b = (-mu / rr3) * (dr - fq * r_full)
        r32 = r_full.to(_F32)
        v32 = (v_ref_i + dv32.to(_F64)).to(_F32)
        dp = pert(ctx, ctx.epoch0_tdb + t_rel_s, r32, v32, sc32) - p32_i
        ddv = da_2b.to(_F32) + dp
        return torch.cat([dv32, ddv, torch.zeros_like(y[..., 6:9])], dim=-1)

    def rk_step(y, comp, t_s, r_s, v_s, p32_s):
        """One S-stage RK step with a Kahan-compensated update; the stage
        rows of one step are t_s [S], r_s, v_s, p32_s [S, 3]."""
        k = [stage_accel(t_s[0], y, r_s[0], v_s[0], p32_s[0])]
        for i in range(1, S):
            wi = float(a_tab[i, 0]) * k[0]
            for j in range(1, i):
                if a_tab[i, j] != 0.0:
                    wi = wi + float(a_tab[i, j]) * k[j]
            k.append(stage_accel(t_s[i], y + dt32 * wi, r_s[i], v_s[i], p32_s[i]))
        acc = float(b_tab[0]) * k[0]
        for i in range(1, S):
            if b_tab[i] != 0.0:
                acc = acc + float(b_tab[i]) * k[i]
        inc_eff = dt32 * acc + comp
        y_new = y + inc_eff
        return y_new, inc_eff - (y_new - y)

    comp0 = torch.zeros_like(y0_dev)
    if use_abm:
        y_fin, cap_t, cap_y = _propagate_abm(ref_tables, stage_accel, rk_step, y0_dev, comp0,
                                             n_steps, dt, dt32, c_tab, ce)
        return y_fin, n_steps, cap_t, cap_y

    t_stage = (dt * torch.arange(n_steps, **f64))[:, None] + torch.as_tensor(c_tab, **f64) * dt
    r_ref, v_ref, p32_ref = (x.reshape(n_steps, S, 3) for x in ref_tables(t_stage.reshape(-1)))
    y, comp = y0_dev, comp0
    caps = [y0_dev]
    for n in range(n_steps):
        y, comp = rk_step(y, comp, t_stage[n], r_ref[n], v_ref[n], p32_ref[n])
        if ce > 0 and (n + 1) % ce == 0:
            caps.append(y)
    if ce > 0:
        cap_t = dt * ce * torch.arange(n_steps // ce + 1, **f64)
        return y, n_steps, cap_t, torch.stack(caps)
    return y, n_steps, None, None


def _propagate_abm(ref_tables, stage_accel, rk_step, y0_dev, comp0, n_steps: int, dt: float,
                   dt32: float, c_tab, capture_every: int = 0):
    """The AB8/AM PECE main loop of the fixed-step mode: two perturbation
    evaluations a step (predict, correct) instead of an RK step's S. The
    first k - 1 steps are RK steps, which seed the f-history at the first
    k grid nodes; the coefficients are exact (`_adams_coefficients`).
    Returns (y_final, cap_t, cap_y) as `propagate_fixed` describes."""
    k_hist = _ABM_K
    beta, gamma = _adams_coefficients(k_hist)
    beta32 = [float(np.float32(b)) for b in beta]
    gamma32 = [float(np.float32(g)) for g in gamma]
    S = len(c_tab)
    device = y0_dev.device
    f64 = dict(dtype=_F64, device=device)

    t_nodes = dt * torch.arange(n_steps + 1, **f64)
    rN, vN, pN = ref_tables(t_nodes)
    t_stage = (dt * torch.arange(k_hist - 1, **f64))[:, None] + torch.as_tensor(c_tab, **f64) * dt
    rS, vS, pS = (x.reshape(k_hist - 1, S, 3) for x in ref_tables(t_stage.reshape(-1)))

    y, comp = y0_dev, comp0
    fhist = [stage_accel(t_nodes[0], y0_dev, rN[0], vN[0], pN[0])]  # newest first
    caps = [y0_dev]
    for n in range(k_hist - 1):
        y, comp = rk_step(y, comp, t_stage[n], rS[n], vS[n], pS[n])
        fhist.insert(0, stage_accel(t_nodes[n + 1], y, rN[n + 1], vN[n + 1], pN[n + 1]))
        caps.append(y)

    ce = capture_every
    for n in range(k_hist, n_steps + 1):
        t1, r1, v1, p1 = t_nodes[n], rN[n], vN[n], pN[n]
        acc_p = beta32[0] * fhist[0]
        for j in range(1, k_hist):
            acc_p = acc_p + beta32[j] * fhist[j]
        f_p = stage_accel(t1, y + dt32 * acc_p, r1, v1, p1)
        acc_c = gamma32[0] * f_p
        for j in range(1, k_hist + 1):
            acc_c = acc_c + gamma32[j] * fhist[j - 1]
        inc_eff = dt32 * acc_c + comp
        y_new = y + inc_eff
        comp = inc_eff - (y_new - y)
        y = y_new
        fhist = [stage_accel(t1, y, r1, v1, p1)] + fhist[:-1]
        if ce > 0 and (n - (k_hist - 1)) % ce == 0:
            caps.append(y)

    if ce > 0:
        n_outer = (n_steps - (k_hist - 1)) // ce
        cap_t = torch.cat([t_nodes[:k_hist],
                           t_nodes[k_hist - 1] + dt * ce * torch.arange(1, n_outer + 1, **f64)])
        return y, cap_t, torch.stack(caps)
    return y, None, None


def make_encke_eom(dyn, ref: EnckeReference):
    """Deviation EOM `(t_rel [B], y [B, 9] f32, ctx, p) -> [B, 9] f32` for the
    adaptive integrator; y = [delta_r (km), delta_v (km/s), Cr, Cd, prop
    mass], the last three riding along (no thrust in this mode)."""
    pert = make_perturbation_fn(dyn)

    def eom(t_rel, y, ctx, p):
        dr32, dv32 = y[..., 0:3], y[..., 3:6]
        r_ref, v_ref = _quintic(ref, t_rel)
        dr = dr32.to(_F64)
        r_full = r_ref + dr
        mu = ctx.frame.mu
        rr2 = torch.sum(r_ref * r_ref, dim=-1, keepdim=True)
        q = torch.sum(dr * (dr + 2.0 * r_ref), dim=-1, keepdim=True) / rr2
        fq = 1.0 - (1.0 + q) ** (-1.5)
        rr3 = rr2 * torch.sqrt(rr2)
        da_2b = (-mu / rr3) * (dr - fq * r_full)
        r32 = r_full.to(_F32)
        v32 = (v_ref + dv32.to(_F64)).to(_F32)
        sc32 = _sc32(p, y[..., 6], y[..., 7], p["dry_mass_kg"] + y[..., 8], y.device)
        dp = pert(ctx, ctx.epoch0_tdb + t_rel, r32, v32, sc32) - _lagrange6_p32(ref, t_rel)
        ddv = da_2b.to(_F32) + dp
        return torch.cat([dv32, ddv, torch.zeros_like(y[..., 6:9])], dim=-1)

    return eom
