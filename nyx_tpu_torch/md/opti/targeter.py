"""Differential-correction targeter (Newton-Raphson).

Torch port of nyx_tpu/md/opti/targeter.py:33-548 (the reference's Targeter,
md/opti/targeter.rs:37-280, with try_achieve_fd and try_achieve_dual). The
three modes propagate on the device, the Newton algebra stays numpy
float64 on the host, as in the reference:

- FD: the nominal and each perturbed variable run as one [V+1, 9] batch a
  Newton iteration (the reference's rayon fan-out becomes lanes);
- dual: one [1, 90] propagation of the state and its STM, chained with
  d(objectives)/d(final state) from `torch.func.jacfwd` of `param.value`;
- finite burn (`thrust_dir`, `thrust_dir_rate`, `thrust_profile`): the
  nominal and perturbed maneuvers as one [V+1, 10] guided batch whose
  `ParametricManeuver` reads per-lane `ctx.guidance_params` [V+1, 12].

The damped Newton step with backtracking, the lstsq/pinv solve and the
finite-burn mode's trust-region equilibration are the reference's. Each
Targeter keeps its EOMs across calls, as the reference keeps its compiled
runs; the context is built once a solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as _replace
from typing import Sequence

import numpy as np
import torch

from ...cosmic.spacecraft import GuidanceMode, Spacecraft
from ...dynamics.guidance import LocalFrame, Maneuver, ParametricManeuver
from ...errors import TargetingError
from ...propagators import integrator
from ...time import Epoch
from ..objective import Objective
from ..param import value as param_value
from .target_variable import Variable, Vary

STATE_DIM = 9


@dataclass
class TargeterSolution:
    """A finished solve (md/opti/solution.rs)."""

    corrected_state: Spacecraft  # state at the correction epoch, corrected
    achieved_state: Spacecraft  # state at the achievement epoch
    correction: np.ndarray  # [V]
    iterations: int  # Newton iterations
    achieved_errors: np.ndarray  # [O] residual error of each objective
    converged: bool
    #: the corrected finite-burn maneuver (thrust targeters only)
    maneuver: object = None
    #: integrator iterations summed over the solve's propagations
    prop_iterations: int = 0

    @property
    def is_finite_burn(self) -> bool:
        return self.maneuver is not None

    def to_mnvr(self):
        """The corrected Maneuver (solution.rs:64 to_mnvr)."""
        if self.maneuver is None:
            raise TargetingError("solution is not a finite-burn correction")
        return self.maneuver

    def __str__(self):
        tag = "converged" if self.converged else "NOT CONVERGED"
        return (f"TargeterSolution({tag} in {self.iterations} iterations, "
                f"correction {self.correction}, errors {self.achieved_errors})")


def _dcm(frame: str, sc: Spacecraft) -> np.ndarray:
    """Local `frame` -> inertial DCM at the spacecraft's state (host)."""
    r = torch.from_numpy(np.asarray(sc.orbit.r_km, np.float64))
    v = torch.from_numpy(np.asarray(sc.orbit.v_km_s, np.float64))
    return LocalFrame.dcm_to_inertial(frame, r, v).numpy()


class Targeter:
    """V correction variables, O objectives (targeter.rs:37-81)."""

    def __init__(self, prop, variables: Sequence[Variable], objectives: Sequence[Objective],
                 frame: str = LocalFrame.Inertial, iterations: int = 100, almanac=None):
        self.prop = prop
        self.variables = tuple(variables)
        self.objectives = tuple(objectives)
        self.frame = frame
        self.iterations = iterations
        self.almanac = almanac
        self._eom_cache = {}

    # -- constructors (targeter.rs:84-212) ------------------------------
    @classmethod
    def delta_v(cls, prop, objectives, **kw) -> "Targeter":
        return cls(prop, [Variable.from_vary(v) for v in Vary.VELOCITIES], objectives,
                   frame=LocalFrame.Inertial, **kw)

    @classmethod
    def delta_r(cls, prop, objectives, **kw) -> "Targeter":
        return cls(prop, [Variable.from_vary(v) for v in Vary.POSITIONS], objectives,
                   frame=LocalFrame.Inertial, **kw)

    @classmethod
    def vnc(cls, prop, objectives, **kw) -> "Targeter":
        return cls(prop, [Variable.from_vary(v) for v in Vary.VELOCITIES], objectives,
                   frame=LocalFrame.VNC, **kw)

    @classmethod
    def in_frame(cls, prop, varies, objectives, frame, **kw) -> "Targeter":
        return cls(prop, [Variable.from_vary(v) for v in varies], objectives, frame=frame, **kw)

    @classmethod
    def thrust_dir(cls, prop, objectives, mnvr0, **kw) -> "Targeter":
        """Correct the burn's constant direction and throttle."""
        return cls._thrust(prop, objectives, mnvr0,
                           (Vary.ThrustX, Vary.ThrustY, Vary.ThrustZ, Vary.ThrustLevel), **kw)

    @classmethod
    def thrust_dir_rate(cls, prop, objectives, mnvr0, **kw) -> "Targeter":
        """Direction, its rates and the throttle."""
        return cls._thrust(prop, objectives, mnvr0,
                           (Vary.ThrustX, Vary.ThrustY, Vary.ThrustZ, Vary.ThrustLevel,
                            Vary.ThrustRateX, Vary.ThrustRateY, Vary.ThrustRateZ), **kw)

    @classmethod
    def thrust_profile(cls, prop, objectives, mnvr0, **kw) -> "Targeter":
        """The full quadratic direction profile and the throttle."""
        return cls._thrust(prop, objectives, mnvr0,
                           (Vary.ThrustX, Vary.ThrustY, Vary.ThrustZ, Vary.ThrustLevel,
                            Vary.ThrustRateX, Vary.ThrustRateY, Vary.ThrustRateZ,
                            Vary.ThrustAccelX, Vary.ThrustAccelY, Vary.ThrustAccelZ), **kw)

    @classmethod
    def _thrust(cls, prop, objectives, mnvr0, varies, **kw) -> "Targeter":
        out = cls(prop.with_guidance(ParametricManeuver(frame=mnvr0.frame)),
                  [Variable.from_vary(v) for v in varies], objectives, frame=mnvr0.frame, **kw)
        out._mnvr0 = mnvr0
        out._coast_prop = prop
        return out

    # ------------------------------------------------------------------
    def _apply_correction(self, sc: Spacecraft, correction: np.ndarray) -> Spacecraft:
        """Add the correction (in `self.frame` at `sc`) to the position and
        velocity blocks."""
        delta = np.zeros(6)
        for var, c in zip(self.variables, correction):
            delta[var.slot] += c
        if self.frame != LocalFrame.Inertial:
            dcm = _dcm(self.frame, sc)
            delta = np.concatenate([dcm @ delta[0:3], dcm @ delta[3:6]])
        vec = sc.to_vector()
        vec[0:6] += delta
        return sc.set_vector(sc.epoch, vec)

    def _objective_values(self, y, mu, radius_km):
        """[..., O] objective values of flat states y [..., 9]."""
        return torch.stack([param_value(o.parameter, y, mu, radius_km) for o in self.objectives], dim=-1)

    def _run(self, y0, dt, ctx, sc_params, with_stm: bool, thruster=None):
        key = (with_stm, thruster)
        if key not in self._eom_cache:
            dyn = self.prop.dynamics
            self._eom_cache[key] = (dyn.make_eom(with_stm, thruster=thruster), dyn.make_finally())
        eom, finally_fn = self._eom_cache[key]
        return integrator.propagate(eom, y0, dt, self.prop.opts, self.prop.method,
                                    finally_fn=finally_fn, eom_args=(ctx, sc_params))

    def _errors(self, achieved: np.ndarray) -> np.ndarray:
        return np.array([obj.assess_raw(float(a))[1] for obj, a in zip(self.objectives, achieved)])

    def _met(self, errs) -> bool:
        return all(abs(e) <= o.tolerance for e, o in zip(errs, self.objectives))

    @staticmethod
    def _sc_params(sc: Spacecraft) -> dict:
        return dict(dry_mass_kg=sc.dry_mass_kg, srp_area_m2=sc.srp_area_m2, drag_area_m2=sc.drag_area_m2)

    # ------------------------------------------------------------------
    def try_achieve_from(self, initial_state: Spacecraft, correction_epoch: Epoch,
                         achievement_epoch: Epoch, method: str = "fd", *,
                         device="cuda") -> TargeterSolution:
        """Newton-Raphson on `device` to meet the objectives at
        `achievement_epoch` by varying the state at `correction_epoch`
        (targeter.rs:246, raphson_finite_diff.rs:42-360). method "fd" or
        "dual"; finite-burn variables take the finite-burn mode."""
        device = torch.device(device)
        if any(v.is_finite_burn for v in self.variables):
            return self._try_achieve_mnvr(initial_state, correction_epoch, achievement_epoch, device)
        sc0 = initial_state
        prop_iters = 0
        dt0 = (correction_epoch - sc0.epoch).to_seconds()
        if abs(dt0) > 1e-9:
            inst = self.prop.with_state(sc0, self.almanac, device=device)
            sc0 = inst.for_duration(dt0)
            prop_iters += inst.last_result.iterations
        dt = (achievement_epoch - correction_epoch).to_seconds()

        mu = sc0.frame.mu
        radius_km = sc0.frame.radius_km or 0.0
        ctx = self.prop.dynamics.build_context(correction_epoch, dt, self.almanac, device=device)
        sc_params = self._sc_params(sc0)
        correction = np.array([v.init_guess for v in self.variables])
        nvars = len(self.variables)
        use_fd = method == "fd"
        tols = np.array([o.tolerance for o in self.objectives])

        # damped Newton: a step that worsens the tolerance-weighted error
        # norm is rejected and halved (the undamped reference iteration can
        # limit-cycle on multi-objective problems)
        prev_norm = prev_correction = applied_dx = None
        backtracks = 0
        converged = False
        it = 0
        for it in range(1, self.iterations + 1):
            xc = self._apply_correction(sc0, correction)
            y_nom = xc.to_vector()
            if use_fd:
                rows = [y_nom]
                for i, var in enumerate(self.variables):
                    pert = np.zeros(nvars)
                    pert[i] = var.perturbation
                    rows.append(self._apply_correction(sc0, correction + pert).to_vector())
                y0 = torch.as_tensor(np.stack(rows), dtype=torch.float64, device=device)
                res = self._run(y0, dt, ctx, sc_params, with_stm=False)
                achieved = self._objective_values(res.y[:, :STATE_DIM], mu, radius_km).cpu().numpy()
                yf = res.y[0, :STATE_DIM].cpu().numpy()
            else:
                y0 = torch.as_tensor(np.concatenate([y_nom, np.eye(STATE_DIM).ravel()]),
                                     dtype=torch.float64, device=device)[None, :]
                res = self._run(y0, dt, ctx, sc_params, with_stm=True)
                row = res.y[0].cpu().numpy()
                yf = row[0:STATE_DIM]
                phi = row[STATE_DIM:STATE_DIM * (STATE_DIM + 1)].reshape(STATE_DIM, STATE_DIM)
                achieved = self._objective_values(torch.from_numpy(yf), mu, radius_km).numpy()[None, :]
            prop_iters += res.iterations
            errs = self._errors(achieved[0])
            if self._met(errs):
                converged = True
                break

            norm = float(np.linalg.norm(errs / tols))
            if (prev_norm is not None and norm > prev_norm and backtracks < 10
                    and np.linalg.norm(applied_dx) > 1e-14):
                # reject the last Newton step: halve it and retry
                applied_dx = applied_dx / 2.0
                correction = prev_correction + applied_dx
                backtracks += 1
                continue
            backtracks = 0

            jac = np.empty((len(self.objectives), nvars))
            if use_fd:
                for i, var in enumerate(self.variables):
                    jac[:, i] = (achieved[i + 1] - achieved[0]) / var.perturbation
            else:
                dobj_dyf = torch.func.jacfwd(
                    lambda y: self._objective_values(y, mu, radius_km))(torch.from_numpy(yf)).numpy()
                dcm = np.eye(3) if self.frame == LocalFrame.Inertial else _dcm(self.frame, xc)
                for i, var in enumerate(self.variables):
                    e9 = np.zeros(STATE_DIM)
                    block = var.slot // 3 * 3
                    e9[block:block + 3] = dcm[:, var.slot % 3]
                    jac[:, i] = dobj_dyf @ (phi @ e9)

            # errs are (desired - achieved): the Newton step solves J dx = errs
            try:
                dx = np.linalg.lstsq(jac, errs, rcond=None)[0]
            except np.linalg.LinAlgError:
                dx = np.linalg.pinv(jac) @ errs
            dx = np.array([var.check_step(d) for var, d in zip(self.variables, dx)])
            prev_norm = norm
            prev_correction = correction.copy()
            correction = np.array([var.apply_bounds(c + d)
                                   for var, c, d in zip(self.variables, correction, dx)])
            applied_dx = correction - prev_correction

        xc = self._apply_correction(sc0, correction)
        return TargeterSolution(xc, xc.set_vector(achievement_epoch, yf), correction, it, errs,
                                converged=converged, prop_iterations=prop_iters)

    def try_achieve_fd(self, initial_state, correction_epoch, achievement_epoch, *, device="cuda"):
        return self.try_achieve_from(initial_state, correction_epoch, achievement_epoch, "fd",
                                     device=device)

    def try_achieve_dual(self, initial_state, correction_epoch, achievement_epoch, *, device="cuda"):
        return self.try_achieve_from(initial_state, correction_epoch, achievement_epoch, "dual",
                                     device=device)

    # ------------------------------------------------------------------
    def _try_achieve_mnvr(self, initial_state, correction_epoch, achievement_epoch, device):
        """Finite-burn correction: Newton-Raphson on the ParametricManeuver's
        12 parameters, the nominal and perturbed maneuvers a [V+1] batch
        with per-lane guidance parameters (targeter.py:395-548)."""
        if initial_state.thruster is None:
            raise TargetingError("finite-burn targeting needs a thruster")
        mnvr0 = getattr(self, "_mnvr0", None)
        if mnvr0 is None:
            raise TargetingError(
                "use Targeter.thrust_dir/_dir_rate/_profile to build a finite-burn targeter")
        params0 = ParametricManeuver.params_from_maneuver(mnvr0)

        # coast to the correction epoch with the unguided propagator
        sc0 = initial_state
        prop_iters = 0
        dt0 = (correction_epoch - sc0.epoch).to_seconds()
        if abs(dt0) > 1e-9:
            inst = self._coast_prop.with_state(sc0, self.almanac, device=device)
            sc0 = inst.for_duration(dt0)
            prop_iters += inst.last_result.iterations
        dt = (achievement_epoch - correction_epoch).to_seconds()

        mu = sc0.frame.mu
        radius_km = sc0.frame.radius_km or 0.0
        base_ctx = self.prop.dynamics.build_context(correction_epoch, dt, self.almanac, device=device)
        sc_params = self._sc_params(sc0)
        tols = np.array([o.tolerance for o in self.objectives])
        nvars = len(self.variables)

        # the initial mode from the burn window at the correction epoch
        t0_tdb = correction_epoch.to_tdb_seconds()
        mode0 = GuidanceMode.Thrust if params0[0] <= t0_tdb < params0[1] else GuidanceMode.Coast
        y0 = torch.as_tensor(np.tile(np.concatenate([sc0.to_vector(), [float(mode0)]]), (nvars + 1, 1)),
                             dtype=torch.float64, device=device)

        def apply(correction):
            p = params0.copy()
            for var, c in zip(self.variables, correction):
                p[var.pslot] += c
            return p

        correction = np.array([v.init_guess for v in self.variables])
        prev_norm = prev_correction = applied_dx = None
        backtracks = 0
        it = 0
        for it in range(1, self.iterations + 1):
            rows = [apply(correction)]
            for i, var in enumerate(self.variables):
                pert = np.zeros(nvars)
                pert[i] = var.perturbation
                rows.append(apply(correction + pert))
            ctx = _replace(base_ctx, guidance_params=torch.as_tensor(
                np.stack(rows), dtype=torch.float64, device=device))
            res = self._run(y0, dt, ctx, sc_params, with_stm=False, thruster=sc0.thruster)
            prop_iters += res.iterations
            achieved = self._objective_values(res.y[:, :STATE_DIM], mu, radius_km).cpu().numpy()
            yf = res.y[0, :STATE_DIM].cpu().numpy()
            errs = self._errors(achieved[0])
            if self._met(errs):
                break

            norm = float(np.linalg.norm(errs / tols))
            if (prev_norm is not None and norm > prev_norm and backtracks < 10
                    and np.linalg.norm(applied_dx) > 1e-14):
                applied_dx = applied_dx / 2.0
                correction = prev_correction + applied_dx
                backtracks += 1
                continue
            backtracks = 0

            jac = np.empty((len(self.objectives), nvars))
            for i, var in enumerate(self.variables):
                jac[:, i] = (achieved[i + 1] - achieved[0]) / var.perturbation
            # trust-region equilibration: columns scaled by each variable's
            # natural step, rows by the objective's tolerance (the raw
            # Jacobian mixes units, throttle ~1 and rates ~1e-4/s, and a
            # min-norm lstsq on it starves the small-scaled variables)
            scale = np.array([v.max_step for v in self.variables])
            w = 1.0 / tols
            a = jac * scale[None, :] * w[:, None]
            try:
                dxs = np.linalg.lstsq(a, errs * w, rcond=None)[0]
            except np.linalg.LinAlgError:
                dxs = np.linalg.pinv(a) @ (errs * w)
            dx = np.array([v.check_step(d) for v, d in zip(self.variables, dxs * scale)])
            prev_norm = norm
            prev_correction = correction.copy()
            # bounds hold the correction itself, except the throttle's,
            # whose ABSOLUTE level stays inside (0, 1]
            correction = np.array([
                var.apply_bounds(c + d) if var.component != Vary.ThrustLevel
                else np.clip(c + d, var.min_value - params0[2], var.max_value - params0[2])
                for var, c, d in zip(self.variables, prev_correction, dx)
            ])
            applied_dx = correction - prev_correction

        p_fin = apply(correction)
        vec, rate, acc = p_fin[3:6], p_fin[6:9], p_fin[9:12]
        mnvr = Maneuver(
            start=mnvr0.start + (p_fin[0] - params0[0]),
            end=mnvr0.end + (p_fin[1] - params0[1]),
            thrust_prct=float(p_fin[2]),
            vector=vec / np.linalg.norm(vec),
            vector_rate=rate if np.any(rate) else None,
            vector_accel=acc if np.any(acc) else None,
            frame=mnvr0.frame,
        )
        return TargeterSolution(sc0, sc0.set_vector(achievement_epoch, yf), correction, it, errs,
                                self._met(errs), maneuver=mnvr, prop_iterations=prop_iters)
