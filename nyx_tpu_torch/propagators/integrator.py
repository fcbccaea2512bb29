"""Batched adaptive Runge-Kutta integration.

Torch port of nyx_tpu/propagators/integrator.py. Every lane advances
together, each with its own step size, attempt counter and status; rejected
lanes shrink their step and retry on the next iteration, finished lanes are
masked no-ops. Step control follows GMAT/Nyx: accept when err <= tol or
|h| <= min_step or attempts >= max; grow by 0.9 (tol/err)^(1/order), shrink
by 0.9 (tol/err)^(1/(order-1)); the last step is clamped to land exactly on
the stop time and is accepted or rejected like any other.

The reference's `lax.while_loop` becomes a host loop over masked steps. It
asks the device whether any lane is still RUNNING after 1, 2, 4 and 8
steps, then once every CHECK_EVERY steps: the steps in between are exact
no-ops for finished lanes, so the result equals a check after every step
(the contract of the reference's fixed-trip `loop_mode="scan"`), with one
host sync per chunk, and a short propagation (a targeter's segment) runs
no more than twice its steps.
Fixed-step integration (`options.fixed_step`, or a fixed-only method such
as RK4Fixed) takes zero error, accepts every step and keeps h, the last
step clamped like any other. `_rk_stages` also serves the OD filter's one
fixed RK step per gap (the reference's `_rk_stages_looped` computes the
same increment with its stages in a scan).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..tracing import annotate
from .options import IntegratorOptions
from .tableaus import IntegratorMethod

# Lane status codes
RUNNING = 0
DONE = 1
FAILED_NAN = 2
# Steps between two host checks for a lane still RUNNING.
CHECK_EVERY = 16
# Extra checks before the first CHECK_EVERY steps.
_EARLY_CHECKS = (1, 2, 4, 8)


class PropResult(NamedTuple):
    t: torch.Tensor  # [B] seconds relative to the integration start
    y: torch.Tensor  # [B, N]
    status: torch.Tensor  # [B] int32
    n_accepted: torch.Tensor  # [B] int32
    n_rejected: torch.Tensor  # [B] int32
    error: torch.Tensor  # [B] last error estimate
    step: torch.Tensor  # [B] next (signed) step size, s
    # with n_capture > 0: accepted steps' times [B, K], states [B, K, N]
    # and the count written [B] (saturating at K)
    traj_t: Optional[torch.Tensor] = None
    traj_y: Optional[torch.Tensor] = None
    traj_len: Optional[torch.Tensor] = None
    # iterations of the host loop (attempted steps of the slowest lane,
    # rounded up to a power of two below CHECK_EVERY, else to a multiple
    # of it)
    iterations: int = 0


def _rk_stages(eom, a, b, b_star, c, t, y, h):
    """All stages of one RK step for every lane. Returns (increment,
    error vector); the caller applies the increment."""
    stages = b.shape[0]
    # the step at the state's dtype keeps the combinations there (an f64
    # step would promote a float32 state)
    hb = h.to(y.dtype)[:, None]
    k = [eom(t, y)]
    for i in range(1, stages):
        wi = float(a[i, 0]) * k[0]
        for j in range(1, i):
            if a[i, j] != 0.0:
                wi = wi + float(a[i, j]) * k[j]
        k.append(eom(t + float(c[i]) * h, y + hb * wi))
    acc = float(b[0]) * k[0]
    err = float(b[0] - b_star[0]) * k[0]
    for i in range(1, stages):
        if b[i] != 0.0:
            acc = acc + float(b[i]) * k[i]
        if (b[i] - b_star[i]) != 0.0:
            err = err + float(b[i] - b_star[i]) * k[i]
    return hb * acc, hb * err


def propagate(
    eom: Callable,
    y0: torch.Tensor,
    duration_s,
    options: IntegratorOptions,
    method: IntegratorMethod = IntegratorMethod.RK89,
    finally_fn: Optional[Callable] = None,
    eom_args: tuple = (),
    n_capture: int = 0,
    capture_stride: int = 1,
    state_dtype: torch.dtype = torch.float64,
    t0=None,
) -> PropResult:
    """Propagate a batch of states `y0` [B, N] for `duration_s` (float, or
    [B] tensor; may be negative), on the device of `y0`.

    `eom(t [B], y [B, N], *eom_args) -> [B, N]`; `finally_fn(t, y,
    *eom_args) -> y` runs on every accepted step (Dynamics::finally).
    `n_capture` > 0 keeps every `capture_stride`-th accepted step (and the
    last) of each lane in a K = n_capture buffer, as the reference does
    (integrator.py:377-395): a full buffer overwrites its last slot, and
    `traj_len` saturates at K, which callers read as "grow and rerun".
    The writes are masked index writes on the device, with no host sync.
    `state_dtype` is the dtype of the state, its Kahan compensation, the
    RK combinations and the capture buffer (float32 for the Encke
    deviation lanes, mc/encke.py); time, steps and the error norm stay
    float64, as in the reference (integrator.py:155,184-195).
    `t0` (float, or [B] tensor; default 0) is the time the lanes start
    at: the EOM sees `t0 + elapsed`, and the result's times are on that
    clock (the reference's `t0`, integrator.py:200-204).
    """
    if y0.dtype != state_dtype or y0.dim() != 2:
        raise ValueError(f"y0 must be a [B, N] {state_dtype} tensor, got {y0.dtype} {tuple(y0.shape)}")
    if eom_args:
        inner_eom, inner_fin = eom, finally_fn
        eom = lambda t, y: inner_eom(t, y, *eom_args)  # noqa: E731
        if inner_fin is not None:
            finally_fn = lambda t, y: inner_fin(t, y, *eom_args)  # noqa: E731
    with annotate("integ.propagate", lanes=y0.shape[0]) as span:
        B, N = y0.shape
        f64 = dict(dtype=torch.float64, device=y0.device)
        i32 = dict(dtype=torch.int32, device=y0.device)
        if isinstance(duration_s, torch.Tensor):
            dur = duration_s.to(**f64).expand(B)
        else:
            dur = torch.full((B,), float(duration_s), **f64)
        t = torch.zeros(B, **f64)
        if t0 is not None:
            t = t + (t0.to(**f64) if isinstance(t0, torch.Tensor) else float(t0))
        t_stop = t + dur
        sgn = torch.where(dur < 0, -1.0, torch.ones_like(dur))

        a, b, b_star, c = method.a_matrix, method.b, method.b_star, method.c
        order = float(method.order)
        fixed = options.fixed_step or method.is_fixed_only
        min_step, max_step = options.min_step_s, options.max_step_s
        tol, max_attempts = options.tolerance, options.attempts

        y = y0 if finally_fn is None else finally_fn(t, y0)
        h = sgn * min(options.init_step_s, options.max_step_s)
        status = torch.where(dur == 0.0, DONE, RUNNING).to(torch.int32)
        attempts = torch.ones(B, **i32)
        error = torch.zeros(B, **f64)
        n_acc = torch.zeros(B, **i32)
        n_rej = torch.zeros(B, **i32)
        comp = torch.zeros_like(y)  # Kahan compensation of the state updates
        K = int(n_capture)
        if K > 0:
            # column K is a drop slot for lanes that write nothing this step
            lanes = torch.arange(B, device=y0.device)
            traj_t = torch.zeros(B, K + 1, **f64)
            traj_y = torch.zeros(B, K + 1, N, dtype=state_dtype, device=y0.device)
            traj_len = torch.zeros(B, **i32)

        n_iter = 0
        for it in range(options.max_iterations):
            if it % CHECK_EVERY == 0 or it in _EARLY_CHECKS:
                with annotate("integ.check"):
                    running_any = bool((status == RUNNING).any())
                if not running_any:
                    break
            n_iter = it + 1
            with annotate("integ.step"):
                running = status == RUNNING
                # clamp the final step to land exactly on the stop time
                overshoot = (t + h) * sgn > t_stop * sgn
                h_use = torch.where(overshoot, t_stop - t, h)

                inc, err_vec = _rk_stages(eom, a, b, b_star, c, t, y, h_use)
                # Kahan-compensated update: the rounding of y + inc is re-injected
                # into the next accepted step
                inc_eff = inc + comp
                next_y = y + inc_eff
                comp_new = inc_eff - (next_y - y)

                if fixed:
                    err = torch.zeros(B, **f64)
                    accept = torch.ones(B, dtype=torch.bool, device=y0.device)
                else:
                    err = options.error_ctrl(err_vec, next_y, y).to(torch.float64)
                    # A clamped (overshooting) step is NOT force-accepted: the first
                    # step can overshoot, and a rejected clamped step shrinks h and
                    # retries like any other.
                    accept = (
                        (err <= tol)
                        | (torch.abs(h_use) <= min_step * (1 + 1e-12))
                        | (attempts >= max_attempts)
                    )

                t_new = t + h_use
                finished = overshoot | ((t_new - t_stop) * sgn >= 0.0)
                nan_lane = ~torch.all(torch.isfinite(next_y), dim=-1)
                do_accept = running & accept
                do_reject = running & ~accept

                # step-size adaptation (signed), f64 pow
                safe_err = torch.clamp(err, min=1e-300)
                f_grow = (tol / safe_err) ** (1.0 / order)
                f_shrink = (tol / safe_err) ** (1.0 / (order - 1.0))
                grow = 0.9 * torch.abs(h) * f_grow
                shrink = 0.9 * torch.abs(h_use) * f_shrink
                if fixed:
                    h_acc = torch.abs(h)
                else:
                    h_acc = torch.where(err < tol, torch.clamp(grow, max=max_step), torch.abs(h))
                    h_acc = torch.clamp(h_acc, min=min_step)
                h_rej = torch.clamp(shrink, min=min_step)
                h = torch.where(do_accept, sgn * h_acc, torch.where(do_reject, sgn * h_rej, h))

                y_out = torch.where(do_accept[:, None], next_y, y)
                comp = torch.where(do_accept[:, None], comp_new, comp)
                if finally_fn is not None:
                    y_out = torch.where(do_accept[:, None], finally_fn(t_new, y_out), y_out)
                y = y_out
                t = torch.where(do_accept, t_new, t)

                status = torch.where(
                    do_accept & nan_lane,
                    FAILED_NAN,
                    torch.where(do_accept & finished, DONE, status),
                )
                n_acc = n_acc + do_accept.to(torch.int32)
                n_rej = n_rej + do_reject.to(torch.int32)
                attempts = torch.where(do_accept, 1, torch.where(do_reject, attempts + 1, attempts))
                error = torch.where(running, err, error)

                if K > 0:
                    want = do_accept & (((n_acc - 1) % capture_stride == 0) | finished)
                    slot = torch.where(want, torch.clamp(traj_len, max=K - 1), K).long()
                    traj_t[lanes, slot] = t_new
                    traj_y[lanes, slot] = next_y
                    traj_len = torch.clamp(traj_len + want.to(torch.int32), max=K)

        res = PropResult(
            t=t, y=y, status=status, n_accepted=n_acc, n_rejected=n_rej, error=error, step=h,
            iterations=n_iter,
        )
        span.set(iterations=n_iter)
        if K > 0:
            res = res._replace(traj_t=traj_t[:, :K], traj_y=traj_y[:, :K], traj_len=traj_len)
        return res
