"""Impulsive-to-finite-burn conversion (md/opti/convert_impulsive.rs:37).

Torch port of nyx_tpu/md/opti/convert_impulsive.py:22-90: an instantaneous
delta-v becomes a full-throttle finite burn centred on the impulse epoch,
its duration from the rocket equation and its initial direction the
delta-v's; a finite-burn targeter (direction, its rates, start epoch and
duration; one batched propagation a Newton iteration, on the device)
corrects it until the post-burn state matches the impulsive trajectory.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ...constants import STD_GRAVITY_M_S2
from ...dynamics.guidance import LocalFrame, Maneuver
from ...errors import TargetingError
from ..objective import Objective
from .target_variable import Vary
from .targeter import Targeter, TargeterSolution


def convert_impulsive_mnvr(spacecraft, dv_km_s, prop, almanac=None, settle_time_s: float = 900.0,
                           pos_tol_km: float = 0.01, vel_tol_km_s: float = 1e-5, *,
                           device="cuda") -> TargeterSolution:
    """The finite-burn equivalent of an impulsive `dv_km_s` (inertial)
    applied at `spacecraft.epoch`: a TargeterSolution whose `.maneuver`
    reproduces the impulsive state `settle_time_s` after the burn to the
    tolerances."""
    if spacecraft.thruster is None:
        raise TargetingError("impulsive conversion needs a thruster")
    dv = np.asarray(dv_km_s, dtype=np.float64)
    dv_mag = float(np.linalg.norm(dv))
    if dv_mag <= 0.0:
        raise TargetingError("zero delta-v")
    thruster = spacecraft.thruster
    v_ex_m_s = thruster.isp_s * STD_GRAVITY_M_S2
    mass_kg = spacecraft.dry_mass_kg + spacecraft.prop_mass_kg
    # rocket-equation burn duration at full throttle (convert_impulsive.rs:68)
    delta_tfb = (v_ex_m_s * mass_kg / thruster.thrust_N) * (1.0 - np.exp(-dv_mag * 1e3 / v_ex_m_s))

    start = spacecraft.epoch - 0.5 * delta_tfb
    end = spacecraft.epoch + 0.5 * delta_tfb
    mnvr0 = Maneuver.from_time_invariant(start, end, 1.0, dv / dv_mag, LocalFrame.Inertial)

    # the target: the impulsive trajectory's state after the settle time
    achieve = end + settle_time_s
    target_vec = prop.with_state(spacecraft.with_dv(dv), almanac, device=device).until_epoch(achieve).to_vector()
    objectives = [Objective(p, float(target_vec[i]), pos_tol_km if i < 3 else vel_tol_km_s)
                  for i, p in enumerate(("x", "y", "z", "vx", "vy", "vz"))]

    # resolve the burn with a max step well below its duration
    if prop.opts.max_step_s > max(delta_tfb / 4.0, 10.0):
        prop = type(prop)(prop.dynamics, prop.method,
                          replace(prop.opts, max_step_s=max(delta_tfb / 4.0, 10.0)))
    # correct the direction profile and the burn's timing (StartEpoch,
    # Duration): the rocket equation fixes the total delta-v at full
    # throttle, so the timing absorbs the along-track centroid offset; the
    # correction epoch sits 2 min before the nominal start, so a negative
    # StartEpoch correction stays inside the propagation
    pre = prop.with_state(spacecraft, almanac, device=device).until_epoch(start - 120.0)
    tgt = Targeter._thrust(prop, objectives, mnvr0,
                           (Vary.ThrustX, Vary.ThrustY, Vary.ThrustZ,
                            Vary.ThrustRateX, Vary.ThrustRateY, Vary.ThrustRateZ,
                            Vary.StartEpoch, Vary.Duration), almanac=almanac)
    return tgt.try_achieve_from(pre, start - 120.0, achieve, device=device)
