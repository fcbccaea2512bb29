"""The OD host loop: sequential Kalman processing of a tracking arc.

Port of nyx_tpu/od/process.py:33-331 (the reference's
KalmanODProcess::process_arc, od/process/mod.rs). For each measurement, in
order and one at a time: propagate the nominal with its state-carried STM
(`PropInstance`, the spacecraft built `with_stm()`) from the previous
epoch, in chunks of at most `max_step` with a time update at each chunk;
for a two-way device stop first at t - T_int for the turn-around state;
compute the observation and its H-tilde, the Jacobian by
`torch.func.jacfwd` through the device's geometry (cached per device and
types); fold range ambiguities by the arc's moduli; run the filter's
measurement update (`KalmanFilter`: sigma gate, gain, Joseph form); swap
the EKF's reference; and log the decile progress. `predict_for` and
`predict_until` map the covariance alone at a fixed step.
`SpacecraftKalmanScalarOD` processes each measurement type of a row as its
own scalar update.

Every propagation, observation and update runs on `device`; the loop is
on the host by design, one measurement at a time (the batched filter of
the same arcs is `ScanKalmanOD`), and each row brings its estimate to the
host once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..time import Duration, Epoch
from ..tracing import Progress
from .estimate import KfEstimate
from .kalman import KalmanFilter, KalmanVariant, ProcessNoise
from .msr import TrackingDataArc
from .solution import ODSolution

STATE_DIM = 9


def _secs(x) -> float:
    return x.to_seconds() if isinstance(x, Duration) else float(x)


class KalmanODProcess:
    """A propagator, SNC models and the filter's configuration, run on
    `device`."""

    def __init__(self, prop, process_noise: Sequence[ProcessNoise] = (),
                 variant: str = KalmanVariant.ReferenceUpdate,
                 resid_rejection_sigmas: Optional[float] = 3.0, max_step=60.0, almanac=None, *,
                 device="cuda"):
        self.prop = prop
        self.process_noise = process_noise
        self.variant = variant
        self.resid_rejection_sigmas = resid_rejection_sigmas
        self.max_step_s = _secs(max_step)
        self.almanac = almanac
        self.device = torch.device(device)
        self._h_cache: Dict = {}

    def _h_fns(self, device, types: tuple):
        """`obs(t_tdb [1], y9 [9], y6_tm [6]) -> (computed [m], H-tilde [m, 9])`
        for the device and types, cached: the computed observation of the
        9-state and its Jacobian by `torch.func.jacfwd`, the device's
        geometry at the epoch evaluated once outside the transform
        (`measurement_fn_at`).

        A two-way device (integration_time_s set) observes the average of
        the one-way values at t - T_int (the turn-around state y6_tm) and
        t; its H-tilde is the partial of that average through the
        linearized backward flow, 0.5 (H_t + H_tm Phi(t -> t - T)) with
        Phi ~ I and -T_int in its position-velocity block, as the
        reference's (process.py:91-117) and the scan filter's."""
        key = (id(device), types)
        if key not in self._h_cache:
            def one_way(t, y9):
                f = device.measurement_fn_at(t, types)

                def g(y):
                    out = f(y[None, 0:6])[0]
                    return out, out

                jac, val = torch.func.jacfwd(g, has_aux=True)(y9)
                return val, jac

            if device.integration_time_s:
                t_int = float(device.integration_time_s)
                phi_back = torch.eye(STATE_DIM, dtype=torch.float64, device=self.device)
                phi_back[0:3, 3:6] = -t_int * torch.eye(3, dtype=torch.float64, device=self.device)

                def obs(t, y9, y6_tm):
                    v1, h1 = one_way(t, y9)
                    v0, h0 = one_way(t - t_int, torch.cat([y6_tm, y9[6:9]]))
                    return 0.5 * (v0 + v1), 0.5 * (h1 + h0 @ phi_back)

            else:
                def obs(t, y9, y6_tm):
                    return one_way(t, y9)

            self._h_cache[key] = obs
        return self._h_cache[key]

    def _chunked_time_updates(self, kf, instance, epoch: Epoch, sol=None):
        """Advance toward `epoch` in chunks of at most max_step_s, with a
        time update (appended to `sol`) at each chunk but the last, which
        the measurement update's own time update covers. SNC so accumulates
        piecewise through a gap, as the reference's, and every stored STM
        spans one chunk, which keeps the smoother exact."""
        while True:
            rem = (epoch - instance.state.epoch).to_seconds()
            if rem <= self.max_step_s + 1e-9:
                return
            nominal, stm, dt = self._propagate_stm(instance, instance.state.epoch + self.max_step_s)
            est = kf.time_update(nominal, stm, dt)
            if sol is not None:
                sol.append(est, None)
            instance.state = nominal.with_stm()

    def _propagate_stm(self, instance, epoch: Epoch):
        """Advance the instance (STM carried) to `epoch`: (nominal
        spacecraft, Phi [9, 9], dt_s)."""
        dt = (epoch - instance.state.epoch).to_seconds()
        if abs(dt) < 1e-9:
            return instance.state, np.eye(STATE_DIM), 0.0
        instance.state.stm = np.eye(STATE_DIM)
        sc = instance.for_duration(dt)
        return sc, sc.stm.copy(), dt

    def _filter(self, initial_estimate):
        return KalmanFilter(initial_estimate, self.process_noise, self.variant, device=self.device)

    def process_arc(self, initial_estimate: KfEstimate, arc: TrackingDataArc,
                    devices: Sequence) -> ODSolution:
        """Run the filter over every measurement of the arc."""
        dev_map = {d.name: d for d in devices}
        kf = self._filter(initial_estimate)
        instance = self.prop.with_state(initial_estimate.nominal.with_stm(), self.almanac,
                                        device=self.device)
        sol = ODSolution(devices=tuple(dev_map), measurement_types=arc.unique_types())
        sol.append(initial_estimate, None)
        f64 = dict(dtype=torch.float64, device=self.device)

        # residual-versus-reference mode: every row rejected, so the filter
        # never updates and residuals are against the propagated nominal
        reject_sigmas = 0.0 if arc.force_reject else self.resid_rejection_sigmas
        n = len(arc)
        accepted = rejected = 0
        progress = Progress(n, "measurements")
        for i in range(n):
            msr = arc.measurement(i)
            device = dev_map.get(msr.tracker)
            if device is None:
                continue
            # 1. the nominal and its STM at the measurement epoch; a two-way
            #    device stops at t - T_int first for the turn-around state
            y6_tm = torch.zeros(6, **f64)
            stm_pre, dt_pre = np.eye(STATE_DIM), 0.0
            self._chunked_time_updates(kf, instance, msr.epoch, sol)
            if device.integration_time_s:
                mid, stm_pre, dt_pre = self._propagate_stm(
                    instance, msr.epoch - float(device.integration_time_s))
                y6_tm = torch.as_tensor(mid.to_vector()[0:6], **f64)
            nominal, stm, dt_s = self._propagate_stm(instance, msr.epoch)
            if device.integration_time_s:
                stm = stm @ stm_pre
                dt_s = dt_s + dt_pre

            # 2. the computed observation and its sensitivity at the nominal
            types = tuple(t for t in device.measurement_types if t in msr.data)
            if not types:
                continue
            t_tdb = torch.tensor([msr.epoch.to_tdb_seconds()], **f64)
            y9 = torch.as_tensor(nominal.to_vector(), **f64)
            computed, h_tilde = self._h_fns(device, types)(t_tdb, y9, y6_tm)
            real = torch.as_tensor(msr.observation(types), **f64)
            if arc.moduli:
                # range ambiguities: the observation nearest the computed one
                for j, t in enumerate(types):
                    if t in arc.moduli:
                        mod = float(arc.moduli[t])
                        real[j] = computed[j] + (torch.remainder(real[j] - computed[j] + mod / 2, mod)
                                                 - mod / 2)

            # 3. the filter's update
            est, resid = kf.measurement_update(
                nominal, real, computed, device.measurement_covar(types), h_tilde, stm, dt_s,
                reject_sigmas, tracker=msr.tracker, msr_types=types)
            if resid.rejected:
                rejected += 1
            else:
                accepted += 1

            # 4. the EKF's reference swap
            if self.variant == KalmanVariant.ReferenceUpdate and not resid.rejected:
                instance.state = est.nominal.with_stm()
            else:
                instance.state = nominal.with_stm()
            sol.append(est, resid, gain=kf.last_gain)
            progress.step(i, f"{accepted} accepted, {rejected} rejected")

        sol.accepted, sol.rejected = accepted, rejected
        return sol

    def predict_for(self, initial_estimate: KfEstimate, duration, step=None) -> ODSolution:
        """Covariance mapping alone, every `step` (default: max_step)."""
        step_s = _secs(step) if step is not None else self.max_step_s
        dur_s = _secs(duration)
        kf = self._filter(initial_estimate)
        instance = self.prop.with_state(initial_estimate.nominal.with_stm(), self.almanac,
                                        device=self.device)
        sol = ODSolution(devices=(), measurement_types=())
        sol.append(initial_estimate, None)
        t = 0.0
        epoch0 = initial_estimate.epoch
        while t < dur_s - 1e-9:
            dt = min(step_s, dur_s - t)
            t += dt
            nominal, stm, _ = self._propagate_stm(instance, epoch0 + t)
            sol.append(kf.time_update(nominal, stm, dt), None)
            instance.state = nominal.with_stm()
        return sol

    def predict_until(self, initial_estimate: KfEstimate, epoch: Epoch, step=None) -> ODSolution:
        return self.predict_for(initial_estimate, epoch - initial_estimate.epoch, step)


def SpacecraftKalmanOD(prop, process_noise=(), variant=KalmanVariant.ReferenceUpdate,
                       resid_rejection_sigmas=3.0, max_step=60.0, almanac=None, *, device="cuda"):
    """The reference's name for `KalmanODProcess`."""
    return KalmanODProcess(prop, process_noise, variant, resid_rejection_sigmas, max_step, almanac,
                           device=device)


class SpacecraftKalmanScalarOD(KalmanODProcess):
    """Every measurement type processed as its own scalar update, in
    sequence: each multi-type row becomes consecutive single-type rows at
    the same epoch before the loop."""

    def process_arc(self, initial_estimate, arc, devices):
        return super().process_arc(initial_estimate, _expand_scalar(arc), devices)


def _expand_scalar(arc: TrackingDataArc) -> TrackingDataArc:
    """A copy of the arc with one measurement type a row (same epoch order)."""
    epochs, tidx, rows = [], [], []
    T = len(arc.types)
    for i in range(len(arc)):
        for j in range(T):
            v = arc.values[i, j]
            if not np.isnan(v):
                row = np.full(T, np.nan)
                row[j] = v
                epochs.append(arc.epochs_tai_s[i])
                tidx.append(arc.tracker_idx[i])
                rows.append(row)
    return TrackingDataArc(arc.trackers, arc.types, np.asarray(epochs, dtype=np.float64),
                           np.asarray(tidx, dtype=np.int64),
                           np.stack(rows) if rows else np.zeros((0, T)), arc.moduli,
                           arc.force_reject)
