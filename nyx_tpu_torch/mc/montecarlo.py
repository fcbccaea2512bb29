"""Monte Carlo: the ensemble is the batch axis.

Torch port of nyx_tpu/mc/montecarlo.py: dispersed states are drawn from a
seeded `torch.Generator` (`skip` draws past the first samples of the same
stream, so a resumed run reproduces the tail of a longer one), stacked
[B, 9] (guided dynamics append the template's guidance mode as a tenth
column) and advanced through one batched adaptive propagation on the card,
or on the device the caller names, with optional guidance-law parameters
on the EOM context, optional sequential chunks of at most
`max_lanes_per_call` lanes, and optional trajectory capture (the initial
state is prepended as sample 0). `run_until_nth_event` locates each run's
nth event on its capture. `run_until_epoch_encke` is the deviation mode
of mc/encke.py. Every entry point takes a `mesh` (parallel/mesh.py): the
states are drawn once on the host, padded to a multiple of the mesh's
size and cut into one slice a shard; each shard builds its own context on
its device and runs in a host thread of its own, and the slices are
gathered in order, the padding cut away.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..errors import ConfigError
from ..parallel.mesh import ensemble_sharding, pad_to_multiple, run_on_shards
from ..propagators import integrator
from ..propagators.instance import _secs
from ..time import Epoch
from ..tracing import annotate
from . import encke as enc
from .multivariate import MvnSpacecraft
from .results import Results


class MonteCarlo:
    def __init__(self, random_state: MvnSpacecraft, seed: int = 0, scenario: str = "mc"):
        self.random_state = random_state
        self.seed = seed
        self.scenario = scenario
        self._encke_cache = None

    def generate_states(self, n: int, skip: int = 0, *, device="cuda") -> torch.Tensor:
        """[n, 9] float64 dispersed initial states: samples skip .. skip + n - 1
        of the seed's stream (skip + n are drawn)."""
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.seed)
        return self.random_state.sample(skip + n, gen, device=device)[skip:]

    def _with_mode_column(self, prop, y0):
        """Guided dynamics carry the guidance mode as a trailing state
        column; every lane starts in the template's mode (the reference's
        MC disperses the state, not the mode)."""
        if prop.dynamics.has_guidance and y0.shape[1] == 9:
            mode = torch.full((y0.shape[0], 1), float(self.random_state.template.mode),
                              dtype=y0.dtype, device=y0.device)
            y0 = torch.cat([y0, mode], dim=1)
        return y0

    def _sc_params(self) -> dict:
        t = self.random_state.template
        return dict(dry_mass_kg=t.dry_mass_kg, srp_area_m2=t.srp_area_m2,
                    drag_area_m2=t.drag_area_m2)

    def run_until_epoch(self, prop, almanac, end_epoch: Epoch, n: int, skip: int = 0,
                        mesh=None, *, max_lanes_per_call: int = 0, n_capture: int = 0,
                        capture_stride: int = 1, device="cuda", guidance_params=None,
                        _y0=None) -> Results:
        """Propagate n dispersed samples to `end_epoch` on `device` (the card
        unless the caller asks for the CPU), or over the shards of `mesh`
        (parallel/mesh.py; `device` is then the mesh's).

        `skip` starts at sample `skip` of the seed's stream (resume).
        `max_lanes_per_call` > 0 runs the lanes in sequential chunks of at
        most that many; lanes are independent, so the results are those of
        one call. `n_capture` > 0 keeps every `capture_stride`-th accepted
        step of each run (and its last) in a K = n_capture + 1 buffer whose
        sample 0 is the initial state (`Results.every_value_of`,
        `trajectory`, `to_parquet(trajectories=True)`).
        `guidance_params` (array-like, [P] shared by every lane or [n, P]
        per lane) is placed on the EOM context for parametric guidance laws,
        such as the efficiency thresholds of `Ruggiero.from_ctx_thresholds`.
        `_y0` ([n, 9] numpy array or tensor) replaces the draw, so two
        implementations can be fed identical initial states.
        """
        if mesh is not None:
            return self._run_sharded(prop, almanac, end_epoch, n, skip, mesh, _y0,
                                     guidance_params, max_lanes_per_call=max_lanes_per_call,
                                     n_capture=n_capture, capture_stride=capture_stride)
        template = self.random_state.template
        epoch0 = template.epoch
        duration_s = (end_epoch - epoch0).to_seconds()
        with annotate("mc.run", lanes=n, seed=self.seed, skip=skip):
            if _y0 is None:
                with annotate("mc.draw", rows=skip + n):
                    y0 = self.generate_states(n, skip, device=device)
            else:
                y0 = torch.as_tensor(_y0, dtype=torch.float64).to(device)
            y0 = self._with_mode_column(prop, y0)
            dyn = prop.dynamics
            with annotate("mc.context"):
                ctx = dyn.build_context(epoch0, duration_s, almanac, device=device)
            gp = None
            if guidance_params is not None:
                gp = torch.as_tensor(np.asarray(guidance_params), dtype=torch.float64).to(device)
            chunk = max_lanes_per_call if 0 < max_lanes_per_call < n else n
            eom, fin = dyn.make_eom(thruster=template.thruster), dyn.make_finally()
            parts = []
            for lo in range(0, n, chunk):
                sl = slice(lo, lo + chunk)
                ctx_k = ctx
                if gp is not None:
                    ctx_k = dataclasses.replace(ctx, guidance_params=gp if gp.dim() == 1 else gp[sl])
                res = integrator.propagate(
                    eom, y0[sl], duration_s, prop.opts, prop.method, finally_fn=fin,
                    eom_args=(ctx_k, self._sc_params()), n_capture=n_capture,
                    capture_stride=capture_stride,
                )
                with annotate("mc.gather"):
                    parts.append(self._results(epoch0, end_epoch, res, y0[sl], n_capture,
                                               self._interp_j2(prop), device))
            return parts[0] if len(parts) == 1 else Results.concatenate(parts)

    def _run_sharded(self, prop, almanac, end_epoch, n, skip, mesh, y0, guidance_params, **kw):
        """run_until_epoch over the shards of `mesh`: the states drawn once on
        the host (or `y0`), padded with copies of the last, one slice a
        shard, each run on its device in its own thread; the slices
        gathered in order and the padding cut away."""
        if y0 is None:
            y0 = self.generate_states(n, skip, device="cpu")
        y0, _ = pad_to_multiple(torch.as_tensor(y0, dtype=torch.float64).cpu(), mesh.size)
        gp = None
        if guidance_params is not None:
            gp = np.asarray(guidance_params, dtype=np.float64)
            if gp.ndim > 1:
                gp, _ = pad_to_multiple(gp, mesh.size)
        slices = ensemble_sharding(mesh).slices(y0.shape[0])

        def shard(k, dev):
            sl = slices[k]
            gp_k = None if gp is None else (gp if gp.ndim == 1 else gp[sl])
            return self.run_until_epoch(prop, almanac, end_epoch, sl.stop - sl.start,
                                        device=dev, guidance_params=gp_k, _y0=y0[sl], **kw)

        # concatenate keeps the largest iteration count of the shards
        parts = run_on_shards(mesh, shard, f"{self.scenario} shard")
        return dataclasses.replace(Results.concatenate(parts).truncated(n),
                                   device=str(mesh.devices[0]))

    @staticmethod
    def _interp_j2(prop):
        """(j2, radius_km) of the central body's split-precision harmonics
        model, the capture interpolant's end-acceleration data; (0, 0)
        without one."""
        for m in prop.dynamics.orbital_dyn.models:
            j2 = getattr(m, "j2", None)
            if j2:
                return float(j2), float(m.radius_km)
        return 0.0, 0.0

    def _results(self, epoch0, end_epoch, res, y0, n_capture, interp_j2, device) -> Results:
        """Results of one propagation, sample 0 of each capture the initial
        state; warns when lanes are still RUNNING."""
        y_initial = y0.cpu().numpy()
        traj = {}
        if n_capture:
            # the integrator captures accepted steps; queries at t = 0
            # would clamp to the first of them without the initial state
            B = y_initial.shape[0]
            traj = dict(
                traj_t=np.concatenate([np.zeros((B, 1)), res.traj_t.cpu().numpy()], axis=1),
                traj_y=np.concatenate([y_initial[:, None, :], res.traj_y.cpu().numpy()], axis=1),
                traj_len=res.traj_len.cpu().numpy() + 1,
            )
        status = res.status.cpu().numpy()
        n_running = int(np.sum(status == integrator.RUNNING))
        if n_running:
            # a RUNNING lane ran out of step budget: its "final" state is
            # short of end_epoch, unlike a FAILED_NAN lane
            warnings.warn(
                f"{n_running}/{len(status)} lanes still RUNNING at return: the step "
                "budget (max_iterations) was exhausted and those finals are BEFORE "
                "end_epoch. Raise the budget; do not use the truncated lanes.",
                RuntimeWarning,
                stacklevel=3,
            )
        return Results(
            epoch0=epoch0,
            end_epoch=end_epoch,
            template=self.random_state.template,
            y_final=res.y.cpu().numpy(),
            status=status,
            n_accepted=res.n_accepted.cpu().numpy(),
            n_rejected=res.n_rejected.cpu().numpy(),
            y_initial=y_initial,
            interp_j2=interp_j2[0],
            interp_re_km=interp_j2[1],
            iterations=res.iterations,
            device=str(device),
            **traj,
        )

    def resume_run_until_epoch(self, prop, almanac, end_epoch, skip, n, mesh=None, *,
                               device="cuda"):
        """The reference's alias: `run_until_epoch` from sample `skip`."""
        return self.run_until_epoch(prop, almanac, end_epoch, n, skip, mesh, device=device)

    def run_until_nth_event(self, prop, almanac, max_duration, event, trigger: int, n: int,
                            skip: int = 0, mesh=None, *, n_capture: int = 1024,
                            capture_stride: int = 1, device="cuda") -> Results:
        """Propagate n dispersed samples for `max_duration` with capture
        (over the shards of `mesh` if given), then locate each run's
        `trigger`-th crossing of `event` on its capture
        (Results.locate_nth_event); a run without it keeps its final state,
        `event_found` False."""
        end_epoch = self.random_state.template.epoch + _secs(max_duration)
        results = self.run_until_epoch(prop, almanac, end_epoch, n, skip, mesh,
                                       n_capture=n_capture, capture_stride=capture_stride,
                                       device=device)
        results.locate_nth_event(event, trigger)
        return results

    def run_until_epoch_encke(self, prop, almanac, end_epoch: Epoch, n: int, skip: int = 0,
                              stride_s: float = 60.0, tolerance: float = 1e-6,
                              step_mode: str = "fixed", dt_s=None, integ: str = "rk",
                              n_capture: int = 0, mesh=None, *, device="cuda",
                              _y0=None) -> Results:
        """Encke mode (mc/encke.py): the nominal propagates once at full
        quality; the ensemble advances as float32 deviations around it, on
        `device` (the card unless the caller asks for the CPU).

        `step_mode="fixed"` (default) is the synchronized fixed-step loop:
        every lane shares the step grid, so the reference state and its f32
        perturbation are tabulated at every stage time up front
        (`encke.propagate_fixed`). `integ` "rk" takes the propagator's
        tableau, "abm" the AB8/AM PECE multistep (two force evaluations a
        step). `dt_s`, the shared step, defaults to C / w_p from the
        periapsis rate w_p = sqrt(mu / rp^3), C = 0.16 for RK and
        0.16 / (1 + e) for ABM, within [30, 2400] s. `n_capture` > 0 keeps
        about n_capture grid nodes of each run, recombined with the f64
        reference on the device. `step_mode="adaptive"` runs the adaptive
        integrator on the float32 deviations with `tolerance` (relative to
        the deviation). `stride_s` is the reference table's grid. The
        reference (its table and end state) is cached per (prop, arc,
        stride_s, device).
        `mesh`: the deviations are padded to a multiple of its size and
        sharded over it (parallel/mesh.py); the nominal propagates once, on
        the mesh's first device, and each shard gets a copy of its table and
        a context of its own on its device.
        `_y0` ([n, 9]) replaces the draw. No guidance or thrust.
        """
        template = self.random_state.template
        epoch0 = template.epoch
        duration_s = (end_epoch - epoch0).to_seconds()
        if prop.dynamics.has_guidance:
            raise ConfigError("encke mode does not support guidance")
        if n_capture > 0 and step_mode != "fixed":
            raise ConfigError("encke trajectory capture requires step_mode='fixed'")
        if step_mode not in ("fixed", "adaptive"):
            raise ConfigError(f"unknown encke step_mode {step_mode!r}")
        if dt_s is None:
            rp = template.orbit.periapsis_km
            w_p = math.sqrt(template.frame.mu / rp**3)
            coef = 0.16 if integ != "abm" else 0.16 / (1.0 + template.orbit.ecc)
            dt_s = float(np.clip(coef / w_p, 30.0, 2400.0))
        device = torch.device(device) if mesh is None else mesh.devices[0]
        key = (id(prop), epoch0.to_tai_seconds(), duration_s, stride_s, device)
        hit = self._encke_cache
        if hit is not None and hit[0] == key and hit[1] is prop:
            _, _, ref, y_ref_final, ctx = hit
        else:
            ref, y_ref_final = enc.reference_and_final(prop, template, duration_s, almanac,
                                                       stride_s, device=device)
            ctx = prop.dynamics.build_context(epoch0, duration_s, almanac, device=device)
            self._encke_cache = (key, prop, ref, y_ref_final, ctx)

        y0 = (np.asarray(_y0, dtype=np.float64) if _y0 is not None
              else self.generate_states(n, skip, device="cpu").numpy())
        ref0 = template.to_vector()
        y0_dev = np.concatenate([y0[:, 0:6] - ref0[None, 0:6], y0[:, 6:9]], axis=1).astype(np.float32)
        p = dict(self._sc_params(), cr_ref=template.cr, cd_ref=template.cd,
                 mass_ref_kg=template.total_mass_kg)
        lanes = dict(prop=prop, duration_s=duration_s, p=p, step_mode=step_mode, dt_s=dt_s,
                     integ=integ, n_capture=n_capture, tolerance=tolerance)
        if mesh is None:
            out = self._encke_lanes(torch.as_tensor(y0_dev, device=device), ref, ctx, **lanes)
        else:
            y0_pad, _ = pad_to_multiple(y0_dev, mesh.size)
            slices = ensemble_sharding(mesh).slices(y0_pad.shape[0])

            def shard(k, dev):
                ref_k = ref._replace(r=ref.r.to(dev), v=ref.v.to(dev), a=ref.a.to(dev),
                                     p32=ref.p32.to(dev))
                ctx_k = prop.dynamics.build_context(epoch0, duration_s, almanac, device=dev)
                return self._encke_lanes(torch.as_tensor(y0_pad[slices[k]], device=dev), ref_k,
                                         ctx_k, **lanes)

            parts = run_on_shards(mesh, shard, f"{self.scenario} encke shard")
            out = {k: (max(o[k] for o in parts) if k == "iterations" else
                       None if parts[0][k] is None else
                       np.concatenate([o[k] for o in parts])[:n])
                   for k in parts[0]}
        dev = out.pop("dev")
        y_final = np.concatenate([y_ref_final[None, 0:6] + dev[:, 0:6], dev[:, 6:9]], axis=1)
        traj = {}
        if out["traj_y"] is not None:
            traj = dict(traj_y=out["traj_y"], traj_t=out["traj_t"], traj_len=out["traj_len"])
        j2, re = self._interp_j2(prop)
        return Results(epoch0=epoch0, end_epoch=end_epoch, template=template, y_final=y_final,
                       status=out["status"], n_accepted=out["n_accepted"],
                       n_rejected=out["n_rejected"], y_initial=y0, interp_j2=j2,
                       interp_re_km=re, iterations=out["iterations"], device=str(device), **traj)

    @staticmethod
    def _encke_lanes(y0_dev, ref, ctx, *, prop, duration_s, p, step_mode, dt_s, integ, n_capture,
                     tolerance) -> dict:
        """One batch of Encke deviations y0_dev [B, 9] (float32, on the
        device of `ref` and `ctx`) to the arc's end: host arrays of the
        final deviations (`dev`, f64), status, accepted and rejected steps,
        the recombined captures (or None) and the loop's iterations."""
        n = y0_dev.shape[0]
        traj = dict(traj_y=None, traj_t=None, traj_len=None)
        if step_mode == "fixed":
            capture_every = 0
            if n_capture > 0:
                n_est = max(1, int(np.ceil(duration_s / dt_s)))
                capture_every = max(1, n_est // n_capture)
            y_dev, n_steps, cap_t, cap_y = enc.propagate_fixed(
                prop.dynamics, ref, y0_dev, duration_s, ctx, p, prop.method, dt_s=dt_s,
                integ=integ, capture_every=capture_every)
            if cap_t is not None:
                # [K, 6] reference + [K, B, 6] deviations -> [B, K, 9]
                r_ref, v_ref = enc._quintic(ref, cap_t)
                dev64 = cap_y.to(torch.float64)
                full6 = torch.cat([r_ref, v_ref], dim=-1)[:, None, :] + dev64[..., 0:6]
                traj_y = torch.cat([full6, dev64[..., 6:9]], dim=-1).transpose(0, 1)
                K = cap_t.shape[0]
                traj = dict(traj_y=traj_y.cpu().numpy(),
                            traj_t=np.broadcast_to(cap_t.cpu().numpy()[None], (n, K)).copy(),
                            traj_len=np.full(n, K, dtype=np.int32))
            status = torch.where(torch.isfinite(y_dev).all(dim=-1), integrator.DONE,
                                 integrator.FAILED_NAN).cpu().numpy().astype(np.int32)
            n_acc = np.full(n, n_steps, dtype=np.int32)
            n_rej = np.zeros(n, dtype=np.int32)
            iterations = n_steps
        else:
            opts = dataclasses.replace(prop.opts, tolerance=tolerance)
            res = integrator.propagate(enc.make_encke_eom(prop.dynamics, ref), y0_dev, duration_s,
                                       opts, prop.method, eom_args=(ctx, p),
                                       state_dtype=torch.float32)
            y_dev, status = res.y, res.status.cpu().numpy()
            n_acc, n_rej = res.n_accepted.cpu().numpy(), res.n_rejected.cpu().numpy()
            iterations = res.iterations
        return dict(dev=y_dev.to(torch.float64).cpu().numpy(), status=status, n_accepted=n_acc,
                    n_rejected=n_rej, iterations=iterations, **traj)
