"""Monte Carlo: the ensemble is the batch axis.

Torch port of nyx_tpu/mc/montecarlo.py `run_until_epoch`: dispersed states
are drawn from a seeded `torch.Generator`, stacked [B, 9] (guided dynamics
append the template's guidance mode as a tenth column) and advanced through
one batched adaptive propagation on the card, or on the device the caller
names, with optional guidance-law parameters on the EOM context. Device
meshes, trajectory capture, chunking (`max_lanes_per_call`) and
`skip`/resume are not ported yet.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..propagators import integrator
from ..time import Epoch
from .multivariate import MvnSpacecraft
from .results import Results


class MonteCarlo:
    def __init__(self, random_state: MvnSpacecraft, seed: int = 0):
        self.random_state = random_state
        self.seed = seed

    def generate_states(self, n: int, *, device="cuda") -> torch.Tensor:
        """[n, 9] float64 dispersed initial states; deterministic in the seed."""
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.seed)
        return self.random_state.sample(n, gen, device=device)

    def _with_mode_column(self, prop, y0):
        """Guided dynamics carry the guidance mode as a trailing state
        column; every lane starts in the template's mode (the reference's
        MC disperses the state, not the mode)."""
        if prop.dynamics.has_guidance and y0.shape[1] == 9:
            mode = torch.full((y0.shape[0], 1), float(self.random_state.template.mode),
                              dtype=y0.dtype, device=y0.device)
            y0 = torch.cat([y0, mode], dim=1)
        return y0

    def run_until_epoch(self, prop, almanac, end_epoch: Epoch, n: int, *, device="cuda",
                        guidance_params=None, _y0=None) -> Results:
        """Propagate n dispersed samples to `end_epoch` on `device` (the card
        unless the caller asks for the CPU).

        `guidance_params` (array-like, [P] shared by every lane or [n, P]
        per lane) is placed on the EOM context for parametric guidance laws,
        such as the efficiency thresholds of `Ruggiero.from_ctx_thresholds`.
        `_y0` ([n, 9] numpy array or tensor) replaces the draw, so two
        implementations can be fed identical initial states.
        """
        template = self.random_state.template
        epoch0 = template.epoch
        duration_s = (end_epoch - epoch0).to_seconds()
        if _y0 is None:
            y0 = self.generate_states(n, device=device)
        else:
            y0 = torch.as_tensor(_y0, dtype=torch.float64).to(device)
        y0 = self._with_mode_column(prop, y0)
        dyn = prop.dynamics
        ctx = dyn.build_context(epoch0, duration_s, almanac, device=device)
        if guidance_params is not None:
            gp = torch.as_tensor(np.asarray(guidance_params), dtype=torch.float64).to(device)
            ctx = dataclasses.replace(ctx, guidance_params=gp)
        sc_params = dict(
            dry_mass_kg=template.dry_mass_kg,
            srp_area_m2=template.srp_area_m2,
            drag_area_m2=template.drag_area_m2,
        )
        res = integrator.propagate(
            dyn.make_eom(thruster=template.thruster), y0, duration_s, prop.opts, prop.method,
            finally_fn=dyn.make_finally(), eom_args=(ctx, sc_params),
        )
        status = res.status.cpu().numpy()
        n_running = int(np.sum(status == integrator.RUNNING))
        if n_running:
            warnings.warn(
                f"{n_running}/{len(status)} lanes still RUNNING at return: the step "
                "budget (max_iterations) was exhausted and those finals are BEFORE "
                "end_epoch.",
                RuntimeWarning,
                stacklevel=2,
            )
        return Results(
            epoch0=epoch0,
            end_epoch=end_epoch,
            template=template,
            y_final=res.y.cpu().numpy(),
            status=status,
            n_accepted=res.n_accepted.cpu().numpy(),
            n_rejected=res.n_rejected.cpu().numpy(),
            y_initial=y0.cpu().numpy(),
            iterations=res.iterations,
        )
