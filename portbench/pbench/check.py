"""How `correct` is decided: the window's sampled answers against the plain
reference, each number beside the cell's limit.

The numbers, each the worst over the lanes sampled from every ensemble of
the window (`window.sample_lanes`):

- `draw_pos_km`: the program's initial positions against the reference's
  draws from the seed (the dispersion layer);
- `final_pos_km`, `final_vel_km_s`: the program's states at the arc's end
  against the reference's propagation of its own draws (the integrator and
  every force model, frame and ephemeris the EOM reads);
- `failed_lanes`: lanes of the window not at the arc's end with finite
  states (limit 0).

`control_numbers` puts the reference at float32 in the program's place.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import reference
from .window import ensemble_seed


def _worst(a, b, cols):
    gap = np.linalg.norm(a[:, cols] - b[:, cols], axis=1)
    return float(np.max(gap)) if gap.size and np.all(np.isfinite(gap)) else float("inf")


def picks_of(win):
    return [(e.k, int(i)) for e in win.ensembles for i in e.lanes]


def program_numbers(cfg, root: Path, traffic: dict, win, seed: int) -> dict:
    """The window's numbers against the float64 reference (on the host's
    CPU: a few dozen lanes make small tensors, where the card's launch cost
    would set the pace), and the reference's (initial, final) states."""
    picks = picks_of(win)
    seeds = {e.k: ensemble_seed(seed, e.k) for e in win.ensembles}
    y0 = reference.draws(cfg, seeds, int(traffic["lanes"]), picks)
    yf = reference.propagate(cfg, root, y0, float(traffic["arc_s"]))
    p0 = np.concatenate([e.y_initial for e in win.ensembles])
    pf = np.concatenate([e.y_final for e in win.ensembles])
    return dict(
        draw_pos_km=_worst(p0, y0, slice(0, 3)),
        final_pos_km=_worst(pf, yf, slice(0, 3)),
        final_vel_km_s=_worst(pf, yf, slice(3, 6)),
        failed_lanes=int(sum(e.n_runs - e.n_ok for e in win.ensembles)),
    ), (y0, yf)


def control_numbers(cfg, root: Path, traffic: dict, y0, yf) -> dict:
    """The same numbers for the reference at float32 (its draws rounded to
    float32, its state and forces at float32; time, rotation and Sun stay
    float64 host scalars) against the float64 reference."""
    c0 = y0.astype(np.float32).astype(np.float64)
    cf = reference.propagate(cfg, root, c0, float(traffic["arc_s"]), dtype=torch.float32)
    return dict(draw_pos_km=_worst(c0, y0, slice(0, 3)), final_pos_km=_worst(cf, yf, slice(0, 3)),
                final_vel_km_s=_worst(cf, yf, slice(3, 6)),
                failed_lanes=int(np.count_nonzero(~np.isfinite(cf).all(1))))


def load_limits(path: Path) -> dict:
    return {k: float(v) for k, v in json.loads(path.read_text())["limits"].items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number at or under its limit, {name: [number, limit]})."""
    shown = {k: [numbers[k], limits[k]] for k in limits}
    ok = all(numbers[k] <= lim for k, lim in limits.items())  # NaN fails
    return ok, shown
