"""Porkchop scans: a whole launch window's Lambert grid in one device solve.

Torch port of nyx_tpu/tools/porkchop.py:23-108. The D x A grid of
departure and arrival epochs is flattened into one batch of
`lambert_izzo_rv` on the device (fixed iterations, no host sync); the
bodies' states come from the almanac on the host. Cells with a time of
flight at or below zero are NaN by design.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.linalg import vector_norm

from ..constants import GM, NAIF
from .lambert import lambert_izzo_rv


@dataclass
class Porkchop:
    """Grids indexed [departure, arrival]."""

    dep_epochs: list
    arr_epochs: list
    tof_days: np.ndarray  # [D, A]
    c3_km2_s2: np.ndarray  # [D, A] departure C3
    vinf_arrival_km_s: np.ndarray  # [D, A]
    dv_total_km_s: np.ndarray  # [D, A] |v_inf dep| + |v_inf arr|

    def best(self, metric: str = "c3_km2_s2"):
        """(dep_epoch, arr_epoch, value) at the grid's minimum of `metric`."""
        grid = getattr(self, metric)
        i, j = np.unravel_index(np.argmin(np.nan_to_num(grid, nan=np.inf)), grid.shape)
        return self.dep_epochs[i], self.arr_epochs[j], float(grid[i, j])


def porkchop_grid(r1, v1, r2, v2, tof_s, mu: float, long_way=False):
    """Lambert over flattened grids on the tensors' device: r1/v1 [N, 3] the
    departure body's state a cell, r2/v2 [N, 3] the arrival body's, tof_s
    [N]. Returns (c3, vinf_arr, dv_total), each [N]."""
    v1_l, v2_l = lambert_izzo_rv(r1, r2, torch.clamp(tof_s, min=1.0), mu, long_way=long_way)
    vinf_dep = vector_norm(v1_l - v1, dim=-1)
    vinf_arr = vector_norm(v2_l - v2, dim=-1)
    nan = torch.where(tof_s <= 0.0, torch.full_like(tof_s, float("nan")), torch.ones_like(tof_s))
    return nan * vinf_dep**2, nan * vinf_arr, nan * (vinf_dep + vinf_arr)


def porkchop(almanac, departure_body: int, arrival_body: int, dep_epochs, arr_epochs,
             center: int = NAIF.SUN, mu: float = None, long_way: bool = False, *,
             device="cuda") -> Porkchop:
    """Launch-window scan between two bodies (heliocentric by default) on
    `device`: `dep_epochs` / `arr_epochs` lists of Epoch, the bodies'
    states from the almanac, the whole grid one batched solve."""
    mu = GM.SUN if mu is None else mu
    if center != NAIF.SUN and mu is GM.SUN:
        raise ValueError("pass mu for a non-heliocentric center")

    def states(body, epochs):
        rv = [almanac.state(body, center, e) for e in epochs]
        return np.stack([r for r, _ in rv]), np.stack([v for _, v in rv])

    r1, v1 = states(departure_body, dep_epochs)
    r2, v2 = states(arrival_body, arr_epochs)
    t_dep = np.array([e.to_tdb_seconds() for e in dep_epochs])
    t_arr = np.array([e.to_tdb_seconds() for e in arr_epochs])
    D, A = len(dep_epochs), len(arr_epochs)
    tof = t_arr[None, :] - t_dep[:, None]  # [D, A]

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    c3, vinf, dv = porkchop_grid(dev(np.repeat(r1, A, axis=0)), dev(np.repeat(v1, A, axis=0)),
                                 dev(np.tile(r2, (D, 1))), dev(np.tile(v2, (D, 1))),
                                 dev(tof.ravel()), mu, long_way)
    return Porkchop(
        dep_epochs=list(dep_epochs),
        arr_epochs=list(arr_epochs),
        tof_days=tof / 86_400.0,
        c3_km2_s2=c3.cpu().numpy().reshape(D, A),
        vinf_arrival_km_s=vinf.cpu().numpy().reshape(D, A),
        dv_total_km_s=dv.cpu().numpy().reshape(D, A),
    )
