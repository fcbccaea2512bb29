"""Multiple shooting (Parrish 2018): minimum-fuel or minimum-energy nodes.

Torch port of nyx_tpu/md/opti/multishoot.py:26-215 (the reference's
MultipleShooting, md/opti/multipleshooting/multishoot.rs:41-280, with the
equidistant node heuristic, equidistant_heuristic.rs). Inner loop: a
delta-v targeter a segment (the STM-based `try_achieve_dual`, on the
device); outer loop: Newton on the node positions with the delta-v
sensitivity Jacobian from perturbing each node component (the
reference's blocks 2.A-2.D), solved by pseudo-inverse on the host. Every
segment targeter shares one EOM cache, so the dozens of small solves an
outer iteration build their EOM once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from ...cosmic.spacecraft import Spacecraft
from ...errors import TargetingError
from ...time import Epoch
from ..objective import Objective
from ..param import StateParameter
from .targeter import Targeter, TargeterSolution


class CostFunction:
    MinimumEnergy = "min_energy"  # sum of dv^2
    MinimumFuel = "min_fuel"  # sqrt of the sum of dv^2


@dataclass
class Node:
    """A position node of the trajectory (ctrlnodes.rs Node)."""

    x: float
    y: float
    z: float
    epoch: Epoch
    frame: object
    vmag: float = 0.0
    tolerance_km: float = 1e-3

    def objectives(self) -> Tuple[Objective, ...]:
        return (
            Objective(StateParameter.X, self.x, self.tolerance_km),
            Objective(StateParameter.Y, self.y, self.tolerance_km),
            Objective(StateParameter.Z, self.z, self.tolerance_km),
        )

    def position(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z])

    def update_component(self, axis: int, delta: float):
        if axis == 0:
            self.x += delta
        elif axis == 1:
            self.y += delta
        else:
            self.z += delta

    def rmag(self) -> float:
        return float(np.linalg.norm(self.position()))


def equidistant_nodes(x0: Spacecraft, xf_orbit, n_nodes: int, tolerance_km: float = 1e-3) -> List[Node]:
    """Straight-line position nodes at equally spaced epochs between the
    initial state and the destination (equidistant_heuristic.rs:28-88)."""
    if n_nodes < 2:
        raise TargetingError("need at least 2 nodes")
    r0, rf = x0.orbit.r_km, xf_orbit.r_km
    dt = (xf_orbit.epoch - x0.epoch).to_seconds()
    nodes = []
    for i in range(1, n_nodes + 1):
        f = i / n_nodes
        r = r0 + f * (rf - r0)
        nodes.append(Node(float(r[0]), float(r[1]), float(r[2]), x0.epoch + f * dt, xf_orbit.frame,
                          tolerance_km=tolerance_km))
    return nodes


@dataclass
class MultipleShootingSolution:
    x0: Spacecraft
    xf: object
    nodes: List[Node]
    solutions: List[TargeterSolution] = field(default_factory=list)
    iterations: int = 0
    cost: float = float("nan")
    #: segment solves run, and their Newton and integrator iterations
    solves: int = 0
    newton_iterations: int = 0
    prop_iterations: int = 0

    @property
    def all_dvs(self) -> List[np.ndarray]:
        return [sol.correction for sol in self.solutions]

    def total_dv_km_s(self) -> float:
        return float(sum(np.linalg.norm(dv) for dv in self.all_dvs))

    def __str__(self):
        return (f"MultipleShootingSolution: {len(self.solutions)} segments, total dv "
                f"{self.total_dv_km_s() * 1e3:.3f} m/s (converged in {self.iterations} outer iterations)")


class MultipleShooting:
    """(multishoot.rs:41-64)."""

    def __init__(self, prop, x0: Spacecraft, xf_orbit, nodes: Sequence[Node], max_iterations: int = 50,
                 improvement_threshold: float = 0.01, almanac=None):
        self.prop = prop
        self.x0 = x0
        self.xf = xf_orbit
        self.nodes = list(nodes)
        self.max_iterations = max_iterations
        self.improvement_threshold = improvement_threshold
        self.almanac = almanac
        self._eom_cache = {}
        self._counts = [0, 0, 0]

    def _solve_segment(self, objectives, state: Spacecraft, epoch: Epoch, device) -> TargeterSolution:
        tgt = Targeter.delta_v(self.prop, objectives, almanac=self.almanac)
        tgt._eom_cache = self._eom_cache
        sol = tgt.try_achieve_dual(state, state.epoch, epoch, device=device)
        self._counts[0] += 1
        self._counts[1] += sol.iterations
        self._counts[2] += sol.prop_iterations
        return sol

    def _chain(self, nodes, device) -> List[TargeterSolution]:
        """The segment targeters, in time order (multishoot.rs step 1)."""
        sols = []
        state = self.x0
        for node in nodes:
            sol = self._solve_segment(node.objectives(), state, node.epoch, device)
            if not sol.converged:
                raise TargetingError(f"segment targeter to node at {node.epoch} failed: {sol}")
            sols.append(sol)
            state = sol.achieved_state
        return sols

    def solve(self, cost: str = CostFunction.MinimumFuel, *, device="cuda") -> MultipleShootingSolution:
        """Move the nodes (all but the last) on `device` until the total
        cost improves by less than `improvement_threshold`."""
        prev_cost = 1e12
        n = len(self.nodes)
        self._counts = [0, 0, 0]
        for it in range(self.max_iterations):
            sols = self._chain(self.nodes, device)
            all_dvs = [s.correction for s in sols]
            initial_states = [self.x0] + [s.achieved_state for s in sols]

            cost_vec = np.concatenate(all_dvs)
            sq = float(cost_vec @ cost_vec)
            new_cost = sq if cost == CostFunction.MinimumEnergy else np.sqrt(sq)
            if abs((prev_cost - new_cost) / abs(new_cost)) < self.improvement_threshold:
                return MultipleShootingSolution(self.x0, self.xf, self.nodes, sols, it, new_cost,
                                                *self._counts)
            prev_cost = new_cost

            # outer Jacobian: d dv(segments i, i+1, i+2) / d(node i position)
            # (multishoot.rs 2.A-2.D); the end node never moves
            jac = np.zeros((3 * n, 3 * (n - 1)))
            for i in range(n - 1):
                for axis in range(3):
                    node = self.nodes[i]
                    pert = node.tolerance_km
                    node_p = Node(node.x, node.y, node.z, node.epoch, node.frame,
                                  tolerance_km=node.tolerance_km)
                    node_p.update_component(axis, pert)
                    sol_a = self._solve_segment(node_p.objectives(), initial_states[i], node_p.epoch, device)
                    jac[3 * i:3 * i + 3, 3 * i + axis] = (sol_a.correction - all_dvs[i]) / pert
                    sol_b = self._solve_segment(self.nodes[i + 1].objectives(), sol_a.achieved_state,
                                                self.nodes[i + 1].epoch, device)
                    jac[3 * (i + 1):3 * (i + 1) + 3, 3 * i + axis] = (sol_b.correction - all_dvs[i + 1]) / pert
                    if i < n - 3:
                        dv_ip1 = sol_b.achieved_state.orbit.v_km_s - initial_states[i + 2].orbit.v_km_s
                        jac[3 * (i + 2):3 * (i + 2) + 3, 3 * i + axis] = dv_ip1 / pert

            delta_r = np.linalg.pinv(jac) @ cost_vec
            for k, val in enumerate(-delta_r):
                self.nodes[k // 3].update_component(k % 3, val)

        raise TargetingError(f"multiple shooting did not converge in {self.max_iterations} iterations")
