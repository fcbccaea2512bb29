"""Integrator methods: explicit Runge-Kutta Butcher tableaus.

Mirrors the reference's method set (nyx-core/src/propagators/rk_methods/
mod.rs:65-79): RK89 (GMAT/Verner 16-stage order 9, the default),
Dormand-Prince 7(8) and 4(5), Cash-Karp 4(5), Verner 5(6), fixed RK4.
Tableau numbers live in `_tableau_data.py` (generated; see
devtools/extract_tableaus.py). Here they are shaped into dense numpy arrays
(A [S,S] strictly lower triangular, b, b_star, c) for the batched kernel.

Copied from nyx_tpu/propagators/tableaus.py (host-only numpy).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ._tableau_data import TABLEAUS


@dataclass(frozen=True)
class IntegratorMethod:
    name: str

    RK89 = None  # type: IntegratorMethod
    DormandPrince78 = None  # type: IntegratorMethod
    DormandPrince45 = None  # type: IntegratorMethod
    CashKarp45 = None  # type: IntegratorMethod
    Verner56 = None  # type: IntegratorMethod
    RK4Fixed = None  # type: IntegratorMethod

    @property
    def order(self) -> int:
        return TABLEAUS[self.name][0]

    @property
    def stages(self) -> int:
        return TABLEAUS[self.name][1]

    @property
    def is_fixed_only(self) -> bool:
        return self.name == "RK4Fixed"

    @lru_cache(maxsize=None)
    def _dense(self):
        order, stages, a_flat, b_all = TABLEAUS[self.name]
        a = np.zeros((stages, stages), dtype=np.float64)
        idx = 0
        for i in range(1, stages):
            for j in range(i):
                a[i, j] = a_flat[idx]
                idx += 1
        b = np.array(b_all[:stages], dtype=np.float64)
        b_star = np.array(b_all[stages:], dtype=np.float64)
        c = a.sum(axis=1)
        return a, b, b_star, c

    @property
    def a_matrix(self) -> np.ndarray:
        return self._dense()[0]

    @property
    def b(self) -> np.ndarray:
        return self._dense()[1]

    @property
    def b_star(self) -> np.ndarray:
        return self._dense()[2]

    @property
    def c(self) -> np.ndarray:
        return self._dense()[3]


IntegratorMethod.RK89 = IntegratorMethod("RK89")
IntegratorMethod.DormandPrince78 = IntegratorMethod("Dormand78")
IntegratorMethod.DormandPrince45 = IntegratorMethod("Dormand45")
IntegratorMethod.CashKarp45 = IntegratorMethod("CashKarp45")
IntegratorMethod.Verner56 = IntegratorMethod("Verner56")
IntegratorMethod.RK4Fixed = IntegratorMethod("RK4Fixed")
