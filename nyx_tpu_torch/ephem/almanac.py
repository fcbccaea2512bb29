"""The Almanac: analytic ephemerides on the host, Chebyshev tables on the device.

Port of nyx_tpu/ephem/almanac.py restricted to the built-in analytic series
(SPK/DAF kernels are not ported yet). For device use an `EphemTable` re-fits
every requested body's position relative to the integration center as
uniform-interval Chebyshev polynomials over the propagation window, so the
in-loop lookup is a record select plus Clenshaw.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..time import Epoch
from . import analytic
from .chebyshev import eval_chebyshev, fit_chebyshev


@dataclasses.dataclass(frozen=True)
class EphemTable:
    """Device-resident Chebyshev ephemeris for N bodies about one center."""

    t0: float  # TDB s past J2000 of table start
    intlen: float  # record length, s
    coeffs: torch.Tensor  # [n_bodies, n_records, 3, deg+1] f64, km
    bodies: Tuple[int, ...]  # NAIF ids, in coeffs order

    def index_of(self, body: int) -> int:
        return self.bodies.index(body)

    def _rec_tau(self, t_tdb_s, dtype):
        """Record index + normalized time. For an f32 evaluation the chain
        after one f64 subtraction runs in f32: `rel` spans a few records
        (~1e6 s), so f32 puts ~2e-7 on tau, far below the f32 rounding of
        the position itself."""
        n_rec = self.coeffs.shape[1]
        rel = (t_tdb_s - self.t0).to(dtype)
        intlen = self.intlen  # a whole number of seconds: exact in f32
        rec_f = torch.clamp(torch.floor(rel / intlen), 0, n_rec - 1)
        tau = 2.0 * (rel - rec_f * intlen) / intlen - 1.0
        return rec_f.to(torch.int32), tau

    def position(self, idx: int, t_tdb_s, dtype=torch.float64):
        """Position [.., 3] km of body `idx` at TDB seconds [..] (f64 tensor).

        `dtype=torch.float32` runs the record selection after the first
        subtraction and the Clenshaw recurrence in f32. Each lane gathers
        its record's coefficients, so one Clenshaw pass serves any number
        of records (the reference evaluates every record of a short table
        and selects, which costs a TPU less than a gather; on the GPU each
        pass is ~40 small kernel launches from the host).
        """
        rec, tau = self._rec_tau(t_tdb_s, dtype)
        return eval_chebyshev(self.coeffs[idx].to(dtype)[rec.long()], tau)


class Almanac:
    """Host-side analytic ephemeris source and device-table factory."""

    def position(self, target: int, center: int, t_tdb_s) -> np.ndarray:
        """Position of target rel center at TDB seconds (array ok), EME2000 km."""
        t = np.atleast_1d(np.asarray(t_tdb_s, dtype=np.float64))
        out = analytic.state_between(target, center, t)
        return out.reshape(np.shape(t_tdb_s) + (3,))

    def build_table(
        self,
        bodies: Sequence[int],
        center: int,
        start: Epoch,
        end: Epoch,
        *,
        device,
        intlen_days: float = 4.0,
        degree: int = 12,
        pad_days: float = 2.0,
    ) -> EphemTable:
        """Fit the bodies' positions about `center` over [start, end] padded
        by `pad_days`, and place the float64 table on `device`."""
        t0 = start.to_tdb_seconds() - pad_days * 86_400.0
        t1 = end.to_tdb_seconds() + pad_days * 86_400.0
        intlen = intlen_days * 86_400.0
        n_rec = max(1, int(np.ceil((t1 - t0) / intlen)))
        tabs = []
        for b in bodies:
            fn = lambda ts, b=b: self.position(b, center, ts)  # noqa: E731
            tabs.append(fit_chebyshev(fn, t0, intlen, n_rec, degree))
        coeffs = np.stack(tabs) if tabs else np.zeros((0, n_rec, 3, degree + 1))
        return EphemTable(
            t0=float(t0),
            intlen=float(intlen),
            coeffs=torch.as_tensor(coeffs, dtype=torch.float64, device=device),
            bodies=tuple(int(b) for b in bodies),
        )
