"""The Almanac: ephemerides on the host, Chebyshev tables on the device.

Port of nyx_tpu/ephem/almanac.py. Sources, in priority order: SPK kernels
read by `ephem/daf.py`, then the built-in analytic series (`analytic.py`),
body by body. For device use an `EphemTable` re-fits every requested
body's position relative to the integration center as uniform-interval
Chebyshev polynomials over the propagation window, so the in-loop lookup
is a record select plus Clenshaw (`posvel` adds the velocity, the
Chebyshev derivative). On the host, `state` gives a body's position and
velocity about another (the exact Chebyshev derivative through a kernel,
central differences of the analytic series otherwise), and `translate_to`
re-centres an orbit between J2000-aligned frames. `default_almanac()`
loads the kernels found where the reference looks for them.
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from ..errors import ConfigError
from ..time import Epoch
from ..xmath import LastCall
from . import analytic
from .chebyshev import eval_chebyshev, eval_chebyshev_deriv, fit_chebyshev
from .daf import BPC, SPK


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

    def position(self, idx, t_tdb_s, dtype=torch.float64):
        """Position [.., 3] km of body `idx` at TDB seconds [..] (f64 tensor);
        with a sequence of indices, [P, .., 3] for the P bodies in one pass.

        `dtype=torch.float32` runs the record selection after the first
        subtraction and the Clenshaw recurrence in f32. Each lane gathers
        its record's coefficients, so one Clenshaw pass serves any number
        of records (the reference evaluates every record of a short table
        and selects, which costs a TPU less than a gather; on the GPU each
        pass is ~40 small kernel launches from the host).
        """
        memo = self.__dict__.setdefault("_last", LastCall())
        if isinstance(idx, int):
            def one():
                rec, tau = self._rec_tau(t_tdb_s, dtype)
                return eval_chebyshev(self.coeffs[idx].to(dtype)[rec.long()], tau)

            # the models of one EOM call look the same bodies up at the same epochs
            return memo.get((idx, dtype), t_tdb_s, one)
        keys = [(i, dtype) for i in idx]
        kept = [memo.peek(k, t_tdb_s) for k in keys]
        if all(k is not None for k in kept):
            return torch.stack(kept)
        rec, tau = self._rec_tau(t_tdb_s, dtype)
        out = eval_chebyshev(torch.stack([self.coeffs[i] for i in idx]).to(dtype)[:, rec.long()], tau)
        for k, o in zip(keys, out):
            memo.put(k, t_tdb_s, o)
        return out

    def posvel(self, idx: int, t_tdb_s):
        """(position [.., 3] km, velocity [.., 3] km/s) of body `idx` at TDB
        seconds [..] (f64 tensor), in float64: the velocity is the
        Chebyshev derivative."""
        rec, tau = self._rec_tau(t_tdb_s, torch.float64)
        c = self.coeffs[idx][rec.long()]
        return eval_chebyshev(c, tau), eval_chebyshev_deriv(c, tau) * (2.0 / self.intlen)


class Almanac:
    """Host-side ephemeris source (SPK kernels, then the analytic series)
    and device-table factory."""

    def __init__(self, spk_paths: Sequence[str | Path] = (), bpc_paths: Sequence[str | Path] = ()):
        self.spks = [SPK(p) for p in spk_paths]
        self.bpcs = [BPC(p) for p in bpc_paths]

    def _spk_with(self, target: int):
        for spk in self.spks:
            if any(s.target == target for s in spk.segments):
                return spk
        return None

    @lru_cache(maxsize=256)
    def _records(self, spk_id: int, target: int):
        spk = self.spks[spk_id]
        seg = spk.segment_for(target)
        rec = spk.chebyshev_records(seg)
        # Chebyshev derivative coefficients for exact velocities
        dcoeffs = np.polynomial.chebyshev.chebder(rec.coeffs, 1, axis=-1)
        return seg, rec, dcoeffs

    def _state_chain(self, body: int, t: np.ndarray, with_velocity: bool):
        """Vectorized (pos, vel) of `body` about the SSB through the loaded
        SPKs, km and km/s; velocities from the exact Chebyshev derivative.
        A body that no kernel covers ends the chain analytically
        (heliocentric: the Sun-vs-SSB convention cancels in a target-center
        difference when both chains end the same way)."""
        pos = np.zeros(t.shape + (3,))
        vel = np.zeros(t.shape + (3,)) if with_velocity else None
        while body != 0:
            spk = self._spk_with(body)
            if spk is None:
                pos = pos + analytic.heliocentric(body, t)
                if with_velocity:
                    h = 2.0
                    vel = vel + (analytic.heliocentric(body, t + h)
                                 - analytic.heliocentric(body, t - h)) / (2.0 * h)
                break
            seg, rec, dcoeffs = self._records(self.spks.index(spk), body)
            # records are clipped at the ends: a kernel that does not cover
            # `t` extrapolates its edge record, as the reference's
            i = np.clip(((t - rec.init) // rec.intlen).astype(int), 0, rec.n_records - 1)
            tau = 2.0 * (t - rec.init - i * rec.intlen) / rec.intlen - 1.0
            V = np.polynomial.chebyshev.chebvander(tau, rec.degree)
            pos = pos + np.einsum("...kd,...d->...k", rec.coeffs[i, 0:3, :], V)
            if with_velocity:
                vel = vel + np.einsum("...kd,...d->...k", dcoeffs[i, 0:3, :],
                                      V[..., : rec.degree]) * (2.0 / rec.intlen)
            body = seg.center
        return pos, vel

    def position(self, target: int, center: int, t_tdb_s) -> np.ndarray:
        """Position of target rel center at TDB seconds (array ok), EME2000 km."""
        t = np.atleast_1d(np.asarray(t_tdb_s, dtype=np.float64))
        if self.spks:
            try:
                out = self._state_chain(target, t, False)[0] - self._state_chain(center, t, False)[0]
                return out.reshape(np.shape(t_tdb_s) + (3,))
            except KeyError:
                pass
        out = analytic.state_between(target, center, t)
        return out.reshape(np.shape(t_tdb_s) + (3,))

    def state(self, target: int, center: int, epoch: Epoch):
        """(r [3] km, v [3] km/s) of `target` about `center` in EME2000 at
        `epoch`. Through the chains above: each body's state from the
        kernels that cover it (exact Chebyshev velocities), finished by its
        heliocentric analytic state (the SSB's is zero, as the chain ends at
        the Sun) with velocities by central differences, h = 2 s. Where a
        kernel fails to resolve a chain, both come from `position`'s
        analytic fallback by central differences."""
        t = np.atleast_1d(epoch.to_tdb_seconds())
        try:
            rt, vt = self._state_chain(target, t, with_velocity=True)
            rc, vc = self._state_chain(center, t, with_velocity=True)
            return (rt - rc)[0], (vt - vc)[0]
        except KeyError:
            pass
        r = self.position(target, center, t)[0]
        h = 2.0
        v = (self.position(target, center, t + h) - self.position(target, center, t - h))[0] / (2 * h)
        return r, v

    def translate_to(self, orbit, frame):
        """`orbit` re-centred on `frame`'s body. Both frames must be
        J2000-aligned unless the centres match (then only the frame
        changes); a rotating frame needs `Trajectory.to_frame`."""
        if orbit.frame.center == frame.center:
            return dataclasses.replace(orbit, frame=frame)
        if not (orbit.frame.is_inertial and frame.is_inertial):
            raise ConfigError("translate_to supports J2000-aligned frames only; use "
                              "Trajectory.to_frame for rotating-frame output")
        r_c, v_c = self.state(orbit.frame.center, frame.center, orbit.epoch)
        return dataclasses.replace(orbit, r_km=np.asarray(orbit.r_km) + r_c,
                                   v_km_s=np.asarray(orbit.v_km_s) + v_c, frame=frame)

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
        by `pad_days` (through the SPK chain where a kernel covers a body),
        and place the float64 table on `device`."""
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


_DEFAULT = None


def _is_real_kernel(p: Path) -> bool:
    """True when `p` looks like an actual DAF kernel rather than a git-LFS
    pointer stub (133-byte text files are common in cloned repos)."""
    try:
        if p.stat().st_size < 2048:
            return False
        with open(p, "rb") as f:
            head = f.read(8)
        return head.startswith(b"DAF/")
    except OSError:
        return False


def default_almanac() -> Almanac:
    """Process-wide Almanac.

    Scans, in order: ``$NYX_TPU_DATA``, the ``data/`` directory beside the
    package, and ``~/.nyx_tpu/data`` for ``*.bsp``/``*.bpc`` kernels,
    skipping git-LFS pointer stubs, as the reference's does. When a real
    SPK is found the DAF Chebyshev path supersedes the analytic series for
    every body the kernel covers (`Almanac.position` falls back per body
    otherwise)."""
    global _DEFAULT
    if _DEFAULT is None:
        spks, bpcs = [], []
        roots = []
        data_dir = os.environ.get("NYX_TPU_DATA")
        if data_dir:
            roots.append(Path(data_dir))
        roots.append(Path(__file__).resolve().parents[2] / "data")
        roots.append(Path.home() / ".nyx_tpu" / "data")
        for d in roots:
            if not d.is_dir():
                continue
            spks.extend(p for p in sorted(d.glob("*.bsp")) if _is_real_kernel(p))
            bpcs.extend(p for p in sorted(d.glob("*.bpc")) if _is_real_kernel(p))
        try:
            _DEFAULT = Almanac(spks, bpcs)
        except Exception:
            _DEFAULT = Almanac()
    return _DEFAULT
