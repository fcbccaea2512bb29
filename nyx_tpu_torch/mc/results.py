"""Monte Carlo results: ensemble queries and export.

Torch port of nyx_tpu/mc/results.py. Final states, statuses, step counts,
the dispersed initial states and (with `n_capture` > 0) every run's
captured trajectory are host numpy arrays, as in the reference; the
queries over them run as torch operations on the results' `device` (the
card unless the caller asks for the CPU): StateParameters of the finals
and initials, the whole ensemble interpolated at shared epochs (`_interp_all`,
a batched two-point quintic Hermite on the capture buffers, the port's own
counterpart of nyx_tpu/native/hermite.cpp's `hermite_interp_ensemble`),
`every_value_of`, the nth event of every run (`locate_nth_event`, a
sign-change count and a batched bisection) and the parquet export of the
finals, of a time grid, or of every captured node (`step="nodes"`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..cosmic.spacecraft import Spacecraft
from ..errors import MonteCarloError
from ..md import param as param_mod
from ..propagators.instance import _secs
from ..propagators.integrator import DONE
from ..time import Epoch


def _two_body_j2_accel(r, mu: float, j2: float, re: float):
    """[.., 3] end-node acceleration for the quintic interpolant: two-body
    plus the J2 zonal term about the inertial z-axis (Vallado Eq. 8-30
    form). `r` is a float64 tensor."""
    rm = torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-12)
    a = (-mu / rm**3) * r
    if j2 > 0.0 and re > 0.0:
        z2_r2 = (r[..., 2:3] / rm) ** 2
        k = -1.5 * j2 * mu * re**2 / rm**5
        fac = torch.cat([1.0 - 5.0 * z2_r2, 1.0 - 5.0 * z2_r2, 3.0 - 5.0 * z2_r2], dim=-1)
        a = a + k * fac * r
    return a


def _hermite_cubic(t0, t1, y0, y1, t, mu: float = 0.0, j2: float = 0.0, re: float = 0.0):
    """Two-point Hermite between captured steps, y = [.., r(3), v(3), ..]:
    quintic in position when `mu` > 0, with the end velocities and the
    two-body (+J2) accelerations as end data, the velocity its derivative;
    the plain cubic when `mu` = 0; linear in the other columns. Tensors
    broadcast over leading axes; t in [t0, t1]."""
    h = torch.clamp(t1 - t0, min=1e-12)
    s = torch.clamp((t - t0) / h, 0.0, 1.0)[..., None]
    r0, v0 = y0[..., 0:3], y0[..., 3:6]
    r1, v1 = y1[..., 0:3], y1[..., 3:6]
    hN = h[..., None]
    rest = y0[..., 6:] + (y1[..., 6:] - y0[..., 6:]) * s
    s2 = s * s
    s3 = s2 * s
    if mu > 0.0:
        a0 = _two_body_j2_accel(r0, mu, j2, re)
        a1 = _two_body_j2_accel(r1, mu, j2, re)
        s4 = s3 * s
        s5 = s4 * s
        h00 = 1 - 10 * s3 + 15 * s4 - 6 * s5
        h10 = s - 6 * s3 + 8 * s4 - 3 * s5
        h20 = 0.5 * s2 - 1.5 * s3 + 1.5 * s4 - 0.5 * s5
        h01 = 10 * s3 - 15 * s4 + 6 * s5
        h11 = -4 * s3 + 7 * s4 - 3 * s5
        h21 = 0.5 * s3 - s4 + 0.5 * s5
        r = (h00 * r0 + h10 * hN * v0 + h20 * hN**2 * a0
             + h01 * r1 + h11 * hN * v1 + h21 * hN**2 * a1)
        d00 = (-30 * s2 + 60 * s3 - 30 * s4) / hN
        d10 = 1 - 18 * s2 + 32 * s3 - 15 * s4
        d20 = (s - 4.5 * s2 + 6 * s3 - 2.5 * s4) * hN
        d01 = (30 * s2 - 60 * s3 + 30 * s4) / hN
        d11 = -12 * s2 + 28 * s3 - 15 * s4
        d21 = (1.5 * s2 - 4 * s3 + 2.5 * s4) * hN
        v = d00 * r0 + d10 * v0 + d20 * a0 + d01 * r1 + d11 * v1 + d21 * a1
        return torch.cat([r, v, rest], dim=-1)
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    d00 = (6 * s2 - 6 * s) / hN
    d10 = 3 * s2 - 4 * s + 1
    d01 = (-6 * s2 + 6 * s) / hN
    d11 = 3 * s2 - 2 * s
    r = h00 * r0 + h10 * hN * v0 + h01 * r1 + h11 * hN * v1
    v = d00 * r0 + d10 * v0 + d01 * r1 + d11 * v1
    return torch.cat([r, v, rest], dim=-1)


@dataclass
class Results:
    epoch0: Epoch
    end_epoch: Epoch
    template: Spacecraft
    y_final: np.ndarray  # [B, N]: N = 9, or 10 with the guidance mode last
    status: np.ndarray  # [B]
    n_accepted: np.ndarray  # [B]
    n_rejected: np.ndarray  # [B]
    #: per-run capture buffers (None unless run with n_capture > 0); sample
    #: 0 is the initial state
    traj_t: Optional[np.ndarray] = None  # [B, K] s after epoch0 (valid: traj_len)
    traj_y: Optional[np.ndarray] = None  # [B, K, N]
    traj_len: Optional[np.ndarray] = None  # [B]
    #: set by locate_nth_event
    event_t: Optional[np.ndarray] = None  # [B] s after epoch0 of the nth crossing
    event_y: Optional[np.ndarray] = None  # [B, N] state at the crossing
    event_found: Optional[np.ndarray] = None  # [B] bool
    y_initial: Optional[np.ndarray] = None  # [B, N] dispersed initial states
    #: J2 and radius of the propagation's central body, the quintic capture
    #: interpolant's end-acceleration data (0: two-body)
    interp_j2: float = 0.0
    interp_re_km: float = 0.0
    iterations: int = 0  # host-loop iterations of the propagation
    #: where the queries run
    device: str = "cuda"

    @property
    def n_runs(self) -> int:
        return self.y_final.shape[0]

    @property
    def has_trajectories(self) -> bool:
        return self.traj_t is not None

    @property
    def n_ok(self) -> int:
        return int(np.sum(self.status == DONE))

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _values(self, parameter: str, y) -> np.ndarray:
        """A StateParameter of the states `y` [..., >= 9] on the device."""
        frame = self.template.frame
        y = self._tensor(y)[..., :9].to(torch.float64)
        return param_mod.value(parameter, y, frame.mu, frame.radius_km or 0.0).cpu().numpy()

    def final_values_of(self, parameter: str) -> np.ndarray:
        """[B] values of a StateParameter at each run's final state."""
        return self._values(parameter, self.y_final)

    def dispersion_values_of(self, parameter: str) -> tuple[float, float]:
        """(mean, standard deviation) of a StateParameter over the final
        states."""
        vals = self.final_values_of(parameter)
        return float(np.mean(vals)), float(np.std(vals))

    def first_values_of(self, parameter: str) -> np.ndarray:
        """Per-run value at the dispersed initial state."""
        if self.y_initial is None:
            raise MonteCarloError("initial states were not retained")
        return self._values(parameter, self.y_initial)

    def last_values_of(self, parameter: str) -> np.ndarray:
        """Per-run value at the final state."""
        return self.final_values_of(parameter)

    def final_state(self, index: int) -> Spacecraft:
        return self.template.set_vector(self.end_epoch, self.y_final[index][:9])

    def _require_traj(self, what: str) -> None:
        if not self.has_trajectories:
            raise MonteCarloError(f"run with n_capture > 0 to {what}")

    def trajectory(self, index: int):
        """The captured trajectory of one run as a Trajectory."""
        from ..md.trajectory import Trajectory

        self._require_traj("retain trajectories")
        k = int(self.traj_len[index])
        return Trajectory.from_capture(self.epoch0, self.traj_t[index, :k], self.traj_y[index, :k],
                                       self.template)

    def _interp_all(self, t_rel) -> np.ndarray:
        """[B, G, N] ensemble states at the shared epochs `t_rel` [G] (s after
        epoch0): per lane, the captured segment [idx - 1, idx] with idx the
        first node at or after t (clamped to [1, len - 1]), then the
        two-point quintic Hermite, all lanes at once on the device."""
        self._require_traj("retain trajectories")
        f64 = dict(dtype=torch.float64, device=self.device)
        ts = torch.as_tensor(np.asarray(self.traj_t), **f64)
        ys = torch.as_tensor(np.asarray(self.traj_y), **f64)
        lens = torch.as_tensor(np.asarray(self.traj_len), device=self.device).long()
        tq = torch.as_tensor(np.asarray(t_rel, dtype=np.float64), **f64)
        B, K, N = ys.shape
        G = tq.shape[0]
        valid = torch.arange(K, device=self.device)[None, :] < lens[:, None]
        # nodes past a lane's length sort last, so the search sees its own nodes only
        ts_sorted = torch.where(valid, ts, torch.full_like(ts, float("inf")))
        idx = torch.searchsorted(ts_sorted, tq.expand(B, G).contiguous())
        idx = torch.minimum(torch.clamp(idx, min=1), torch.clamp(lens - 1, min=1)[:, None])
        lanes = torch.arange(B, device=self.device)[:, None]
        mu = self.template.frame.mu or 0.0
        out = _hermite_cubic(ts[lanes, idx - 1], ts[lanes, idx], ys[lanes, idx - 1], ys[lanes, idx],
                             tq.expand(B, G), mu, self.interp_j2, self.interp_re_km)
        return out.cpu().numpy()

    def every_value_of(self, parameter: str, step, value_if_run_failed=None):
        """(t_rel_s [G], values [B, G]) of a StateParameter every `step`
        over the arc, across the whole ensemble."""
        dur = float((self.end_epoch - self.epoch0).to_seconds())
        ts = np.arange(0.0, dur + 1e-9, _secs(step))
        ys = self._interp_all(ts)
        vals = self._values(parameter, ys)
        if value_if_run_failed is not None:
            vals[self.status != DONE] = value_if_run_failed
        return ts, vals

    def locate_nth_event(self, event, trigger: int) -> None:
        """Per run, the `trigger`-th zero crossing (counted from 1) of
        `event` over the capture buffers: sign changes between valid
        nodes (an angle's wrap-around jumps skipped), then 40 bisections
        on the bracketing Hermite segment, every lane at once. Sets
        event_t, event_y and event_found; a run without that crossing
        keeps its final state and last node time."""
        self._require_traj("locate events")
        frame = self.template.frame
        mu, radius = frame.mu, frame.radius_km or 0.0
        f64 = dict(dtype=torch.float64, device=self.device)
        ts = torch.as_tensor(np.asarray(self.traj_t), **f64)
        ys = torch.as_tensor(np.asarray(self.traj_y), **f64)
        lens = torch.as_tensor(np.asarray(self.traj_len), device=self.device).long()
        B, K, N = ys.shape
        g = event.g(ys[..., :9], mu, radius)
        valid = torch.arange(K, device=self.device)[None, :] < lens[:, None]
        flip = (g[:, :-1] * g[:, 1:] < 0.0) & valid[:, 1:] & valid[:, :-1]
        if event.is_angle:
            flip &= torch.abs(g[:, 1:] - g[:, :-1]) < 180.0
        count = torch.cumsum(flip.to(torch.int64), dim=1)
        hit = flip & (count == trigger)
        found = hit.any(dim=1)
        seg = torch.where(found, torch.argmax(hit.to(torch.int32), dim=1), 0)
        lanes = torch.arange(B, device=self.device)
        t_lo, t_hi = ts[lanes, seg], ts[lanes, seg + 1]
        y_lo, y_hi = ys[lanes, seg], ys[lanes, seg + 1]
        j2, re = self.interp_j2, self.interp_re_km
        a, b = t_lo.clone(), t_hi.clone()
        g_lo = g[lanes, seg]
        for _ in range(40):
            mid = 0.5 * (a + b)
            g_mid = event.g(_hermite_cubic(t_lo, t_hi, y_lo, y_hi, mid, mu, j2, re)[:, :9], mu, radius)
            left = g_lo * g_mid > 0.0
            a = torch.where(left, mid, a)
            g_lo = torch.where(left, g_mid, g_lo)
            b = torch.where(left, b, mid)
        t_ev = 0.5 * (a + b)
        y_ev = _hermite_cubic(t_lo, t_hi, y_lo, y_hi, t_ev, mu, j2, re)
        last_t = ts[lanes, torch.clamp(lens - 1, min=0)]
        y_final = torch.as_tensor(np.asarray(self.y_final), **f64)
        self.event_t = torch.where(found, t_ev, last_t).cpu().numpy()
        self.event_y = torch.where(found[:, None], y_ev, y_final).cpu().numpy()
        self.event_found = found.cpu().numpy()

    def event_state(self, index: int) -> Spacecraft:
        if self.event_t is None:
            raise MonteCarloError("call locate_nth_event (or run_until_nth_event) first")
        return self.template.set_vector(self.epoch0 + float(self.event_t[index]),
                                        self.event_y[index][:9])

    _PER_RUN = ("y_final", "status", "n_accepted", "n_rejected", "traj_t", "traj_y", "traj_len",
                "event_t", "event_y", "event_found", "y_initial")

    def truncated(self, n: int) -> "Results":
        """The first n runs."""
        return dataclasses.replace(self, **{
            k: None if getattr(self, k) is None else getattr(self, k)[:n] for k in self._PER_RUN})

    @classmethod
    def concatenate(cls, chunks: list) -> "Results":
        """One Results of the runs of `chunks`, in order; capture buffers
        must share their length K."""
        first = chunks[0]
        return dataclasses.replace(first, iterations=max(c.iterations for c in chunks), **{
            k: None if getattr(first, k) is None else np.concatenate([getattr(c, k) for c in chunks])
            for k in cls._PER_RUN})

    def to_parquet(self, path, fields=("x", "y", "z", "vx", "vy", "vz", "sma", "ecc", "inc"),
                   trajectories: bool = False, step=None) -> str:
        """Parquet (zstd, the port's watermark) of the final states, one row
        a run (`run`, `status`, `fields`); or, with trajectories=True, of the
        ensemble's time history, one row a (run, epoch): at every captured
        node of each run with step="nodes", else every `step` (60 s by
        default) on a grid shared by the runs (`run`, `epoch_rel_s`,
        `fields`)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        from ..io.export import WATERMARK

        if not trajectories:
            cols = {"run": np.arange(self.n_runs), "status": self.status}
            flat = self.y_final
        else:
            self._require_traj("export trajectories")
            if step == "nodes":
                lens = np.asarray(self.traj_len)
                mask = np.arange(self.traj_t.shape[1])[None, :] < lens[:, None]
                cols = {"run": np.repeat(np.arange(len(lens)), lens).astype(np.int32),
                        "epoch_rel_s": np.asarray(self.traj_t)[mask]}
                flat = np.asarray(self.traj_y)[mask]
            else:
                dur = float((self.end_epoch - self.epoch0).to_seconds())
                ts = np.arange(0.0, dur + 1e-9, _secs(step) if step is not None else 60.0)
                ys = self._interp_all(ts)
                B, G, N = ys.shape
                cols = {"run": np.repeat(np.arange(B), G), "epoch_rel_s": np.tile(ts, B)}
                flat = ys.reshape(B * G, N)
        y = self._tensor(flat)
        for f in fields:
            cols[f] = self._values(f, y)
        table = pa.table(cols).replace_schema_metadata(WATERMARK)
        pq.write_table(table, str(path), compression="zstd")
        return str(path)
