"""Batched orbit determination: the staged filters of nyx_tpu/od/scan_filter.py.

Torch port of `ScanKalmanOD` with `prop_mode="batch"`, over ground
stations (optionally tracking a spacecraft about another body through their
centre-offset tables, `GroundStation.with_target_frame`) or interlink
transmitters (`InterlinkTxSpacecraft`), one family a filter. A classical
Kalman filter linearizes about a nominal trajectory that does not depend on
the measurements, so the reference
(`_build_batch`, scan_filter.py:699-1292) splits one arc into four stages,
and so does the port, on the filter's device:

- s1: the nominal from the initial estimate, one lane of adaptive RK with
  every accepted step captured (steps no longer than `max_gap_s`), and
  the EOM's accelerations at the nodes;
- s2: the nominal at every row's previous time by quintic Hermite
  interpolation of the nodes, then every gap's STM at once: one fixed RK
  step of the [M, 90] state-and-STM EOM over each row's gap;
- s3: each row's computed observation and its partials H (forward mode
  over the state; a two-way row averages the one-way values at t and at
  t - T_int, the state there interpolated from the nodes, see
  `observe_rows` and `interlink_rows`; a transmitter's state and a
  station's centre offset come from per-device Hermite tables gathered by
  tracker index, functions of t alone, so they carry no tangent), the
  prefit z = observed - computed, R from the devices' noise, and the SNC
  process noise Q;
- s4: the sequential Joseph update with Cholesky whitening and the sigma
  gate, 9x9 algebra row by row, at float64; or at float32 after scaling
  each state lane by 1/sqrt(P0_ii), in square-root form (see
  `filter_scan_f32`).

`variant="ckf"` runs the four stages once over the whole arc, or, with
`iterations` > 1, relinearizes between passes by a Gauss-Newton
correction of the initial state (`_gn_dev0`). `variant="ekf"` is the
segmented reference-update filter (`_process_arc_ekf`): the arc is cut
into `segment_rows`-row segments, each runs the four stages, and the
estimate and covariance of a segment's last row start the next segment's
nominal. `predict_for` maps a covariance over a uniform grid through the
same stages.

The reference's `lax.scan` over rows becomes a host loop that queues the
rows' small tensor operations without a host round trip: factorizations
report failure through `cholesky_ex`, checked once after the loop. Each
stage ends with one synchronization so its wall can be read
(`stage_walls_s`); stage 1's also tells whether its capture buffer
saturated, in which case the buffer doubles and the pass (for the EKF,
the whole arc) reruns.

Not ported yet: the associative-scan filter (`filter_mode="parallel"`),
prop_mode "fixed" and "adaptive", estimated measurement biases and
`process_arc_batch`. The reference's ahead-of-time compile cache, compiler
options and the EKF's padding of every segment to one row count (which only lets the
segments share one compiled shape; a padded row is a masked update over a
zero gap) are TPU tooling with no counterpart.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..cosmic.orbit import ric_dcm, vnc_dcm
from ..dynamics.gravity import Harmonics
from ..dynamics.orbital import OrbitalDynamics
from ..dynamics.spacecraft_dyn import SpacecraftDynamics
from ..errors import ConfigError, PropagationError
from ..propagators import integrator
from ..time import Duration, Epoch
from .ground_station import observe, require_same_center, station_geometry
from .interlink import is_interlink, link_observe, stack_tables, table_state_rows
from .msr import TrackingDataArc

STATE_DIM = 9
# R of a row whose type is absent (fillers included): the row then carries
# no information. The f32 algebra clamps it to 1e18, whose square still
# fits a float32 and which is still ~1e12 times any real variance.
MASKED_R = 1e30
MASKED_R_F32 = 1e18
# Capture-buffer growth attempts before giving up.
CAPTURE_ATTEMPTS = 4


@dataclass
class ScanODResult:
    """Stacked filter outputs, one row per measurement."""

    epochs_tai_s: np.ndarray  # [M]
    y_est: np.ndarray  # [M, 9] best estimate (nominal + deviation)
    covar: np.ndarray  # [M, 9, 9]
    prefit: np.ndarray  # [M, T]
    postfit: np.ndarray  # [M, T]
    ratio: np.ndarray  # [M]
    rejected: np.ndarray  # [M] bool
    types: Tuple[str, ...] = ()

    @property
    def accepted(self) -> int:
        return int(np.sum(~self.rejected))

    def final_state(self) -> np.ndarray:
        return self.y_est[-1]

    def final_covar(self) -> np.ndarray:
        return self.covar[-1]

    def to_parquet(self, path) -> str:
        """The rows as parquet: epoch, rejection and ratio, each state
        component with its sigma, and each type's pre- and post-fit
        residuals (the reference's column names)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols = {"epoch_tai_s": self.epochs_tai_s, "rejected": self.rejected, "ratio": self.ratio}
        names = ["x_km", "y_km", "z_km", "vx_km_s", "vy_km_s", "vz_km_s", "mass_kg", "cr", "cd"]
        for j, n in enumerate(names[: self.y_est.shape[1]]):
            cols[n] = self.y_est[:, j]
            cols[f"sigma_{n}"] = np.sqrt(self.covar[:, j, j])
        for j, t in enumerate(self.types):
            cols[f"prefit_{t}"] = self.prefit[:, j]
            cols[f"postfit_{t}"] = self.postfit[:, j]
        pq.write_table(pa.table(cols), str(path))
        return str(path)


def interp_quintic(ts_n, ys_n, acc_n, tq):
    """Quintic Hermite (position, velocity and acceleration at both ends
    of the interval) at query times tq [M] from nodes ts_n [K], ys_n
    [K, 9], acc_n [K, 3]; linear in columns 6 and up. Returns [M, 9]."""
    K = ts_n.shape[0]
    i = torch.clamp(torch.searchsorted(ts_n, tq, right=True) - 1, 0, K - 2)
    t0, t1 = ts_n[i], ts_n[i + 1]
    h = torch.clamp(t1 - t0, min=1e-30)
    s = torch.clamp((tq - t0) / h, 0.0, 1.0)[:, None]
    r0, v0, a0 = ys_n[i, 0:3], ys_n[i, 3:6], acc_n[i]
    r1, v1, a1 = ys_n[i + 1, 0:3], ys_n[i + 1, 3:6], acc_n[i + 1]
    hh = h[:, None]
    s2, s3 = s * s, s * s * s
    s4, s5 = s2 * s2, s2 * s3
    h00 = 1 - 10 * s3 + 15 * s4 - 6 * s5
    h10 = s - 6 * s3 + 8 * s4 - 3 * s5
    h20 = 0.5 * (s2 - 3 * s3 + 3 * s4 - s5)
    h01 = 10 * s3 - 15 * s4 + 6 * s5
    h11 = -4 * s3 + 7 * s4 - 3 * s5
    h21 = 0.5 * (s3 - 2 * s4 + s5)
    r = h00 * r0 + h10 * hh * v0 + h20 * hh * hh * a0 + h01 * r1 + h11 * hh * v1 + h21 * hh * hh * a1
    d00 = -30 * s2 + 60 * s3 - 30 * s4
    d10 = 1 - 18 * s2 + 32 * s3 - 15 * s4
    d20 = 0.5 * (2 * s - 9 * s2 + 12 * s3 - 5 * s4)
    d01 = 30 * s2 - 60 * s3 + 30 * s4
    d11 = -12 * s2 + 28 * s3 - 15 * s4
    d21 = 0.5 * (3 * s2 - 8 * s3 + 5 * s4)
    v = d00 * r0 / hh + d10 * v0 + d20 * hh * a0 + d01 * r1 / hh + d11 * v1 + d21 * hh * a1
    rest0, rest1 = ys_n[i, 6:], ys_n[i + 1, 6:]
    return torch.cat([r, v, rest0 + s * (rest1 - rest0)], dim=-1)


def _observe_folded(t_tdb, rv_t, rv_tm, tint, geometry, observe_fn):
    """Computed observations [M, T] and their partials H [M, T, 9] of M
    rows at TDB epochs t_tdb [M]: `geometry(t [N], rows [N])` gives the
    per-row tensors (or None) that `observe_fn(rv [N, 6], *geometry)`
    observes states against, rows indexing the M rows.

    One-way rows observe the states rv_t [M, 6] at t. With rv_tm [M, 6],
    the states at t - tint (tint [M], 0 for one-way rows), a two-way row's
    value is the average of the one-way values at both ends (each with its
    own geometry), and its H is 0.5 (H1 + H0 Phi_back), Phi_back being I
    with -tint I3 in block [0:3, 3:6]: the backward flow to t - tint to
    first order (the reference's stage 3, scan_filter.py:1141-1187). Both
    ends and the six unit tangents of position and velocity are folded into
    the batch axis of one forward-mode call; the observables do not depend
    on Cr, Cd or mass, so those columns of H are zero."""
    m_rows = t_tdb.shape[0]
    rows = torch.arange(m_rows, device=t_tdb.device)
    ends = 1 if rv_tm is None else 2
    if ends == 2:
        t_tdb = torch.cat([t_tdb, t_tdb - tint])
        rv = torch.cat([rv_t, rv_tm])
        rows = torch.cat([rows, rows])
    else:
        rv = rv_t
    geo = geometry(t_tdb, rows)
    n_rv, n = 6, ends * m_rows
    eye = torch.eye(n_rv, dtype=rv.dtype, device=rv.device)
    geo6 = tuple(None if g is None else g.repeat((n_rv,) + (1,) * (g.dim() - 1)) for g in geo)
    computed, cols = torch.func.jvp(
        lambda x: observe_fn(x, *geo6),
        (rv.repeat(n_rv, 1),), (eye.repeat_interleave(n, dim=0),))
    computed = computed[:n]
    h_rv = cols.reshape(n_rv, n, -1).permute(1, 2, 0)
    if ends == 2:
        two = (tint > 0.0)[:, None]
        v1, v0 = computed[:m_rows], computed[m_rows:]
        h1, h0 = h_rv[:m_rows], h_rv[m_rows:]
        h0_back = torch.cat([h0[:, :, 0:3], h0[:, :, 3:6] - tint[:, None, None] * h0[:, :, 0:3]],
                            dim=-1)
        computed = torch.where(two, 0.5 * (v0 + v1), v1)
        h_rv = torch.where(two[:, :, None], 0.5 * (h1 + h0_back), h1)
    return computed, torch.cat([h_rv, torch.zeros_like(h_rv[:, :, :STATE_DIM - n_rv])], dim=-1)


def observe_rows(t_tdb, rv_t, rv_tm, lat, lon, hgt, lt, tint, frame, types, offset=None):
    """`_observe_folded` for stations given per row (lat, lon, hgt [M]; lt
    [M], > 0 for a light-time-corrected station, or None for none; tint
    [M]). `offset`, if given, is (trk [M], ts [D, K], ys [D, K, 6]): each
    row's station's centre-offset table (`stack_tables`), whose state at
    each end's time is added to the spacecraft's before the geometry."""

    def geometry(t, r):
        off = None if offset is None else table_state_rows(t, offset[0][r], offset[1], offset[2])
        return station_geometry(t, lat[r], lon[r], hgt[r], frame) + (
            None if lt is None else lt[r], off)

    def obs(x, r_st, v_st, sez, lt_r, off):
        return observe(x if off is None else x + off, r_st, v_st, sez, types, lt=lt_r)

    return _observe_folded(t_tdb, rv_t, rv_tm, tint, geometry, obs)


def interlink_rows(t_tdb, rv_t, rv_tm, trk, tint, ts_tab, ys_tab, types):
    """`_observe_folded` for interlink transmitters: row m's transmitter
    state from table trk[m] of the stacked tables (ts [D, K], ys [D, K, 6])
    at each end's time."""
    return _observe_folded(
        t_tdb, rv_t, rv_tm, tint,
        lambda t, r: (table_state_rows(t, trk[r], ts_tab, ys_tab),),
        lambda x, tx: link_observe(x, tx, types))


def filter_scan(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh: float, gate: bool):
    """The sequential Joseph CKF over precomputed rows, at p0's dtype
    (the reference's `filter_scan`, scan_filter.py:799-845). Returns
    (deviations [M, d], covariances [M, d, d], prefit [M, T], postfit
    [M, T], ratios [M], rejected [M]). Raises if any innovation covariance
    is not positive definite. When no row holds a measurement (covariance
    mapping, `predict_for`), the rows are time updates alone
    (`_time_updates`): the masked measurement update's gain is ~1e-30 of
    P H^T and changes nothing that float64 keeps."""
    if not bool(avail.any()):
        return _time_updates(phi, q_all, p0, z_all.shape[-1])
    dt, dev_ = p0.dtype, p0.device
    m_rows, d = phi.shape[0], p0.shape[-1]
    zero = torch.zeros((), dtype=dt, device=dev_)
    eye = torch.eye(d, dtype=dt, device=dev_)
    thresh = torch.tensor(rej_thresh, dtype=dt, device=dev_)
    n_avail = torch.clamp(avail.sum(dim=-1), min=1).to(dt).sqrt()
    dev = torch.zeros(d, dtype=dt, device=dev_)
    p = p0
    out = [[] for _ in range(7)]
    for i in range(m_rows):
        ph, h, av, r_diag = phi[i], h_all[i], avail[i], torch.diag(r_all[i])
        p_bar = ph @ p @ ph.T + q_all[i]
        dev_bar = ph @ dev
        prefit = torch.where(av, z_all[i] - h @ dev_bar, zero)
        l_chol, info = torch.linalg.cholesky_ex(h @ p_bar @ h.T + r_diag)
        white = torch.linalg.solve_triangular(l_chol, prefit[:, None], upper=False)[:, 0]
        ratio = torch.linalg.vector_norm(white) / n_avail[i]
        rejected = ratio > thresh if gate else torch.zeros((), dtype=torch.bool, device=dev_)
        # K^T = S^-1 H P_bar^T by two triangular solves with the factor
        k_t = torch.linalg.solve_triangular(
            l_chol.mT, torch.linalg.solve_triangular(l_chol, h @ p_bar.T, upper=False),
            upper=True)
        k_gain = torch.where(rejected, zero, k_t.T)
        dev = dev_bar + k_gain @ prefit
        postfit = torch.where(av, z_all[i] - h @ dev, zero)
        ikh = eye - k_gain @ h
        p = ikh @ p_bar @ ikh.T + k_gain @ r_diag @ k_gain.T
        p = 0.5 * (p + p.T)
        for lst, x in zip(out, (dev, p, prefit, postfit, ratio, rejected, info)):
            lst.append(x)
    dev_all, p_all, prefit, postfit, ratio, rejected, info = (torch.stack(x) for x in out)
    bad = torch.nonzero(info).flatten().cpu()
    if len(bad):
        raise PropagationError(
            f"innovation covariance not positive definite at {len(bad)} rows, first row {int(bad[0])}")
    return dev_all, p_all, prefit, postfit, ratio, rejected


def _time_updates(phi, q_all, p0, n_types: int):
    """`filter_scan`'s outputs over rows without measurements: P = Phi P
    Phi^T + Q, symmetrized, row by row (three small operations a row
    instead of the update's ~25); zero deviations and residuals, ratio 0,
    nothing rejected."""
    m_rows, d = phi.shape[0], p0.shape[-1]
    p, p_all = p0, []
    for i in range(m_rows):
        p = phi[i] @ p @ phi[i].T + q_all[i]
        p = 0.5 * (p + p.T)
        p_all.append(p)
    zeros = dict(dtype=p0.dtype, device=p0.device)
    resid = torch.zeros(m_rows, n_types, **zeros)
    return (torch.zeros(m_rows, d, **zeros), torch.stack(p_all), resid, resid.clone(),
            torch.zeros(m_rows, **zeros), torch.zeros(m_rows, dtype=torch.bool, device=p0.device))


def _psd_factor(m):
    """F with F F^T = m for symmetric positive semidefinite m [..., d, d],
    from the eigendecomposition (Cholesky refuses the singular ones)."""
    lam, v = torch.linalg.eigh(m)
    return v * torch.sqrt(torch.clamp(lam, min=0.0))[..., None, :]


def filter_scan_f32(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh: float, gate: bool):
    """The CKF of `filter_scan` at float32, in square-root form.

    As in the reference (scan_filter.py:1026-1056), every state lane is
    first scaled by 1/sqrt(P0_ii) (lanes of zero variance keep scale 1),
    so the units' 1e10 spread never meets float32's 7 digits; ratios, gains
    and rejections do not change under the scaling, and the outputs are
    scaled back and returned at float64. Unlike the reference, the rows
    carry a factor S of P = S S^T, not P: the time update triangularizes
    [Phi S, Q^1/2] and the measurement update the array
    [[R^1/2, H S], [0, S]] -> [[W, 0], [K W, S+]] (W W^T = H P H^T + R), both
    by QR. A float32 Joseph chain, the reference's form, lost the
    covariance of the bench's one-day arc past the 5 % of the sigmas that
    TestF32FilterAlgebra allows (chip_smoke.py holds the f32 run to the
    f64 one); a factor's condition number is the square root of P's. The
    products must run at full float32: a global matmul precision other
    than "highest" (TF32) raises instead of being changed here."""
    if torch.get_float32_matmul_precision() != "highest":
        raise ConfigError(
            "filter_algebra='f32' needs torch.get_float32_matmul_precision() == 'highest' "
            f"(it is {torch.get_float32_matmul_precision()!r}): TF32 products break the algebra")
    f32, f64 = torch.float32, torch.float64
    pd = torch.diagonal(p0)
    sc = torch.where(pd > 1e-20, 1.0 / torch.sqrt(torch.clamp(pd, min=1e-20)), torch.ones_like(pd))
    inv = 1.0 / sc
    phi_s = (phi * sc[None, :, None] * inv[None, None, :]).to(f32)
    q_half = _psd_factor(q_all * sc[None, :, None] * sc[None, None, :]).to(f32)
    h_s = (h_all * inv[None, None, :]).to(f32)
    z_s = z_all.to(f32)
    r_half = torch.sqrt(torch.clamp(r_all, max=MASKED_R_F32)).to(f32)
    s = _psd_factor(p0 * sc[:, None] * sc[None, :]).to(f32)

    dev_ = p0.device
    m_rows, d = phi.shape[0], p0.shape[-1]
    n_types = z_all.shape[-1]
    zero = torch.zeros((), dtype=f32, device=dev_)
    thresh = torch.tensor(rej_thresh, dtype=f32, device=dev_)
    n_avail = torch.clamp(avail.sum(dim=-1), min=1).to(f32).sqrt()
    dev = torch.zeros(d, dtype=f32, device=dev_)
    zero_block = torch.zeros(d, n_types, dtype=f32, device=dev_)
    out = [[] for _ in range(6)]
    for i in range(m_rows):
        ph, h, av = phi_s[i], h_s[i], avail[i]
        # time update: S_bar S_bar^T = Phi S S^T Phi^T + Q
        s_bar = torch.linalg.qr(torch.cat([ph @ s, q_half[i]], dim=1).mT, mode="r")[1].mT
        dev_bar = ph @ dev
        prefit = torch.where(av, z_s[i] - h @ dev_bar, zero)
        # measurement update: one QR of the pre-array gives W, K W and S+
        pre = torch.cat([torch.cat([torch.diag(r_half[i]), h @ s_bar], dim=1),
                         torch.cat([zero_block, s_bar], dim=1)])
        post = torch.linalg.qr(pre.mT, mode="r")[1].mT
        w, kw, s_new = post[:n_types, :n_types], post[n_types:, :n_types], post[n_types:, n_types:]
        white = torch.linalg.solve_triangular(w, prefit[:, None], upper=False)[:, 0]
        ratio = torch.linalg.vector_norm(white) / n_avail[i]
        rejected = ratio > thresh if gate else torch.zeros((), dtype=torch.bool, device=dev_)
        k_gain = torch.linalg.solve_triangular(w.mT, kw.mT, upper=True).mT
        k_gain = torch.where(rejected, zero, k_gain)
        dev = dev_bar + k_gain @ prefit
        s = torch.where(rejected, s_bar, s_new)
        postfit = torch.where(av, z_s[i] - h @ dev, zero)
        for lst, x in zip(out, (dev, s @ s.mT, prefit, postfit, ratio, rejected)):
            lst.append(x)
    dev_all, p_all, prefit, postfit, ratio, rejected = (torch.stack(x) for x in out)
    return (dev_all.to(f64) * inv[None, :], p_all.to(f64) * inv[None, :, None] * inv[None, None, :],
            prefit.to(f64), postfit.to(f64), ratio.to(f64), rejected)


class ScanKalmanOD:
    """The staged batched filters over a fixed device set and type tuple,
    on `device` (the card unless the caller asks for the CPU).

    `variant`: "ckf" (one linearization, or `iterations` Gauss-Newton
    passes) or "ekf" (the segmented reference-update filter, a fold every
    `segment_rows` rows). `stm_jvp_degree`: stage 2 differentiates
    gravity fields through their first `stm_jvp_degree` degrees (values
    keep the whole field). Rows are at most `max_gap_s` apart (fillers are
    added) and so are the nominal's nodes: by default the initial orbit's
    period / 24, within [60 s, max_step]. `filter_algebra`: "f64" (Joseph)
    or "f32" (preconditioned square-root form, see filter_scan_f32).
    """

    def __init__(
        self,
        prop,
        devices: Sequence,
        types: Optional[Tuple[str, ...]] = None,
        variant: str = "ckf",
        process_noise=None,
        resid_rejection_sigmas: Optional[float] = None,
        almanac=None,
        max_gap_s: Optional[float] = None,
        stm_jvp_degree: Optional[int] = None,
        iterations: int = 1,
        segment_rows: int = 32,
        filter_algebra: str = "f64",
        *,
        device="cuda",
    ):
        if variant not in ("ckf", "ekf"):
            raise ConfigError(f"variant must be 'ckf' or 'ekf', got {variant!r}")
        if filter_algebra not in ("f64", "f32"):
            raise ConfigError("filter_algebra must be 'f64' or 'f32'")
        if not devices:
            raise ConfigError("the scan filter needs at least one device")
        # device family: ground stations or interlink transmitters
        is_link = [is_interlink(d) for d in devices]
        self._interlink = all(is_link)
        if any(is_link) and not self._interlink:
            raise ConfigError(
                "scan filter devices must be all ground stations or all interlink transmitters")
        if not self._interlink and len({d.frame for d in devices}) != 1:
            raise ConfigError("all scan-filter stations must share a frame")
        offs = [getattr(d, "target_center_offset", None) for d in devices]
        if any(o is not None for o in offs) and not all(o is not None for o in offs):
            raise ConfigError("scan-filter stations must all have a target frame offset, or none")
        self.prop = prop
        self.devices = list(devices)
        self.types = tuple(types or devices[0].measurement_types)
        self.variant = variant
        if process_noise is None:
            process_noise = ()
        elif not isinstance(process_noise, (tuple, list)):
            process_noise = (process_noise,)
        self.process_noise = tuple(process_noise)
        self.resid_rejection_sigmas = resid_rejection_sigmas
        self.almanac = almanac
        self.stm_jvp_degree = stm_jvp_degree
        self.iterations = max(1, int(iterations))
        self.segment_rows = int(segment_rows)
        self.filter_algebra = filter_algebra
        self.device = torch.device(device)
        # the longest row gap and nominal step: the caller's, or from the
        # initial orbit's period at each process_arc
        self._max_gap_user = max_gap_s
        self.max_gap_s = None if max_gap_s is None else float(max_gap_s)
        self._dyn_stm = self._stm_dynamics(prop.dynamics)
        f64 = dict(dtype=torch.float64, device=self.device)
        # per-device tables, gathered by tracker index on the device: the
        # transmitters' trajectories, or the stations' geodetic coordinates
        # and centre offsets
        self._tx_tab = self._off_tab = None
        if self._interlink:
            self.station_frame = None
            self._tx_tab = stack_tables([d.dev_traj for d in devices], self.device)
        else:
            self.station_frame = devices[0].frame
            self._lat = torch.tensor([d.latitude_deg for d in devices], **f64)
            self._lon = torch.tensor([d.longitude_deg for d in devices], **f64)
            self._hgt = torch.tensor([d.height_km for d in devices], **f64)
            if offs[0] is not None:
                self._off_tab = stack_tables(offs, self.device)
        lt = [1.0 if getattr(d, "light_time_correction", False) else 0.0 for d in devices]
        self._lt = torch.tensor(lt, **f64) if any(lt) else None
        # two-way integration times (0 for one-way stations)
        self._tint_np = np.array([float(d.integration_time_s or 0.0) for d in devices])
        self._tint = torch.tensor(self._tint_np, **f64)
        self._any_two_way = bool((self._tint_np > 0.0).any())
        rvar = np.full((len(devices), len(self.types)), MASKED_R)
        for i, d in enumerate(devices):
            for j, t in enumerate(self.types):
                n = d.stochastic_noises.get(t)
                if n is not None and t in d.measurement_types:
                    rvar[i, j] = max(n.covariance(), 1e-32)
        self._rvar = torch.tensor(rvar, **f64)
        self._kcap_grow = 1
        self._last_k_cap = 0
        # wall seconds of each stage of the last process_arc (summed over
        # its passes and segments), its segment count and its stage-1
        # integrator iterations
        self.stage_walls_s = {}

    def _stm_dynamics(self, dyn):
        """The dynamics of stage 2: Harmonics models get
        jvp_degree=stm_jvp_degree (unless already cut lower)."""
        q = self.stm_jvp_degree
        if q is None:
            return dyn
        models = tuple(
            m.with_jvp_degree(q)
            if isinstance(m, Harmonics) and m.jvp_degree is None and m.max_degree > q
            else m
            for m in dyn.orbital_dyn.models
        )
        if models == dyn.orbital_dyn.models:
            return dyn
        return SpacecraftDynamics(OrbitalDynamics(models, dyn.orbital_dyn.frame), dyn.force_models)

    def _snc_q(self, dt_s, y_ref, t_tai, t0_tai: float):
        """Per-row 9x9 process noise [M, 9, 9]: the last ProcessNoise whose
        start epoch has passed is active, with its optional decay from its
        start (or the first row) and its optional RIC/VNC frame, gated off
        for gaps of 0 or longer than its disable time."""
        m_rows = dt_s.shape[0]
        f64 = dict(dtype=torch.float64, device=dt_s.device)
        q = torch.zeros(m_rows, STATE_DIM, STATE_DIM, **f64)
        sncs = self.process_noise
        if not sncs:
            return q
        qd_tab = torch.tensor(np.stack([s.q_diag_km2_s4 for s in sncs]), **f64)
        dis_tab = torch.tensor([s.disable_time_s for s in sncs], **f64)
        tau_tab = torch.tensor(np.stack([
            np.asarray(s.decay_tau_s, dtype=np.float64) if s.decay_tau_s is not None
            else np.full(3, np.inf) for s in sncs]), **f64)
        start_tab = torch.tensor([s.start_epoch_tai_s if s.start_epoch_tai_s is not None
                                  else -np.inf for s in sncs], **f64)
        code_tab = torch.tensor([0 if s.local_frame is None
                                 else (1 if s.local_frame.lower() == "ric" else 2)
                                 for s in sncs], device=dt_s.device)
        started = start_tab[None, :] <= t_tai[:, None]  # [M, K]
        idx = torch.arange(len(sncs), device=dt_s.device)
        k_idx = torch.argmax(torch.where(started, idx, -1), dim=1)
        start = start_tab[k_idx]
        anchor = torch.where(torch.isfinite(start), start, torch.full_like(start, t0_tai))
        elapsed = torch.clamp(t_tai - anchor, min=0.0)
        qd = qd_tab[k_idx] * torch.exp(-elapsed[:, None] / tau_tab[k_idx])
        r, v = y_ref[:, 0:3], y_ref[:, 3:6]
        eye = torch.eye(3, **f64).expand(m_rows, 3, 3)
        dcm = torch.stack([eye, ric_dcm(r, v), vnc_dcm(r, v)], dim=1)[
            torch.arange(m_rows, device=dt_s.device), code_tab[k_idx]]
        q3 = dcm.mT @ torch.diag_embed(qd) @ dcm
        dt = dt_s[:, None, None]
        q[:, 0:3, 0:3] = q3 * dt**4 / 4.0
        q[:, 0:3, 3:6] = q3 * dt**3 / 2.0
        q[:, 3:6, 0:3] = q3 * dt**3 / 2.0
        q[:, 3:6, 3:6] = q3 * dt**2
        gate = (dt_s > 0.0) & (dt_s <= dis_tab[k_idx]) & started.any(dim=1)
        return torch.where(gate[:, None, None], q, torch.zeros_like(q))

    def _prepare(self, arc: TrackingDataArc, epoch0: Epoch):
        """Host-side arc layout: per-row (t_rel, trk, obs, avail) arrays,
        with masked filler rows so that no row's gap exceeds max_gap_s
        (at prev + k * max_gap_s, the remainder last), and the mask of the
        real rows."""
        t_rel = np.asarray(arc.epochs_tai_s) - epoch0.to_tai_seconds()
        m = len(arc)
        trk_names = {d.name: i for i, d in enumerate(self.devices)}
        trk = np.asarray([trk_names[arc.trackers[i]] for i in arc.tracker_idx], dtype=np.int64)
        n_types = len(self.types)
        obs = np.zeros((m, n_types))
        avail = np.zeros((m, n_types), dtype=bool)
        for j, t in enumerate(self.types):
            if t in arc.types:
                v = arc.values[:, arc.types.index(t)]
                good = np.isfinite(v)
                obs[good, j] = v[good]
                avail[:, j] = good
        rows_t, rows_trk, rows_obs, rows_avail, real = [], [], [], [], []
        prev = 0.0
        for i in range(m):
            gap = t_rel[i] - prev
            if gap > self.max_gap_s:
                for k in range(1, int(np.ceil(gap / self.max_gap_s))):
                    rows_t.append(prev + k * self.max_gap_s)
                    rows_trk.append(0)
                    rows_obs.append(np.zeros(n_types))
                    rows_avail.append(np.zeros(n_types, dtype=bool))
                    real.append(False)
            rows_t.append(t_rel[i])
            rows_trk.append(trk[i])
            rows_obs.append(obs[i])
            rows_avail.append(avail[i])
            real.append(True)
            prev = t_rel[i]
        return (np.asarray(rows_t), np.asarray(rows_trk, dtype=np.int64), np.stack(rows_obs),
                np.stack(rows_avail), np.asarray(real))

    def _layout(self, initial_estimate, arc: TrackingDataArc):
        """`_prepare` after setting max_gap_s: the caller's, or the initial
        orbit's period / 24 within [60 s, max_step] (nodes that close keep
        the quintic interpolation of the nominal far below the measurement
        noise)."""
        if self._max_gap_user is None:
            orbit = initial_estimate.nominal.orbit
            period = 2.0 * np.pi * np.sqrt(max(float(orbit.sma_km), 1.0) ** 3
                                           / orbit.frame.mu_km3_s2)
            self.max_gap_s = float(np.clip(period / 24.0, 60.0, self.prop.opts.max_step_s))
        return self._prepare(arc, initial_estimate.epoch)

    def _k_cap(self, span: float) -> int:
        """Capture room for a nominal over `span` seconds: 4 nodes per
        max_gap_s with margin, doubled after each saturated run (which
        keeps for later calls)."""
        node_hint = min(self.max_gap_s, self.prop.opts.max_step_s) / 4.0
        self._last_k_cap = (int(span / max(node_hint, 1.0)) + 64) * self._kcap_grow
        return self._last_k_cap

    def _segments(self, t_rel: np.ndarray):
        """The EKF's segments as [(b0, b1, t_prev, span)]: rows b0 to b1 - 1,
        their times measured from t_prev (the previous segment's last row,
        0 for the first) and the last of them, span. Every s_rows rows,
        each boundary shifted left (by at most s_rows // 2, keeping more
        than two rows) while the row after it is less than the longest
        two-way integration time after the row before it. A segment's
        first row looks its t - T_int state up in the segment's own
        nominal, which starts at the previous row: a boundary closer than
        T_int would clamp that lookup to the segment start, tens of
        seconds late, a ~50 km range error at orbital speed (the
        reference's _ekf_setup, scan_filter.py:1774-1796)."""
        m_rows = len(t_rel)
        s_rows = max(2, min(self.segment_rows, m_rows))
        tint_max = float(self._tint_np.max())
        bounds, b0 = [], 0
        while b0 < m_rows:
            b1 = min(b0 + s_rows, m_rows)
            if tint_max > 0.0 and b1 < m_rows:
                shift = 0
                while (shift < s_rows // 2 and b1 - b0 > 2
                       and t_rel[b1] - t_rel[b1 - 1] < tint_max - 1e-9):
                    b1 -= 1
                    shift += 1
            bounds.append((b0, b1))
            b0 = b1
        prev = [0.0] + [float(t_rel[b1 - 1]) for _, b1 in bounds[:-1]]
        return [(b0, b1, p, float(t_rel[b1 - 1]) - p) for (b0, b1), p in zip(bounds, prev)]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage1(self, y0, arc_span, k_cap, ctx, sc_params):
        """The nominal with dense capture: ((node times [K], states [K, 9],
        accelerations [K, 3]), integrator iterations), or None when the
        capture buffer saturated."""
        dyn = self.prop.dynamics
        eom9 = dyn.make_eom()
        opts = self.prop.opts
        ref_opts = replace(opts, max_step_s=min(opts.max_step_s, self.max_gap_s))
        res = integrator.propagate(
            eom9, y0[None, :], arc_span, ref_opts, self.prop.method,
            finally_fn=dyn.make_finally(), eom_args=(ctx, sc_params), n_capture=k_cap,
        )
        n_valid = int(res.traj_len[0]) + 1  # the initial node + the captured steps
        if n_valid >= k_cap:
            return None
        status = int(res.status[0])
        if status != integrator.DONE:
            raise PropagationError(f"scan-filter nominal propagation ended with status {status}")
        ts_n = torch.cat([torch.zeros(1, dtype=torch.float64, device=y0.device),
                          res.traj_t[0, : n_valid - 1]])
        ys_n = torch.cat([y0[None, :], res.traj_y[0, : n_valid - 1]])
        acc_n = eom9(ts_n, ys_n, ctx, sc_params)[:, 3:6]
        return (ts_n, ys_n, acc_n), res.iterations

    def _stage2(self, t_rel, nodes, ctx, sc_params):
        """(nominal at the rows [M, 9], STMs over the gaps [M, 9, 9], gaps [M])."""
        m_rows = t_rel.shape[0]
        t_prev = torch.cat([torch.zeros(1, dtype=torch.float64, device=t_rel.device), t_rel[:-1]])
        y_prev = interp_quintic(*nodes, t_prev)
        dt = t_rel - t_prev
        eye = torch.eye(STATE_DIM, dtype=torch.float64, device=t_rel.device).reshape(1, -1)
        y90 = torch.cat([y_prev, eye.expand(m_rows, -1)], dim=1)
        eom90 = self._dyn_stm.make_eom(with_stm=True)
        method = self.prop.method
        inc, _ = integrator._rk_stages(
            lambda t, y: eom90(t, y, ctx, sc_params), method.a_matrix, method.b, method.b_star,
            method.c, t_prev, y90, dt)
        y90 = self._dyn_stm.make_finally()(t_prev + dt, y90 + inc, ctx, sc_params)
        return y90[:, :STATE_DIM], y90[:, STATE_DIM:].reshape(m_rows, STATE_DIM, STATE_DIM), dt

    def _stage3(self, t_rel, trk, obs, avail, y_bar, dt, nodes, epoch0: Epoch, t0_rel: float):
        """(H [M, T, 9], z [M, T], R [M, T], Q [M, 9, 9]); t0_rel is the
        first row's time, the anchor of decaying SNCs without a start. A
        two-way row's state at t - T_int comes from the nominal's nodes, at
        the nominal's start if that is later."""
        y_tm = None
        if self._any_two_way:
            y_tm = interp_quintic(*nodes, torch.clamp(t_rel - self._tint[trk], min=0.0))[:, :6]
        t_tdb, tint = epoch0.to_tdb_seconds() + t_rel, self._tint[trk]
        if self._interlink:
            computed, h_all = interlink_rows(t_tdb, y_bar[:, :6], y_tm, trk, tint, *self._tx_tab,
                                             self.types)
        else:
            computed, h_all = observe_rows(
                t_tdb, y_bar[:, :6], y_tm, self._lat[trk], self._lon[trk], self._hgt[trk],
                None if self._lt is None else self._lt[trk], tint, self.station_frame, self.types,
                offset=None if self._off_tab is None else (trk,) + self._off_tab)
        z_all = torch.where(avail, obs - computed, torch.zeros_like(obs))
        r_all = torch.where(avail, self._rvar[trk], torch.full_like(obs, MASKED_R))
        t_tai = epoch0.to_tai_seconds() + t_rel
        q_all = self._snc_q(dt, y_bar, t_tai, epoch0.to_tai_seconds() + t0_rel)
        return h_all, z_all, r_all, q_all

    def _run(self, y0, p0, rows, epoch0: Epoch, t0_rel: float, span: float, k_cap: int,
             thresh: float, gate: bool, sc_params, walls):
        """The four stages over `rows` (device (t_rel, trk, obs, avail),
        times relative to `epoch0`, the start of y0 and p0), their walls
        added to `walls`. Returns the device outputs (estimates, covariances,
        prefit, postfit, ratios, rejections) and the Gauss-Newton inputs,
        or None when stage 1's capture buffer saturated."""
        t_rel, trk, obs, avail = rows
        ctx = self.prop.dynamics.build_context(epoch0, span, self.almanac, device=self.device)
        t0 = time.perf_counter()
        s1 = self._stage1(y0, span, k_cap, ctx, sc_params)
        self._sync()
        walls["s1"] += time.perf_counter() - t0
        if s1 is None:
            return None
        nodes, iters = s1
        walls["s1_iterations"] += iters

        t0 = time.perf_counter()
        y_bar, phi, dt = self._stage2(t_rel, nodes, ctx, sc_params)
        self._sync()
        walls["s2"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        h_all, z_all, r_all, q_all = self._stage3(t_rel, trk, obs, avail, y_bar, dt, nodes,
                                                   epoch0, t0_rel)
        self._sync()
        walls["s3"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        algebra = filter_scan_f32 if self.filter_algebra == "f32" else filter_scan
        dev_all, p_all, prefit, postfit, ratio, rejected = algebra(
            phi, q_all, h_all, z_all, r_all, avail, p0, thresh, gate)
        self._sync()
        walls["s4"] += time.perf_counter() - t0
        aux = dict(phi=phi, h_all=h_all, z_all=z_all, r_all=r_all, avail=avail)
        return (y_bar + dev_all, p_all, prefit, postfit, ratio, rejected), aux

    def process_arc(self, initial_estimate, arc: TrackingDataArc) -> ScanODResult:
        """Filter the arc from `initial_estimate` (a KfEstimate whose epoch
        precedes the first measurement).

        The CKF with `iterations` > 1 relinearizes between passes: the
        Gauss-Newton initial-state correction `_gn_dev0` moves the nominal's
        start and the stages rerun. Intermediate passes run with the gate
        off; only the last applies it. `variant="ekf"` runs the segmented
        filter instead (`_process_arc_ekf`)."""
        require_same_center(self.devices, initial_estimate.nominal.frame)
        gate = self.resid_rejection_sigmas is not None
        if arc.force_reject and not gate:
            raise ConfigError("resid-vs-ref arcs (force_reject) need a filter built "
                              "with resid_rejection_sigmas")
        # residual-versus-reference mode rejects every row: the solution is
        # the pure propagation
        thresh = -math.inf if arc.force_reject else (
            self.resid_rejection_sigmas if gate else math.inf)
        t_np, trk_np, obs_np, avail_np, real = self._layout(initial_estimate, arc)
        f64 = dict(dtype=torch.float64, device=self.device)
        rows = (torch.tensor(t_np, **f64), torch.tensor(trk_np, device=self.device),
                torch.tensor(obs_np, **f64), torch.tensor(avail_np, device=self.device))
        nominal, epoch0 = initial_estimate.nominal, initial_estimate.epoch
        sc_params = dict(dry_mass_kg=nominal.dry_mass_kg, srp_area_m2=nominal.srp_area_m2,
                         drag_area_m2=nominal.drag_area_m2)
        y0 = torch.tensor(nominal.to_vector(), **f64)
        p0 = torch.tensor(np.asarray(initial_estimate.covar), **f64)
        walls = dict(s1=0.0, s2=0.0, s3=0.0, s4=0.0, segments=1, s1_iterations=0)
        if self.variant == "ekf":
            out = self._process_arc_ekf(y0, p0, rows, t_np, epoch0, thresh, gate, sc_params,
                                        walls)
        else:
            n_iter = 1 if arc.force_reject else self.iterations
            span = float(t_np[-1])
            for it in range(n_iter):
                final = it == n_iter - 1
                out, aux = self._run_growing(
                    lambda: self._run(y0, p0, rows, epoch0, float(t_np[0]), span,
                                      self._k_cap(span), thresh if final else math.inf, gate,
                                      sc_params, walls))
                if not final:
                    y0 = y0 + torch.tensor(self._gn_dev0(aux, p0), **f64)
        t0 = time.perf_counter()
        host = [x.cpu().numpy()[real] for x in out]
        walls["s4"] += time.perf_counter() - t0
        self.stage_walls_s = walls
        return ScanODResult(np.asarray(arc.epochs_tai_s), *host, types=self.types)

    def _run_growing(self, run):
        """`run()` until stage 1's capture buffer suffices, doubling it
        after each saturated attempt."""
        for _ in range(CAPTURE_ATTEMPTS):
            out = run()
            if out is not None:
                return out
            self._kcap_grow *= 2
        raise PropagationError(
            f"scan-filter nominal capture saturated ({self._last_k_cap} nodes) after "
            f"{CAPTURE_ATTEMPTS} attempts")

    def _process_arc_ekf(self, y0, p0, rows, t_np, epoch0: Epoch, thresh, gate, sc_params,
                         walls):
        """Segmented reference-update filtering (the reference's
        _process_arc_ekf, scan_filter.py:1644-1733): the rows are cut into
        `_segments`, each runs the four stages with its times measured from
        the previous segment's last row (its epoch, its own dynamics
        context), and the estimate and covariance of a segment's last row
        become the next segment's y0 and p0, on the device. Deviations then
        stay within one segment's drift, which keeps the linearization, and
        the gate, honest on day-long arcs from a dispersed start. A
        saturated capture buffer in any segment doubles it and reruns the
        whole arc. Returns the device outputs of every row."""
        segments = self._segments(t_np)
        walls["segments"] = len(segments)

        def run_arc():
            k_cap = self._k_cap(max(seg[3] for seg in segments))
            y, p, outs = y0, p0, []
            for b0, b1, t_prev, span in segments:
                seg_rows = (rows[0][b0:b1] - t_prev,) + tuple(x[b0:b1] for x in rows[1:])
                res = self._run(y, p, seg_rows, epoch0 + t_prev, float(t_np[b0] - t_prev), span,
                                k_cap, thresh, gate, sc_params, walls)
                if res is None:
                    return None
                out, _ = res
                outs.append(out)
                y, p = out[0][-1], out[1][-1]
            return [torch.cat([o[i] for o in outs]) for i in range(6)]

        return self._run_growing(run_arc)

    def _gn_dev0(self, aux, p0):
        """Gauss-Newton initial-state correction from one filter pass (the
        reference's _gn_dev0, scan_filter.py:1837-1884, host-side 9x9
        numpy): every row's partials mapped back to the epoch through the
        forward STM chain (H~_k = H_k Phi(t0 -> t_k)), and the
        prior-regularized normal equations solved at t0. Information
        accumulates forward, so nothing is amplified through an inverse
        STM; zero-prior-variance lanes are held fixed."""
        d = STATE_DIM
        phi = _host(aux["phi"])
        h = _host(aux["h_all"])[:, :, :d]
        z = _host(aux["z_all"])
        r = _host(aux["r_all"])
        avail = _host(aux["avail"])
        a_mat = np.zeros((d, d))
        b_vec = np.zeros(d)
        phi0k = np.eye(d)
        for k in range(phi.shape[0]):
            phi0k = phi[k] @ phi0k
            if not avail[k].any():
                continue
            hk = h[k] @ phi0k  # [T, d]
            w = np.where(avail[k], 1.0 / r[k], 0.0)
            hw = hk * w[:, None]
            a_mat += hw.T @ hk
            b_vec += hw.T @ z[k]
        p0h = _host(p0)[:d, :d]
        idx = np.where(np.diag(p0h) > 1e-30)[0]
        a_sub = a_mat[np.ix_(idx, idx)] + np.linalg.inv(p0h[np.ix_(idx, idx)])
        dx = np.zeros(d)
        dx[idx] = np.linalg.solve(a_sub, b_vec[idx])
        return dx

    def predict_for(self, initial_estimate, duration, step=60.0) -> ScanODResult:
        """Covariance mapping: time updates only, over a uniform `step`
        grid spanning `duration` (seconds or Durations), as an all-NaN arc
        through process_arc (the reference's predict_for,
        scan_filter.py:1886-1913)."""
        dur_s = duration.to_seconds() if isinstance(duration, Duration) else float(duration)
        step_s = step.to_seconds() if isinstance(step, Duration) else float(step)
        m = max(1, int(round(dur_s / step_s)))
        epoch0 = initial_estimate.epoch
        t_grid = np.arange(1, m + 1) * step_s
        arc = TrackingDataArc(
            trackers=(self.devices[0].name,),
            types=self.types,
            epochs_tai_s=epoch0.to_tai_seconds() + t_grid,
            tracker_idx=np.zeros(m, dtype=np.int64),
            values=np.full((m, len(self.types)), np.nan),
        )
        return self.process_arc(initial_estimate, arc)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
