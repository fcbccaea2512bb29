"""Batched orbit determination: the staged filters of nyx_tpu/od/scan_filter.py.

Torch port of `ScanKalmanOD`, over ground stations (optionally tracking a
spacecraft about another body through their centre-offset tables,
`GroundStation.with_target_frame`) or interlink transmitters
(`InterlinkTxSpacecraft`), one family a filter. A classical Kalman filter
linearizes about a nominal trajectory that does not depend on the
measurements, so with `prop_mode="batch"` the reference
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
- s4: the filter over the rows: the sequential Joseph update with
  Cholesky whitening and the sigma gate, 9x9 algebra row by row, at
  float64, or at float32 after scaling each state lane by 1/sqrt(P0_ii),
  in square-root form (`filter_scan`, `filter_scan_f32`); or, with
  `filter_mode="parallel"`, the associative scan of Saerkkae and
  Garcia-Fernandez, one flat prefix scan of log2 M levels over all rows
  with an iterated gate (`filter_parallel`). With `estimate_biases`, the
  state gains a Gauss-Markov lane per biased (device, type).

`variant="ckf"` runs the four stages once over the whole arc, or, with
`iterations` > 1, relinearizes between passes by a Gauss-Newton
correction of the initial state (`_gn_dev0`). `variant="ekf"` is the
segmented reference-update filter (`_process_arc_ekf`): the arc is cut
into `segment_rows`-row segments, each runs the four stages, and the
estimate and covariance of a segment's last row start the next segment's
nominal. `predict_for` maps a covariance over a uniform grid through the
same stages. `process_arc_batch` runs an ensemble of CKFs on one arc, the
estimates a leading axis through every stage, on one device or sharded
over a mesh of them (a copy of the filter a shard, `on_device`, in a host
thread of its own). `prop_mode` "fixed" and
"adaptive" instead propagate the nominal and its STM row by row
(`_run_rows`), the EKF relinearizing every row.

The reference's `lax.scan` over rows becomes a host loop that queues the
rows' small tensor operations without a host round trip: factorizations
report failure through `cholesky_ex`, checked once after the loop. Each
stage ends with one synchronization so its wall can be read
(`stage_walls_s`); stage 1's also tells whether its capture buffer
saturated, in which case the buffer doubles and the pass (for the EKF,
the whole arc) reruns.

TPU tooling with no counterpart: the reference's ahead-of-time compile
cache (`aot_dir`) and compiler options, the EKF's padding of every segment
to one row count (which only lets the segments share one compiled shape; a
padded row is a masked update over a zero gap), the fixed mode's padding of
its one lane to eight, and the parallel filter's blocking of rows by 128.
"""

from __future__ import annotations

import copy
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
from ..parallel.mesh import ensemble_sharding, run_on_shards
from ..propagators import integrator
from ..time import Duration, Epoch
from ..xmath import FORWARD_AD
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
    # estimate_biases=True: each row's Gauss-Markov bias estimates and
    # their variances, a column per lane (device name, type)
    bias_est: Optional[np.ndarray] = None  # [M, nb]
    bias_var: Optional[np.ndarray] = None  # [M, nb]
    bias_lanes: Tuple[Tuple[str, str], ...] = ()

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


def interp_quintic(ts_n, ys_n, acc_n, n_valid, tq):
    """Quintic Hermite (position, velocity and acceleration at both ends
    of the interval) at query times tq [B, M] from each filter's nodes:
    ts_n [B, K], ys_n [B, K, 9], acc_n [B, K, 3], of which the first
    n_valid [B] are real (a filter with fewer repeats its last node);
    linear in columns 6 and up. Returns [B, M, 9]."""
    i = torch.searchsorted(ts_n, tq.contiguous(), right=True) - 1
    i = torch.minimum(torch.clamp(i, min=0), (n_valid - 2)[:, None])

    def at(x, j):
        return torch.gather(x, 1, j[..., None].expand(-1, -1, x.shape[-1]))

    t0 = torch.gather(ts_n, 1, i)
    h = torch.clamp(torch.gather(ts_n, 1, i + 1) - t0, min=1e-30)
    s = torch.clamp((tq - t0) / h, 0.0, 1.0)[..., None]
    y0, y1 = at(ys_n, i), at(ys_n, i + 1)
    a0, a1 = at(acc_n, i), at(acc_n, i + 1)
    r0, v0, r1, v1 = y0[..., 0:3], y0[..., 3:6], y1[..., 0:3], y1[..., 3:6]
    hh = h[..., None]
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
    rest0, rest1 = y0[..., 6:], y1[..., 6:]
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
    with FORWARD_AD:
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


def _with_filter_axis(fn, phi, q_all, h_all, z_all, r_all, avail, p0, *args):
    """Run the filter algebra `fn`, which works on a leading filter axis
    (phi [B, M, d, d], q [B, M, d, d], h [B, M, T, d], z [B, M, T], r and
    avail [B, M, T], p0 [B, d, d]), on inputs with that axis (r and avail
    may be shared [M, T]) or without it (one filter: the axis is added and
    taken off again)."""
    if p0.dim() == 3:
        shape = z_all.shape
        return fn(phi, q_all, h_all, z_all, r_all.expand(shape), avail.expand(shape), p0, *args)
    out = fn(phi[None], q_all[None], h_all[None], z_all[None], r_all[None], avail[None], p0[None],
             *args)
    return tuple(x[0] for x in out)


def _joseph_row(dev, p, ph, q, h, z, r, av, n_avail, thresh, gate: bool):
    """One row of the sequential Joseph CKF for every filter: time update
    of (dev [B, d], P [B, d, d]) through Phi [B, d, d] and Q, prefit
    against z [B, T] and H [B, T, d], Cholesky whitening of the innovation
    covariance (R [B, T] on its diagonal), the sigma gate (ratio > thresh
    rejects, when `gate`), the gain K^T = S^-1 H P_bar^T by two triangular
    solves, and the Joseph update, symmetrized. Returns (dev, P, prefit,
    postfit, ratio [B], rejected [B], cholesky info [B])."""
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    r_diag = torch.diag_embed(r)
    p_bar = ph @ p @ ph.mT + q
    dev_bar = (ph @ dev[..., None])[..., 0]
    prefit = torch.where(av, z - (h @ dev_bar[..., None])[..., 0], zero)
    l_chol, info = torch.linalg.cholesky_ex(h @ p_bar @ h.mT + r_diag)
    white = torch.linalg.solve_triangular(l_chol, prefit[..., None], upper=False)[..., 0]
    ratio = torch.linalg.vector_norm(white, dim=-1) / n_avail
    rejected = ratio > thresh if gate else torch.zeros_like(ratio, dtype=torch.bool)
    k_t = torch.linalg.solve_triangular(
        l_chol.mT, torch.linalg.solve_triangular(l_chol, h @ p_bar.mT, upper=False), upper=True)
    k_gain = torch.where(rejected[:, None, None], zero, k_t.mT)
    dev = dev_bar + (k_gain @ prefit[..., None])[..., 0]
    postfit = torch.where(av, z - (h @ dev[..., None])[..., 0], zero)
    ikh = torch.eye(p.shape[-1], dtype=p.dtype, device=p.device) - k_gain @ h
    p = ikh @ p_bar @ ikh.mT + k_gain @ r_diag @ k_gain.mT
    return dev, 0.5 * (p + p.mT), prefit, postfit, ratio, rejected, info


def _raise_if_not_pd(info):
    """Raise if any row's Cholesky failed for any filter (info [B, M])."""
    bad = torch.nonzero((info != 0).any(dim=0)).flatten().cpu()
    if len(bad):
        raise PropagationError(
            f"innovation covariance not positive definite at {len(bad)} rows, first row {int(bad[0])}")


def filter_scan(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh: float, gate: bool):
    """The sequential Joseph CKF over precomputed rows, at p0's dtype
    (the reference's `filter_scan`, scan_filter.py:799-845), for one
    filter or, with a leading filter axis, an ensemble (see
    `_with_filter_axis`). Returns (deviations [M, d], covariances
    [M, d, d], prefit [M, T], postfit [M, T], ratios [M], rejected [M]),
    each behind the filter axis when given one. Raises if any innovation
    covariance is not positive definite. When no row holds a measurement
    (covariance mapping, `predict_for`), the rows are time updates alone
    (`_time_updates`): the masked measurement update's gain is ~1e-30 of
    P H^T and changes nothing that float64 keeps."""
    return _with_filter_axis(_filter_scan, phi, q_all, h_all, z_all, r_all, avail, p0,
                             rej_thresh, gate)


def _filter_scan(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh, gate):
    if not bool(avail.any()):
        return _time_updates(phi, q_all, p0, z_all.shape[-1])
    dt, dev_ = p0.dtype, p0.device
    thresh = torch.tensor(rej_thresh, dtype=dt, device=dev_)
    n_avail = torch.clamp(avail.sum(dim=-1), min=1).to(dt).sqrt()
    dev = torch.zeros(p0.shape[:-1], dtype=dt, device=dev_)
    p = p0
    out = [[] for _ in range(7)]
    for i in range(phi.shape[1]):
        row = _joseph_row(dev, p, phi[:, i], q_all[:, i], h_all[:, i], z_all[:, i], r_all[:, i],
                          avail[:, i], n_avail[:, i], thresh, gate)
        dev, p = row[0], row[1]
        for lst, x in zip(out, row):
            lst.append(x)
    dev_all, p_all, prefit, postfit, ratio, rejected, info = (torch.stack(x, dim=1) for x in out)
    _raise_if_not_pd(info)
    return dev_all, p_all, prefit, postfit, ratio, rejected


def _time_updates(phi, q_all, p0, n_types: int):
    """`filter_scan`'s outputs over rows without measurements: P = Phi P
    Phi^T + Q, symmetrized, row by row (three small operations a row
    instead of the update's ~25); zero deviations and residuals, ratio 0,
    nothing rejected."""
    nb, m_rows, d = phi.shape[0], phi.shape[1], p0.shape[-1]
    p, p_all = p0, []
    for i in range(m_rows):
        p = phi[:, i] @ p @ phi[:, i].mT + q_all[:, i]
        p = 0.5 * (p + p.mT)
        p_all.append(p)
    zeros = dict(dtype=p0.dtype, device=p0.device)
    resid = torch.zeros(nb, m_rows, n_types, **zeros)
    return (torch.zeros(nb, m_rows, d, **zeros), torch.stack(p_all, dim=1), resid, resid.clone(),
            torch.zeros(nb, m_rows, **zeros),
            torch.zeros(nb, m_rows, dtype=torch.bool, device=p0.device))


# Matrices per batched eigendecomposition: cuSOLVER's batched solver
# refuses an ensemble's every row at once (64 filters x 1,157 rows failed
# with CUSOLVER_STATUS_INVALID_VALUE on an H100).
EIGH_CHUNK = 4096


def _psd_factor(m):
    """F with F F^T = m for symmetric positive semidefinite m [..., d, d],
    from the eigendecomposition (Cholesky refuses the singular ones), in
    chunks of EIGH_CHUNK matrices."""
    flat = m.reshape(-1, *m.shape[-2:])
    parts = []
    for chunk in torch.split(flat, EIGH_CHUNK):
        lam, v = torch.linalg.eigh(chunk)
        parts.append(v * torch.sqrt(torch.clamp(lam, min=0.0))[..., None, :])
    return torch.cat(parts).reshape(m.shape)


def filter_scan_f32(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh: float, gate: bool):
    """The CKF of `filter_scan` at float32, in square-root form, for one
    filter or an ensemble (a leading filter axis, as `filter_scan`).

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
    return _with_filter_axis(_filter_scan_f32, phi, q_all, h_all, z_all, r_all, avail, p0,
                             rej_thresh, gate)


def _filter_scan_f32(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh, gate):
    if phi.shape[0] == 1 and phi.is_cuda:
        # one filter runs as two copies: torch sends a batch of one QR to
        # cuSOLVER and a larger one to cuBLAS's batched QR, which round
        # otherwise at float32 (2.8e-5 km apart on the OD leg's day); with
        # a batch of two a filter's outputs equal its outputs in any
        # ensemble, to the bit (H100)
        out = _filter_scan_f32(*(torch.cat([x, x]) for x in (phi, q_all, h_all, z_all, r_all,
                                                              avail, p0)), rej_thresh, gate)
        return tuple(x[:1] for x in out)
    f32, f64 = torch.float32, torch.float64
    pd = torch.diagonal(p0, dim1=-2, dim2=-1)  # [B, d]
    sc = torch.where(pd > 1e-20, 1.0 / torch.sqrt(torch.clamp(pd, min=1e-20)), torch.ones_like(pd))
    inv = 1.0 / sc
    phi_s = (phi * sc[:, None, :, None] * inv[:, None, None, :]).to(f32)
    q_half = _psd_factor(q_all * sc[:, None, :, None] * sc[:, None, None, :]).to(f32)
    h_s = (h_all * inv[:, None, None, :]).to(f32)
    z_s = z_all.to(f32)
    r_half = torch.sqrt(torch.clamp(r_all, max=MASKED_R_F32)).to(f32)
    s = _psd_factor(p0 * sc[:, :, None] * sc[:, None, :]).to(f32)

    dev_ = p0.device
    nb, m_rows, d = phi.shape[0], phi.shape[1], p0.shape[-1]
    n_types = z_all.shape[-1]
    zero = torch.zeros((), dtype=f32, device=dev_)
    thresh = torch.tensor(rej_thresh, dtype=f32, device=dev_)
    n_avail = torch.clamp(avail.sum(dim=-1), min=1).to(f32).sqrt()
    dev = torch.zeros(nb, d, dtype=f32, device=dev_)
    zero_block = torch.zeros(nb, d, n_types, dtype=f32, device=dev_)
    out = [[] for _ in range(6)]
    for i in range(m_rows):
        ph, h, av = phi_s[:, i], h_s[:, i], avail[:, i]
        # time update: S_bar S_bar^T = Phi S S^T Phi^T + Q
        s_bar = torch.linalg.qr(torch.cat([ph @ s, q_half[:, i]], dim=-1).mT, mode="r")[1].mT
        dev_bar = (ph @ dev[..., None])[..., 0]
        prefit = torch.where(av, z_s[:, i] - (h @ dev_bar[..., None])[..., 0], zero)
        # measurement update: one QR of the pre-array gives W, K W and S+
        pre = torch.cat([torch.cat([torch.diag_embed(r_half[:, i]), h @ s_bar], dim=-1),
                         torch.cat([zero_block, s_bar], dim=-1)], dim=-2)
        post = torch.linalg.qr(pre.mT, mode="r")[1].mT
        w, kw = post[:, :n_types, :n_types], post[:, n_types:, :n_types]
        s_new = post[:, n_types:, n_types:]
        white = torch.linalg.solve_triangular(w, prefit[..., None], upper=False)[..., 0]
        ratio = torch.linalg.vector_norm(white, dim=-1) / n_avail[:, i]
        rejected = ratio > thresh if gate else torch.zeros_like(ratio, dtype=torch.bool)
        k_gain = torch.linalg.solve_triangular(w.mT, kw.mT, upper=True).mT
        k_gain = torch.where(rejected[:, None, None], zero, k_gain)
        dev = dev_bar + (k_gain @ prefit[..., None])[..., 0]
        s = torch.where(rejected[:, None, None], s_bar, s_new)
        postfit = torch.where(av, z_s[:, i] - (h @ dev[..., None])[..., 0], zero)
        for lst, x in zip(out, (dev, s @ s.mT, prefit, postfit, ratio, rejected)):
            lst.append(x)
    dev_all, p_all, prefit, postfit, ratio, rejected = (torch.stack(x, dim=1) for x in out)
    return (dev_all.to(f64) * inv[:, None, :],
            p_all.to(f64) * inv[:, None, :, None] * inv[:, None, None, :],
            prefit.to(f64), postfit.to(f64), ratio.to(f64), rejected)


def _parallel_elements(phi, q, h, z, r):
    """Each row's element (A, b, C, eta, J) of the associative filter
    (Saerkkae and Garcia-Fernandez 2021, eqs. 10-12; the reference's
    `make_element`, scan_filter.py:867-879), for rows [..., M] at once,
    and the Cholesky infos of their S = H Q H^T + R."""
    eye = torch.eye(phi.shape[-1], dtype=phi.dtype, device=phi.device)
    l_chol, info = torch.linalg.cholesky_ex(h @ q @ h.mT + torch.diag_embed(r))
    k = torch.cholesky_solve(h @ q.mT, l_chol).mT
    ikh = eye - k @ h
    a = ikh @ phi
    b = (k @ z[..., None])[..., 0]
    c = ikh @ q
    hs = torch.cholesky_solve(h @ phi, l_chol)
    eta = (hs.mT @ z[..., None])[..., 0]
    j = hs.mT @ (h @ phi)
    return (a, b, 0.5 * (c + c.mT), eta, 0.5 * (j + j.mT)), info


def _compose(left, right):
    """The associative operator on elements (A, b, C, eta, J) (the
    reference's `compose`, scan_filter.py:885-915): both solves share the
    matrix I + J2 C1 (the transpose of I + C1 J2 for symmetric C1, J2), so
    one LU serves them. Returns the composed element and the solve's
    infos."""
    a1, b1, c1, e1, j1 = left
    a2, b2, c2, e2, j2 = right
    d = a1.shape[-1]
    eye = torch.eye(d, dtype=a1.dtype, device=a1.device)
    rhs = torch.cat([a2.mT, e2[..., None] - j2 @ b1[..., None], j2 @ a1], dim=-1)
    sol, info = torch.linalg.solve_ex(eye + j2 @ c1, rhs)
    t_mat = sol[..., :d].mT
    ue, uja = sol[..., d], sol[..., d + 1:]
    a = t_mat @ a1
    b = (t_mat @ (b1[..., None] + c1 @ e2[..., None]))[..., 0] + b2
    c = t_mat @ c1 @ a2.mT + c2
    e = (a1.mT @ ue[..., None])[..., 0] + e1
    j = a1.mT @ uja + j1
    return (a, b, 0.5 * (c + c.mT), e, 0.5 * (j + j.mT)), info


def _prefix_scan(elems):
    """Inclusive prefix of the elements along the row axis (dim 1) by
    Hillis-Steele: ceil(log2 M) levels, level k composing every row with
    the row 2^k before it, each level one batched `_compose` over the
    rows, with no host loop over rows. Returns the prefix and whether any
    level's solve was singular (a device flag)."""
    m_rows = elems[0].shape[1]
    bad = torch.zeros((), dtype=torch.bool, device=elems[0].device)
    k = 1
    while k < m_rows:
        new, info = _compose(tuple(e[:, :m_rows - k] for e in elems), tuple(e[:, k:] for e in elems))
        elems = tuple(torch.cat([e[:, :k], n], dim=1) for e, n in zip(elems, new))
        bad = bad | (info != 0).any()
        k *= 2
    return elems, bad


def filter_parallel(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh: float, gate: bool):
    """The associative-scan CKF (the reference's `filter_parallel`,
    scan_filter.py:847-1008) for one filter or an ensemble (a leading
    filter axis, as `filter_scan`), at float64, with `filter_scan`'s
    outputs.

    Each row becomes an element (A, b, C, eta, J) (`_parallel_elements`);
    their composition is associative, so one flat prefix scan over all M
    rows (`_prefix_scan`, log2 M levels) gives every row's cumulative
    element, and composing the prior element (A = 0, b = 0, C = P0) on the
    left of each gives the filtered deviation and covariance there. The
    reference blocks the rows by 128 inside an outer sequential scan, only
    because its compiler could not take a flat one; the two differ in
    rounding alone. Residuals and ratios are rated afterwards against the
    original R (`rate`). The sigma gate is iterated: rows whose ratio
    exceeds the threshold get R = 1e30 and the whole filter reruns, three
    times, each pass re-rating every row against the filtered past; the
    last pass's ratios decide. A clear outlier converges to the sequential
    scan's rejections; a row right at the threshold may not (the
    sequential filter rates it against a past with the rejections applied
    strictly in order)."""
    return _with_filter_axis(_filter_parallel, phi, q_all, h_all, z_all, r_all, avail, p0,
                             rej_thresh, gate)


def _filter_parallel(phi, q_all, h_all, z_all, r_all, avail, p0, rej_thresh, gate):
    nb, m_rows, d = phi.shape[0], phi.shape[1], p0.shape[-1]
    f64 = dict(dtype=p0.dtype, device=p0.device)
    zero = torch.zeros((), **f64)
    prior = (torch.zeros(nb, m_rows, d, d, **f64), torch.zeros(nb, m_rows, d, **f64),
             p0[:, None].expand(nb, m_rows, d, d), torch.zeros(nb, m_rows, d, **f64),
             torch.zeros(nb, m_rows, d, d, **f64))
    bad = torch.zeros((), dtype=torch.bool, device=p0.device)

    def one_pass(r_elem):
        nonlocal bad
        elems, info = _parallel_elements(phi, q_all, h_all, z_all, r_elem)
        cum, bad_scan = _prefix_scan(elems)
        out, info_prior = _compose(prior, cum)
        bad = bad | (info != 0).any() | bad_scan | (info_prior != 0).any()
        return out[1], out[2]

    def rate(dev_all, p_all):
        dev_prev = torch.cat([torch.zeros(nb, 1, d, **f64), dev_all[:, :-1]], dim=1)
        p_prev = torch.cat([p0[:, None], p_all[:, :-1]], dim=1)
        dev_bar = (phi @ dev_prev[..., None])[..., 0]
        prefit = torch.where(avail, z_all - (h_all @ dev_bar[..., None])[..., 0], zero)
        postfit = torch.where(avail, z_all - (h_all @ dev_all[..., None])[..., 0], zero)
        p_bar = phi @ p_prev @ phi.mT + q_all
        s_all = h_all @ p_bar @ h_all.mT + torch.diag_embed(r_all)
        white = torch.linalg.solve_ex(s_all, prefit[..., None])[0][..., 0]
        m_eff = torch.clamp(avail.sum(dim=-1), min=1).to(p0.dtype)
        ratio = torch.sqrt(torch.clamp((prefit * white).sum(dim=-1), min=0.0) / m_eff)
        return prefit, postfit, ratio

    dev_all, p_all = one_pass(r_all)
    prefit, postfit, ratio = rate(dev_all, p_all)
    thresh = torch.tensor(rej_thresh, **f64)
    # at an infinite threshold (relinearization passes) the gated passes
    # would rerun the same filter
    if gate and rej_thresh != math.inf:
        for _ in range(3):
            r_gated = torch.where((ratio > thresh)[..., None], torch.full_like(r_all, MASKED_R),
                                  r_all)
            dev_all, p_all = one_pass(r_gated)
            prefit, postfit, ratio = rate(dev_all, p_all)
        rejected = ratio > thresh
    else:
        rejected = torch.zeros_like(ratio, dtype=torch.bool)
    if bool(bad):
        raise PropagationError("the associative-scan filter met a singular innovation covariance "
                               "or composition")
    return dev_all, p_all, prefit, postfit, ratio, rejected


class ScanKalmanOD:
    """The batched filters over a fixed device set and type tuple, on
    `device` (the card unless the caller asks for the CPU).

    `variant`: "ckf" (one linearization, or `iterations` Gauss-Newton
    passes) or "ekf" (with `prop_mode="batch"`, the segmented
    reference-update filter, a fold every `segment_rows` rows; otherwise a
    fold every row). `prop_mode`: "batch" (the four stages), "fixed"
    (each row's gap in `substeps` fixed RK steps of the state and its STM,
    fillers at most `max_gap_s * substeps` apart) or "adaptive" (each gap
    by the adaptive integrator, no fillers); the last two are ground
    stations' one-way tracking only. `filter_mode` (batch only): "scan"
    (the sequential row loop; "auto" is "scan") or "parallel" (the
    associative scan, `filter_parallel`). `estimate_biases` (batch only):
    one Gauss-Markov state lane per (device, type) whose noise has a bias,
    R then from the white noise alone. `stm_jvp_degree`: stage 2
    differentiates gravity fields through their first `stm_jvp_degree`
    degrees (values keep the whole field). Rows are at most `max_gap_s`
    apart (fillers are added) and so are the nominal's nodes: by default
    the initial orbit's period / 24, within [60 s, max_step].
    `filter_algebra`: "f64" (Joseph) or "f32" (preconditioned square-root
    form, see filter_scan_f32; the parallel filter and the per-row modes
    run at f64, as the reference's do).
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
        prop_mode: str = "batch",
        substeps: int = 1,
        max_gap_s: Optional[float] = None,
        filter_mode: str = "auto",
        estimate_biases: bool = False,
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
        if prop_mode not in ("batch", "fixed", "adaptive"):
            raise ConfigError(f"prop_mode must be 'batch', 'fixed' or 'adaptive', got {prop_mode!r}")
        if filter_mode not in ("auto", "scan", "parallel"):
            raise ConfigError(f"filter_mode must be 'auto', 'scan' or 'parallel', got {filter_mode!r}")
        if not devices:
            raise ConfigError("the scan filter needs at least one device")
        batch = prop_mode == "batch"
        # device family: ground stations or interlink transmitters
        is_link = [is_interlink(d) for d in devices]
        self._interlink = all(is_link)
        if any(is_link) and not self._interlink:
            raise ConfigError(
                "scan filter devices must be all ground stations or all interlink transmitters")
        if self._interlink and not batch:
            raise ConfigError("interlink devices need the batched pipeline (prop_mode='batch')")
        if not self._interlink and len({d.frame for d in devices}) != 1:
            raise ConfigError("all scan-filter stations must share a frame")
        offs = [getattr(d, "target_center_offset", None) for d in devices]
        if any(o is not None for o in offs):
            if not all(o is not None for o in offs):
                raise ConfigError("scan-filter stations must all have a target frame offset, or none")
            if not batch:
                raise ConfigError(
                    "cross-body station offsets need the batched pipeline (prop_mode='batch')")
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
        self.prop_mode = prop_mode
        self.substeps = int(substeps)
        self.filter_mode = filter_mode
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
        if self._any_two_way and not batch:
            raise ConfigError(
                "two-way devices need the batched pipeline (prop_mode='batch', CKF): the t - T_int "
                "state comes from the nominal's interpolant")
        rvar = np.full((len(devices), len(self.types)), MASKED_R)
        for i, d in enumerate(devices):
            for j, t in enumerate(self.types):
                n = d.stochastic_noises.get(t)
                if n is not None and t in d.measurement_types:
                    rvar[i, j] = max(n.covariance(), 1e-32)
        # estimated measurement biases: one Gauss-Markov lane per (device,
        # type) whose noise carries a bias (the reference, which simulates
        # such biases but never estimates them, adds the lanes in its scan
        # filter, scan_filter.py:418-454): phi = exp(-dt/tau), q =
        # sigma^2 (1 - phi^2), H 1 on its device's rows of its type, and R
        # from the white part alone
        self.estimate_biases = bool(estimate_biases)
        lanes = []
        if self.estimate_biases:
            if not batch:
                raise ConfigError("estimate_biases needs the batched pipeline (prop_mode='batch')")
            for i, d in enumerate(devices):
                for j, t in enumerate(self.types):
                    n = d.stochastic_noises.get(t)
                    if n is not None and n.bias is not None and t in d.measurement_types:
                        lanes.append((i, j, float(n.bias.tau_s), float(n.bias.covariance())))
                        white = n.white_noise.covariance() if n.white_noise is not None else 0.0
                        rvar[i, j] = max(white, 1e-32)
        self.n_bias = len(lanes)
        # the lanes' (device, type) indices, time constants and steady-state
        # variances, on the device
        self._lanes = [(i, j) for i, j, _, _ in lanes]
        cols = list(zip(*lanes)) if lanes else [(), (), (), ()]
        self._lane_dev = torch.tensor(cols[0], dtype=torch.int64, device=self.device)
        self._lane_type = torch.tensor(cols[1], dtype=torch.int64, device=self.device)
        self._lane_tau = torch.tensor(cols[2], **f64)
        self._lane_sig2 = torch.tensor(cols[3], **f64)
        self._rvar = torch.tensor(rvar, **f64)
        self._snc_tabs = self._snc_tables() if self.process_noise else None
        self._kcap_grow = 1
        self._last_k_cap = 0
        # wall seconds of each stage of the last process_arc (summed over
        # its passes and segments; the per-row modes' loop under "rows"),
        # its segment count and its stage-1 integrator iterations
        self.stage_walls_s = {}

    def _stm_dynamics(self, dyn):
        """The dynamics of stage 2: Harmonics models get
        jvp_degree=stm_jvp_degree (unless already cut lower); the guidance
        law, mass decrement and perturbation precision are kept."""
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
        return SpacecraftDynamics(OrbitalDynamics(models, dyn.orbital_dyn.frame), dyn.force_models,
                                  dyn.guidance, dyn.decrement_mass, dyn.pert_precision)

    def _snc_tables(self):
        """The process noises' tables on the device, made once: diagonals,
        disable times, decay constants, start epochs, frame codes."""
        sncs = self.process_noise
        f64 = dict(dtype=torch.float64, device=self.device)
        return (
            torch.tensor(np.stack([s.q_diag_km2_s4 for s in sncs]), **f64),
            torch.tensor([s.disable_time_s for s in sncs], **f64),
            torch.tensor(np.stack([
                np.asarray(s.decay_tau_s, dtype=np.float64) if s.decay_tau_s is not None
                else np.full(3, np.inf) for s in sncs]), **f64),
            torch.tensor([s.start_epoch_tai_s if s.start_epoch_tai_s is not None
                          else -np.inf for s in sncs], **f64),
            torch.tensor([0 if s.local_frame is None
                          else (1 if s.local_frame.lower() == "ric" else 2)
                          for s in sncs], device=self.device),
        )

    def _snc_q(self, dt_s, y_ref, t_tai, t0_tai: float):
        """Per-row 9x9 process noise [M, 9, 9]: the last ProcessNoise whose
        start epoch has passed is active, with its optional decay from its
        start (or the first row) and its optional RIC/VNC frame, gated off
        for gaps of 0 or longer than its disable time."""
        m_rows = dt_s.shape[0]
        f64 = dict(dtype=torch.float64, device=dt_s.device)
        q = torch.zeros(m_rows, STATE_DIM, STATE_DIM, **f64)
        if self._snc_tabs is None:
            return q
        qd_tab, dis_tab, tau_tab, start_tab, code_tab = self._snc_tabs
        started = start_tab[None, :] <= t_tai[:, None]  # [M, K]
        idx = torch.arange(len(self.process_noise), device=dt_s.device)
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
        (times `substeps` in fixed mode; none in adaptive mode), at prev +
        k * that stride with the remainder last, and the mask of the real
        rows."""
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
        if self.prop_mode == "adaptive":
            return t_rel, trk, obs, avail, np.ones(m, dtype=bool)
        gap_max = self.max_gap_s * max(1, self.substeps) if self.prop_mode == "fixed" \
            else self.max_gap_s
        rows_t, rows_trk, rows_obs, rows_avail, real = [], [], [], [], []
        prev = 0.0
        for i in range(m):
            gap = t_rel[i] - prev
            if gap > gap_max:
                for k in range(1, int(np.ceil(gap / gap_max))):
                    rows_t.append(prev + k * gap_max)
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
        # the calling thread's stream: a shard of a mesh waits for its own work
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _stage1(self, y0, arc_span, k_cap, ctx, sc_params):
        """The nominals of the filters y0 [B, 9], with dense capture:
        ((node times [B, K], states [B, K, 9], accelerations [B, K, 3],
        nodes per filter [B]), integrator iterations), or None when the
        capture buffer saturated. A filter with fewer nodes than the most
        repeats its last."""
        dyn = self.prop.dynamics
        eom9 = dyn.make_eom()
        opts = self.prop.opts
        ref_opts = replace(opts, max_step_s=min(opts.max_step_s, self.max_gap_s))
        res = integrator.propagate(
            eom9, y0, arc_span, ref_opts, self.prop.method,
            finally_fn=dyn.make_finally(), eom_args=(ctx, sc_params), n_capture=k_cap,
        )
        n_valid = res.traj_len.to(torch.int64) + 1  # the initial node + the captured steps
        n_max = int(n_valid.max())
        if n_max >= k_cap:
            return None
        if bool((res.status != integrator.DONE).any()):
            raise PropagationError(
                f"scan-filter nominal propagation ended with status {res.status.tolist()}")
        nb = y0.shape[0]
        ts_n = torch.cat([torch.zeros(nb, 1, dtype=torch.float64, device=y0.device),
                          res.traj_t[:, : n_max - 1]], dim=1)
        ys_n = torch.cat([y0[:, None], res.traj_y[:, : n_max - 1]], dim=1)
        if nb > 1:
            last = torch.minimum(torch.arange(n_max, device=y0.device)[None], (n_valid - 1)[:, None])
            ts_n = torch.gather(ts_n, 1, last)
            ys_n = torch.gather(ys_n, 1, last[..., None].expand(-1, -1, ys_n.shape[-1]))
        acc_n = eom9(ts_n.reshape(-1), ys_n.reshape(-1, STATE_DIM), ctx, sc_params)[:, 3:6]
        return (ts_n, ys_n, acc_n.reshape(nb, n_max, 3), n_valid), res.iterations

    def _stage2(self, t_rel, nodes, ctx, sc_params):
        """(nominals at the rows [B, M, 9], STMs over the gaps
        [B, M, 9, 9], gaps [M]): one fixed RK step of the [B M, 90] state
        and STM over every row's gap of every filter."""
        nb, m_rows = nodes[0].shape[0], t_rel.shape[0]
        t_prev = torch.cat([torch.zeros(1, dtype=torch.float64, device=t_rel.device), t_rel[:-1]])
        y_prev = interp_quintic(*nodes, t_prev.expand(nb, m_rows)).reshape(nb * m_rows, STATE_DIM)
        dt = t_rel - t_prev
        eye = torch.eye(STATE_DIM, dtype=torch.float64, device=t_rel.device).reshape(1, -1)
        y90 = torch.cat([y_prev, eye.expand(nb * m_rows, -1)], dim=1)
        eom90 = self._dyn_stm.make_eom(with_stm=True)
        method = self.prop.method
        t_b, dt_b = t_prev.repeat(nb), dt.repeat(nb)
        inc, _ = integrator._rk_stages(
            lambda t, y: eom90(t, y, ctx, sc_params), method.a_matrix, method.b, method.b_star,
            method.c, t_b, y90, dt_b)
        y90 = self._dyn_stm.make_finally()(t_b + dt_b, y90 + inc, ctx, sc_params)
        return (y90[:, :STATE_DIM].reshape(nb, m_rows, STATE_DIM),
                y90[:, STATE_DIM:].reshape(nb, m_rows, STATE_DIM, STATE_DIM), dt)

    def _observe(self, t_rel, trk, y_rows, y_tm, epoch0: Epoch):
        """Computed observations [N, T] and H [N, T, 9] of N rows (times
        t_rel [N] from epoch0, trackers trk [N], states y_rows [N, 9], and
        for two-way devices the states at t - T_int, y_tm [N, 6])."""
        t_tdb, tint = epoch0.to_tdb_seconds() + t_rel, self._tint[trk]
        if self._interlink:
            return interlink_rows(t_tdb, y_rows[:, :6], y_tm, trk, tint, *self._tx_tab, self.types)
        return observe_rows(
            t_tdb, y_rows[:, :6], y_tm, self._lat[trk], self._lon[trk], self._hgt[trk],
            None if self._lt is None else self._lt[trk], tint, self.station_frame, self.types,
            offset=None if self._off_tab is None else (trk,) + self._off_tab)

    def _stage3(self, t_rel, trk, obs, avail, y_bar, dt, nodes, epoch0: Epoch, t0_rel: float):
        """(H [B, M, T, 9], z [B, M, T], R [M, T], Q [B, M, 9, 9]); t0_rel
        is the first row's time, the anchor of decaying SNCs without a
        start. A two-way row's state at t - T_int comes from its filter's
        nominal, at the nominal's start if that is later."""
        nb, m_rows = y_bar.shape[:2]
        y_tm = None
        if self._any_two_way:
            t_back = torch.clamp(t_rel - self._tint[trk], min=0.0).expand(nb, m_rows)
            y_tm = interp_quintic(*nodes, t_back)[..., :6].reshape(nb * m_rows, 6)
        computed, h_all = self._observe(t_rel.repeat(nb), trk.repeat(nb),
                                        y_bar.reshape(nb * m_rows, STATE_DIM), y_tm, epoch0)
        computed = computed.reshape(nb, m_rows, -1)
        z_all = torch.where(avail, obs - computed, torch.zeros_like(computed))
        r_all = torch.where(avail, self._rvar[trk], torch.full_like(obs, MASKED_R))
        t_tai = epoch0.to_tai_seconds() + t_rel
        q_all = self._snc_q(dt.repeat(nb), y_bar.reshape(nb * m_rows, STATE_DIM), t_tai.repeat(nb),
                            epoch0.to_tai_seconds() + t0_rel)
        return (h_all.reshape(nb, m_rows, -1, STATE_DIM), z_all, r_all,
                q_all.reshape(nb, m_rows, STATE_DIM, STATE_DIM))

    def _algebra(self):
        """The s4 filter: the associative scan, or the sequential scan at
        the filter algebra's dtype (the reference runs its parallel filter
        at float64 whatever the algebra, scan_filter.py:1012)."""
        if self.filter_mode == "parallel":
            return filter_parallel
        return filter_scan_f32 if self.filter_algebra == "f32" else filter_scan

    def _stage4(self, trk, avail, y_bar, phi, dt, h_all, z_all, r_all, q_all, p0, thresh, gate):
        """The filter over the rows of every filter; with bias lanes, the
        state is augmented first (the reference's stage4_fn,
        scan_filter.py:1208-1255): their transition exp(-dt/tau) and noise
        sigma^2 (1 - phi^2) on the diagonal, a 1 in H where the row's
        device and type own the lane and the type is observed, and the
        steady-state variance in P0. Returns (estimates [B, M, 9 + nb],
        covariances, prefit, postfit, ratios, rejections): the state
        estimate is the nominal plus the deviation, a bias lane's the
        deviation alone."""
        nb = self.n_bias
        if nb:
            f64 = dict(dtype=torch.float64, device=phi.device)
            d_aug = STATE_DIM + nb
            sig2 = self._lane_sig2
            phi_b = torch.exp(-dt[:, None] / self._lane_tau[None, :])  # [M, nb]
            q_b = sig2[None, :] * (1.0 - phi_b**2)
            lane = torch.arange(STATE_DIM, d_aug, device=phi.device)

            def aug(m9, diag_b):
                out = torch.zeros(m9.shape[:-2] + (d_aug, d_aug), **f64)
                out[..., :STATE_DIM, :STATE_DIM] = m9
                out[..., lane, lane] = diag_b
                return out

            sel = ((self._lane_dev[None, None, :] == trk[:, None, None])
                   & (self._lane_type[None, None, :]
                      == torch.arange(len(self.types), device=phi.device)[None, :, None])
                   & avail[:, :, None])
            h_aug = torch.cat([h_all, sel.to(h_all.dtype).expand(phi.shape[0], -1, -1, -1)], dim=-1)
            dev_all, p_all, *rest = self._algebra()(
                aug(phi, phi_b), aug(q_all, q_b), h_aug, z_all, r_all, avail, aug(p0, sig2),
                thresh, gate)
            y_est = torch.cat([y_bar + dev_all[..., :STATE_DIM], dev_all[..., STATE_DIM:]], dim=-1)
            return (y_est, p_all, *rest)
        dev_all, p_all, *rest = self._algebra()(phi, q_all, h_all, z_all, r_all, avail, p0, thresh,
                                                gate)
        return (y_bar + dev_all, p_all, *rest)

    def _run(self, y0, p0, rows, epoch0: Epoch, t0_rel: float, span: float, k_cap: int,
             thresh: float, gate: bool, sc_params, walls):
        """The four stages over `rows` (device (t_rel, trk, obs, avail),
        times relative to `epoch0`, the start of y0 [B, 9] and p0
        [B, 9, 9]), their walls added to `walls`. Returns the device
        outputs (estimates, covariances, prefit, postfit, ratios,
        rejections, each [B, M, ...]) and the Gauss-Newton inputs, or None
        when stage 1's capture buffer saturated."""
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
        out = self._stage4(trk, avail, y_bar, phi, dt, h_all, z_all, r_all, q_all, p0, thresh,
                           gate)
        self._sync()
        walls["s4"] += time.perf_counter() - t0
        aux = dict(phi=phi, q_all=q_all, h_all=h_all, z_all=z_all, r_all=r_all, avail=avail)
        return out, aux

    def _run_rows(self, y0, p0, rows, t_np, trk_np, epoch0: Epoch, thresh: float, gate: bool,
                  sc_params, walls):
        """The per-row filter of prop_mode "fixed" and "adaptive" (the
        reference's `_build`, scan_filter.py:542-697) for the filters y0
        [B, 9], p0 [B, 9, 9]: a host loop over the rows carries (nominal,
        deviation, covariance) on the device; each row propagates the
        nominal and its STM over the gap (`substeps` fixed RK steps, or the
        adaptive integrator with the identity over a zero gap), then the
        SNC at the row's epoch, H by forward mode at the nominal, and
        `_joseph_row`; the EKF moves the nominal to the estimate every row.
        Only the adaptive integrator's RUNNING checks synchronize with the
        host. Returns the device outputs as `_run` does."""
        t_rel, trk, obs, avail = rows
        nb, m_rows = y0.shape[0], len(t_np)
        f64 = dict(dtype=torch.float64, device=self.device)
        span = float(t_np[-1])
        ctx = self.prop.dynamics.build_context(epoch0, span, self.almanac, device=self.device)
        dyn = self.prop.dynamics
        eom90, fin = dyn.make_eom(with_stm=True), dyn.make_finally()
        method, opts = self.prop.method, self.prop.opts
        substeps = max(1, self.substeps)
        eye81 = torch.eye(STATE_DIM, **f64).reshape(1, -1).expand(nb, -1)
        thresh_t = torch.tensor(thresh, **f64)
        n_avail = torch.clamp(avail.sum(dim=-1), min=1).to(torch.float64).sqrt()
        t0_tai = epoch0.to_tai_seconds() + float(t_np[0])
        y_ref, dev, p = y0, torch.zeros(nb, STATE_DIM, **f64), p0
        out = [[] for _ in range(7)]
        t_prev = 0.0
        t_start = time.perf_counter()
        for i in range(m_rows):
            dt = float(t_np[i]) - t_prev
            y90 = torch.cat([y_ref, eye81], dim=1)
            if self.prop_mode == "fixed":
                h = torch.full((nb,), dt / substeps, **f64)
                for k in range(substeps):
                    t = torch.full((nb,), t_prev + k * (dt / substeps), **f64)
                    inc, _ = integrator._rk_stages(
                        lambda tt, yy: eom90(tt, yy, ctx, sc_params), method.a_matrix, method.b,
                        method.b_star, method.c, t, y90, h)
                    y90 = fin(t + h, y90 + inc, ctx, sc_params)
            elif abs(dt) >= 1e-12:
                res = integrator.propagate(eom90, y90, dt, opts, method, finally_fn=fin,
                                           eom_args=(ctx, sc_params), t0=t_prev)
                if bool((res.status != integrator.DONE).any()):
                    raise PropagationError(
                        f"row {i}: propagation ended with status {res.status.tolist()}")
                y90 = res.y
            y_bar, phi = y90[:, :STATE_DIM], y90[:, STATE_DIM:].reshape(nb, STATE_DIM, STATE_DIM)
            q = self._snc_q(torch.full((nb,), dt, **f64), y_bar,
                            torch.full((nb,), epoch0.to_tai_seconds() + float(t_np[i]), **f64),
                            t0_tai)
            trk_i = trk[i:i + 1].expand(nb)
            computed, h_mat = self._observe(t_rel[i:i + 1].expand(nb), trk_i, y_bar, None, epoch0)
            av = avail[i].expand(nb, -1)
            z = torch.where(av, obs[i] - computed, torch.zeros_like(computed))
            r = torch.where(av, self._rvar[trk_i], torch.full_like(computed, MASKED_R))
            row = _joseph_row(dev, p, phi, q, h_mat, z, r, av, n_avail[i], thresh_t, gate)
            dev_new, p = row[0], row[1]
            if self.variant == "ekf":
                y_ref, dev = y_bar + dev_new, torch.zeros_like(dev_new)
            else:
                y_ref, dev = y_bar, dev_new
            for lst, x in zip(out, (y_bar + dev_new,) + row[1:]):
                lst.append(x)
            t_prev = float(t_np[i])
        y_est, p_all, prefit, postfit, ratio, rejected, info = (torch.stack(x, dim=1) for x in out)
        _raise_if_not_pd(info)
        self._sync()
        walls["rows"] = time.perf_counter() - t_start
        return (y_est, p_all, prefit, postfit, ratio, rejected), None

    def _inputs(self, estimates, arc: TrackingDataArc):
        """Common set-up of process_arc and process_arc_batch: the gate's
        threshold, the row layout (host and device), the spacecraft
        parameters of the first estimate, the stacked y0 [B, 9] and p0
        [B, 9, 9], and fresh stage walls."""
        first = estimates[0]
        require_same_center(self.devices, first.nominal.frame)
        gate = self.resid_rejection_sigmas is not None
        if arc.force_reject and not gate:
            raise ConfigError("resid-vs-ref arcs (force_reject) need a filter built "
                              "with resid_rejection_sigmas")
        # residual-versus-reference mode rejects every row: the solution is
        # the pure propagation
        thresh = -math.inf if arc.force_reject else (
            self.resid_rejection_sigmas if gate else math.inf)
        layout = self._layout(first, arc)
        t_np, trk_np, obs_np, avail_np, _ = layout
        f64 = dict(dtype=torch.float64, device=self.device)
        rows = (torch.tensor(t_np, **f64), torch.tensor(trk_np, device=self.device),
                torch.tensor(obs_np, **f64), torch.tensor(avail_np, device=self.device))
        nominal = first.nominal
        sc_params = dict(dry_mass_kg=nominal.dry_mass_kg, srp_area_m2=nominal.srp_area_m2,
                         drag_area_m2=nominal.drag_area_m2)
        y0 = torch.tensor(np.stack([e.nominal.to_vector() for e in estimates]), **f64)
        p0 = torch.tensor(np.stack([np.asarray(e.covar) for e in estimates]), **f64)
        walls = dict(s1=0.0, s2=0.0, s3=0.0, s4=0.0, segments=1, s1_iterations=0)
        return gate, thresh, layout, rows, sc_params, y0, p0, walls

    def process_arc(self, initial_estimate, arc: TrackingDataArc) -> ScanODResult:
        """Filter the arc from `initial_estimate` (a KfEstimate whose epoch
        precedes the first measurement).

        The batch CKF with `iterations` > 1 relinearizes between passes: the
        Gauss-Newton initial-state correction `_gn_dev0` moves the nominal's
        start and the stages rerun. Intermediate passes run with the gate
        off; only the last applies it. `variant="ekf"` in batch mode runs
        the segmented filter instead (`_process_arc_ekf`); the per-row
        modes run `_run_rows`."""
        if self.variant == "ekf" and self.n_bias:
            raise ConfigError("variant='ekf' does not support estimated bias lanes; use the CKF "
                              "with iterations instead")
        gate, thresh, layout, rows, sc_params, y0, p0, walls = self._inputs([initial_estimate], arc)
        t_np, trk_np, _, _, real = layout
        epoch0 = initial_estimate.epoch
        if self.prop_mode != "batch":
            out, _ = self._run_rows(y0, p0, rows, t_np, trk_np, epoch0, thresh, gate, sc_params,
                                    walls)
        elif self.variant == "ekf":
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
                    # the Gauss-Newton inputs of the one filter (its axis off)
                    aux = {k: v[0] if k in ("phi", "q_all", "h_all", "z_all") else v
                           for k, v in aux.items()}
                    y0 = y0 + torch.tensor(self._gn_dev0(aux, p0[0]), dtype=torch.float64,
                                           device=self.device)
        t0 = time.perf_counter()
        host = [x[0].cpu().numpy() for x in out]
        walls["s4"] += time.perf_counter() - t0
        self.stage_walls_s = walls
        return self._result(arc, real, *host)

    def process_arc_batch(self, initial_estimates, arc: TrackingDataArc, mesh=None):
        """Filter the same arc from every estimate at once, the estimates a
        leading batch axis through the stages (the reference's
        process_arc_batch, scan_filter.py:1965-2028): stage 1 propagates B
        nominals, stage 2 one [B M, 90] fixed step, stage 3 B M rows and
        stage 4 B filters in lock step; in the per-row modes the row loop
        carries the B filters. The layout, epoch and spacecraft parameters
        are the first estimate's. One pass, with the configured gate, as in
        the reference (no Gauss-Newton iterations). Returns a list of
        ScanODResult. The CKF alone, as in the reference: an EKF ensemble
        runs process_arc for each estimate.

        `mesh` (parallel/mesh.py) shards the filters: the estimates are
        padded with copies of the first to a multiple of its size, and each
        shard runs its slice of them on its device (the arc, the rows and
        the tracker tables copied there) in a host thread of its own. One
        ScanODResult a real estimate comes back, in order."""
        if self.variant == "ekf":
            raise ConfigError("process_arc_batch supports variant='ckf' only; for an EKF "
                              "ensemble run process_arc per estimate (or use the CKF with "
                              "iterations)")
        if mesh is not None:
            return self._batch_on_mesh(list(initial_estimates), arc, mesh)
        gate, thresh, layout, rows, sc_params, y0, p0, walls = self._inputs(
            list(initial_estimates), arc)
        t_np, trk_np, _, _, real = layout
        epoch0 = initial_estimates[0].epoch
        if self.prop_mode != "batch":
            out, _ = self._run_rows(y0, p0, rows, t_np, trk_np, epoch0, thresh, gate, sc_params,
                                    walls)
        else:
            span = float(t_np[-1])
            out, _ = self._run_growing(
                lambda: self._run(y0, p0, rows, epoch0, float(t_np[0]), span, self._k_cap(span),
                                  thresh, gate, sc_params, walls))
        t0 = time.perf_counter()
        host = [x.cpu().numpy() for x in out]
        walls["s4"] += time.perf_counter() - t0
        self.stage_walls_s = walls
        return [self._result(arc, real, *(x[k] for x in host)) for k in range(len(host[0]))]

    def _batch_on_mesh(self, estimates, arc: TrackingDataArc, mesh):
        """process_arc_batch over the shards of `mesh` (see there); the stage
        walls are each stage's longest over the shards."""
        n_real = len(estimates)
        padded = estimates + [estimates[0]] * ((-n_real) % mesh.size)
        slices = ensemble_sharding(mesh).slices(len(padded))
        shards = [self.on_device(dev) for dev in mesh.devices]

        def shard(k, _dev):
            return shards[k].process_arc_batch(padded[slices[k]], arc)

        parts = run_on_shards(mesh, shard, "filter shard")
        walls = [f.stage_walls_s for f in shards]
        self.stage_walls_s = {k: max(w[k] for w in walls) for k in walls[0]}
        return [r for part in parts for r in part][:n_real]

    def on_device(self, device) -> "ScanKalmanOD":
        """This filter with its tables on `device`: a shallow copy whose
        tensors (station coordinates, tracker tables, noise tables) are
        copied there, with a capture size and stage walls of its own, so
        copies can run at once from several threads."""
        twin = copy.copy(self)
        twin.device = torch.device(device)
        for k, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                setattr(twin, k, v.to(twin.device))
            elif isinstance(v, tuple) and v and all(isinstance(x, torch.Tensor) for x in v):
                setattr(twin, k, tuple(x.to(twin.device) for x in v))
        twin.stage_walls_s = {}
        return twin

    def _result(self, arc, real, y_est, covar, prefit, postfit, ratio, rejected) -> ScanODResult:
        """One filter's host outputs at the real rows, the bias lanes split
        off the state (the reference's _result, scan_filter.py:1915-1947)."""
        bias_est = bias_var = None
        lanes = ()
        if self.n_bias:
            idx = np.arange(STATE_DIM, STATE_DIM + self.n_bias)
            bias_est = y_est[real][:, STATE_DIM:]
            bias_var = covar[real][:, idx, idx]
            y_est, covar = y_est[:, :STATE_DIM], covar[:, :STATE_DIM, :STATE_DIM]
            lanes = tuple((self.devices[i].name, self.types[j]) for i, j in self._lanes)
        return ScanODResult(np.asarray(arc.epochs_tai_s), y_est[real], covar[real], prefit[real],
                            postfit[real], ratio[real], rejected[real], types=self.types,
                            bias_est=bias_est, bias_var=bias_var, bias_lanes=lanes)

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
                y, p = out[0][:, -1], out[1][:, -1]
            return [torch.cat([o[i] for o in outs], dim=1) for i in range(6)]

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
