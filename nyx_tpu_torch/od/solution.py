"""The OD host loop's solution: estimates, residuals, smoothing, statistics.

Port of nyx_tpu/od/solution.py:24-484 (the reference's
od/process/solution/): `ODSolution` with its record filters (`drop_time_updates`,
by type or tracker, `split`, `merge`, `at`), the RTS smoother (`smooth`,
with the filter-smoother consistency ratios and, given the devices, the
postfits recomputed at the smoothed states on a device), the residual
statistics (`residual_rms`, `postfit_rms`, `ratios`,
`percent_within_sigmas`, `ks_normality`, `nis`, `nis_test`,
`nis_consistency`, `nees`), `to_traj`, `to_ephemeris` (a BSP through
io/spk.py) and the parquet export and import. The records are host numpy,
as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..time import Epoch
from .estimate import KfEstimate, Residual

STATE_DIM = 9


@dataclass
class ODSolution:
    devices: Tuple[str, ...] = ()
    measurement_types: Tuple[str, ...] = ()
    estimates: List[KfEstimate] = field(default_factory=list)
    residuals: List[Optional[Residual]] = field(default_factory=list)
    accepted: int = 0
    rejected: int = 0
    #: per-step Kalman gain [9, m] (None on time updates/rejections, and
    #: scrubbed by the smoother — solution/mod.rs:82-83,125-137)
    gains: List[Optional[np.ndarray]] = field(default_factory=list)
    #: per-step filter-smoother consistency ratios [9] (smooth.rs:59-105);
    #: empty until smooth() runs
    filter_smoother_ratios: List[Optional[np.ndarray]] = field(
        default_factory=list
    )

    def append(
        self,
        est: KfEstimate,
        resid: Optional[Residual],
        gain: Optional[np.ndarray] = None,
    ):
        self.estimates.append(est)
        self.residuals.append(resid)
        self.gains.append(gain)

    def __len__(self):
        return len(self.estimates)

    @property
    def final_estimate(self) -> KfEstimate:
        return self.estimates[-1]

    # -------- record filtering (od/process/solution/filter_data.rs) ----
    def _aligned(self, lst: list) -> list:
        """`lst` padded with None to len(estimates) (direct-constructed
        solutions may not have per-step gains/ratios)."""
        return list(lst) + [None] * (len(self.estimates) - len(lst))

    def _subset(self, keep) -> "ODSolution":
        return ODSolution(
            self.devices,
            self.measurement_types,
            [e for e, k in zip(self.estimates, keep) if k],
            [r for r, k in zip(self.residuals, keep) if k],
            sum(
                1 for r, k in zip(self.residuals, keep)
                if k and r is not None and not r.rejected
            ),
            sum(
                1 for r, k in zip(self.residuals, keep)
                if k and r is not None and r.rejected
            ),
            [g for g, k in zip(self._aligned(self.gains), keep) if k],
            [
                f
                for f, k in zip(
                    self._aligned(self.filter_smoother_ratios), keep
                )
                if k
            ],
        )

    def drop_time_updates(self) -> "ODSolution":
        """Only records carrying a measurement update (filter_data.rs:88)."""
        return self._subset([r is not None for r in self.residuals])

    def filter_by_msr_type(self, msr_type: str) -> "ODSolution":
        return self._subset([
            r is not None and msr_type in r.msr_types for r in self.residuals
        ])

    def filter_by_tracker(self, tracker: str) -> "ODSolution":
        return self._subset([
            r is not None and r.tracker == tracker for r in self.residuals
        ])

    def exclude_tracker(self, tracker: str) -> "ODSolution":
        return self._subset([
            r is None or r.tracker != tracker for r in self.residuals
        ])

    def split(self) -> List["ODSolution"]:
        """One solution per tracker (filter_data.rs:216)."""
        trackers = sorted({
            r.tracker for r in self.residuals if r is not None
        })
        return [self.filter_by_tracker(t) for t in trackers]

    def merge(self, other: "ODSolution") -> "ODSolution":
        """Chronologically merged records (filter_data.rs:230)."""
        pairs = list(
            zip(self.estimates, self.residuals, self._aligned(self.gains))
        ) + list(
            zip(other.estimates, other.residuals, other._aligned(other.gains))
        )
        pairs.sort(key=lambda p: p[0].epoch.to_tai_seconds())
        out = ODSolution(
            tuple(dict.fromkeys(self.devices + other.devices)),
            tuple(dict.fromkeys(self.measurement_types + other.measurement_types)),
        )
        for e, r, g in pairs:
            out.append(e, r, g)
        out.accepted = self.accepted + other.accepted
        out.rejected = self.rejected + other.rejected
        return out

    def at(self, epoch: Epoch):
        """(estimate, residual) at an exact epoch, None if absent
        (filter_data.rs:265)."""
        t = epoch.to_tai_seconds()
        for e, r in zip(self.estimates, self.residuals):
            if abs(e.epoch.to_tai_seconds() - t) < 1e-6:
                return e, r
        return None

    # ------------------------------------------------------------------
    def smooth(self, devices: Optional[Sequence] = None, *, device="cuda") -> "ODSolution":
        """RTS backward smoother with the stored Φ/P̄ (smooth.rs:33-80).

        Per smooth.rs semantics: gains are scrubbed (the smoother does not
        recompute them), ``filter_smoother_ratios`` carries the ODTK
        filter-smoother consistency test ratio
        ``(x_f − x_s)_i / sqrt((P_f − P_s)_ii)`` per step (smooth.rs:59-105;
        |R| ≤ 3 everywhere ⇒ consistent), and — when the tracking
        ``devices`` are passed — postfit residuals are recomputed from the
        smoothed state estimate on `device` (smooth.rs:164-191).
        """
        n = len(self.estimates)
        sm = [None] * n
        sm[-1] = self.estimates[-1]
        for k in range(n - 2, -1, -1):
            ek = self.estimates[k]
            ek1 = self.estimates[k + 1]
            sk1 = sm[k + 1]
            phi = ek1.stm
            # pinv: the covariance is exactly singular when parameter slots
            # (Cr/Cd/prop mass) carry zero variance; the RTS gain is then
            # well-defined on the observable subspace only
            try:
                pbar_inv = np.linalg.inv(ek1.covar_bar)
            except np.linalg.LinAlgError:
                pbar_inv = np.linalg.pinv(ek1.covar_bar, hermitian=True)
            s_gain = ek.covar @ phi.T @ pbar_inv
            x_bar = phi @ ek.state_deviation
            dev = ek.state_deviation + s_gain @ (sk1.state_deviation - x_bar)
            cov = ek.covar + s_gain @ (sk1.covar - ek1.covar_bar) @ s_gain.T
            sm[k] = KfEstimate(
                nominal=ek.nominal,
                state_deviation=dev,
                covar=0.5 * (cov + cov.T),
                covar_bar=ek.covar_bar,
                stm=ek.stm,
                predicted=ek.predicted,
            )
        # filter-smoother consistency ratios (None where ΔP_ii <= 0, e.g.
        # the unsmoothed final step or frozen parameter slots)
        fs_ratios: List[Optional[np.ndarray]] = [None] * n
        for k in range(n - 1):
            ek, sk = self.estimates[k], sm[k]
            d_state = (
                np.asarray(ek.state().to_vector()[:STATE_DIM])
                - np.asarray(sk.state().to_vector()[:STATE_DIM])
            )
            d_cov = np.diag(ek.covar - sk.covar)
            with np.errstate(divide="ignore", invalid="ignore"):
                fs_ratios[k] = d_state / np.sqrt(np.maximum(d_cov, 0.0))
        residuals = list(self.residuals)
        if devices is not None:
            residuals = self._recompute_postfits(sm, residuals, devices, device)
        out = ODSolution(
            self.devices, self.measurement_types, sm, residuals,
            self.accepted, self.rejected,
            gains=[None] * n,  # scrubbed (smooth.rs note 1)
            filter_smoother_ratios=fs_ratios,
        )
        return out

    def _recompute_postfits(self, sm, residuals, devices, device):
        """Postfit = real - h(smoothed state) per measurement step
        (smooth.rs:164-191), h evaluated on `device`."""
        dev_map = {d.name: d for d in devices}
        k = dict(dtype=torch.float64, device=device)
        out = []
        for est, r in zip(sm, residuals):
            if r is None or r.real_obs is None or r.tracker not in dev_map:
                out.append(r)
                continue
            h_fn = dev_map[r.tracker].measurement_fn(tuple(r.msr_types))
            y = torch.as_tensor(est.state().to_vector()[None, 0:6], **k)
            t = torch.tensor([r.epoch.to_tdb_seconds()], **k)
            computed = h_fn(t, y)[0].cpu().numpy()
            out.append(
                Residual(
                    r.epoch, r.tracker, r.msr_types, r.prefit,
                    np.asarray(r.real_obs) - computed, r.ratio, r.rejected,
                    real_obs=r.real_obs, computed_obs=computed,
                )
            )
        return out

    # -------------------- statistics (stats.rs) ------------------------
    def accepted_residuals(self) -> List[Residual]:
        return [r for r in self.residuals if r is not None and not r.rejected]

    def residual_rms(self, msr_type: Optional[str] = None) -> float:
        """RMS of accepted prefit residuals (stats.rs:148-166)."""
        vals = []
        for r in self.accepted_residuals():
            for j, t in enumerate(r.msr_types):
                if msr_type is None or t == msr_type:
                    vals.append(r.prefit[j])
        if not vals:
            return float("nan")
        return float(np.sqrt(np.mean(np.square(vals))))

    def postfit_rms(self, msr_type: Optional[str] = None) -> float:
        vals = []
        for r in self.accepted_residuals():
            for j, t in enumerate(r.msr_types):
                if msr_type is None or t == msr_type:
                    vals.append(r.postfit[j])
        if not vals:
            return float("nan")
        return float(np.sqrt(np.mean(np.square(vals))))

    def ratios(self) -> np.ndarray:
        return np.array([r.ratio for r in self.accepted_residuals()])

    def percent_within_sigmas(self, num_sigmas: float = 3.0) -> float:
        """Percentage of accepted ratios within N sigma (stats.rs:175)."""
        ratios = self.ratios()
        if len(ratios) == 0:
            return float("nan")
        return float(100.0 * np.mean(np.abs(ratios) <= num_sigmas))

    def ks_normality(self) -> Tuple[float, float]:
        """(statistic, p-value) KS test of residual-ratio normality
        (stats.rs:196-245)."""
        from scipy import stats as sstats

        ratios = self.ratios()
        if len(ratios) < 3:
            return float("nan"), float("nan")
        # ratio = |L^-1 r| / sqrt(m): under a consistent filter, sqrt(m)*ratio
        # follows a chi distribution with m degrees of freedom.
        ms = np.array([len(r.msr_types) for r in self.accepted_residuals()])
        df = int(np.round(np.median(ms)))
        stat, pval = sstats.kstest(np.sqrt(ms) * ratios, sstats.chi(df=df).cdf)
        return float(stat), float(pval)

    def nis(self) -> np.ndarray:
        """Normalized innovation squared per accepted msr (stats.rs:282):
        NIS = rᵀ S⁻¹ r = m * ratio²."""
        return np.array(
            [len(r.msr_types) * r.ratio**2 for r in self.accepted_residuals()]
        )

    def nis_test(self, alpha: float = 0.05) -> dict:
        """Chi-square consistency of the NIS sequence (stats.rs:282-358)."""
        from scipy import stats as sstats

        vals = self.nis()
        ms = np.array([len(r.msr_types) for r in self.accepted_residuals()])
        if len(vals) == 0:
            return dict(consistent=False, mean_nis=float("nan"))
        n_dof = int(np.sum(ms))
        total = float(np.sum(vals))
        lo = sstats.chi2.ppf(alpha / 2, n_dof)
        hi = sstats.chi2.ppf(1 - alpha / 2, n_dof)
        return dict(
            consistent=bool(lo <= total <= hi),
            mean_nis=float(np.mean(vals / ms)),
            total=total,
            lo=float(lo),
            hi=float(hi),
            verdict=(
                "consistent"
                if lo <= total <= hi
                else ("over-confident" if total > hi else "under-confident")
            ),
        )

    # reference-named aliases (od/process/solution/stats.rs public API)
    def rejected_residuals(self) -> List[Residual]:
        return [r for r in self.residuals if r is not None and r.rejected]

    def residual_ratio_within_threshold(self, num_sigmas: float = 3.0) -> float:
        """Percentage of accepted ratios within the threshold
        (stats.rs residual_ratio_within_threshold)."""
        return self.percent_within_sigmas(num_sigmas)

    def is_normal(self, alpha: float = 0.05) -> bool:
        """KS-test verdict on residual-ratio normality (stats.rs is_normal)."""
        _, pval = self.ks_normality()
        return bool(pval > alpha)

    def nis_consistency(self, alpha: float = 0.05) -> str:
        """NIS chi-square verdict string (stats.rs nis_consistency)."""
        return str(self.nis_test(alpha).get("verdict", "no data"))

    def nees(self, truth_states: Sequence) -> np.ndarray:
        """Normalized estimation error squared vs a truth trajectory
        (stats.rs:358). truth_states: Spacecraft at each estimate epoch."""
        out = []
        for est, truth in zip(self.estimates, truth_states):
            err = (truth.to_vector() - est.state().to_vector())[:6]
            p = est.covar[:6, :6]
            out.append(float(err @ np.linalg.solve(p, err)))
        return np.array(out)

    # -------------------- export / conversion --------------------------
    def to_traj(self):
        """Estimated trajectory from the filtered states (solution/mod.rs)."""
        from ..md.trajectory import Trajectory

        ests = self.estimates
        epoch0 = ests[0].epoch
        ts, ys = [], []
        for e in ests:
            t = (e.epoch - epoch0).to_seconds()
            sc = e.state()
            vec = np.zeros(9)
            vec[0:9] = sc.to_vector()
            ts.append(t)
            ys.append(vec)
        return Trajectory.from_capture(
            epoch0, np.array(ts), np.stack(ys), ests[0].nominal
        )

    def to_ephemeris(self, path, target: int = -10_000, degree: int = 11):
        """Write the estimated trajectory as a SPICE BSP segment
        (solution/mod.rs to_ephemeris parity): filtered states -> Traj ->
        SPK type 3."""
        return self.to_traj().to_ephemeris(path, target=target, degree=degree)

    def to_parquet(self, path, local_frame: Optional[str] = None) -> str:
        """Export estimates + covariances (+residuals) to parquet
        (solution/export.rs:60)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        rows = {
            "epoch_tai_s": [],
            "predicted": [],
        }
        labels = ["x", "y", "z", "vx", "vy", "vz", "cr", "cd", "prop_mass"]
        for lbl in labels:
            rows[f"{lbl}"] = []
            rows[f"sigma_{lbl}"] = []
        rows["ratio"] = []
        rows["rejected"] = []
        # full covariance upper triangle for lossless import (export.rs
        # covar columns cx_x..)
        iu = np.triu_indices(STATE_DIM)
        for a, b in zip(*iu):
            rows[f"covar_{labels[a]}_{labels[b]}"] = []
        # filter gain norms per state block and filter-smoother consistency
        # ratios (export.rs:304-340 gain / fs-ratio columns)
        has_gains = any(g is not None for g in self.gains)
        has_fs = any(f is not None for f in self.filter_smoother_ratios)
        if has_gains:
            rows["gain_pos_norm"] = []
            rows["gain_vel_norm"] = []
        if has_fs:
            for lbl in labels:
                rows[f"fs_ratio_{lbl}"] = []
        gains = self._aligned(self.gains)
        fs = self._aligned(self.filter_smoother_ratios)
        for est, res, g, f in zip(self.estimates, self.residuals, gains, fs):
            rows["epoch_tai_s"].append(est.epoch.to_tai_seconds())
            rows["predicted"].append(est.predicted)
            vec = est.state().to_vector()
            cov = (
                est.covar
                if local_frame is None
                else _expand_local(est, local_frame)
            )
            sig = np.sqrt(np.maximum(np.diag(cov), 0.0))
            for i, lbl in enumerate(labels):
                rows[lbl].append(float(vec[i]))
                rows[f"sigma_{lbl}"].append(float(sig[i]))
            for a, b in zip(*iu):
                rows[f"covar_{labels[a]}_{labels[b]}"].append(float(est.covar[a, b]))
            rows["ratio"].append(res.ratio if res else np.nan)
            rows["rejected"].append(bool(res.rejected) if res else False)
            if has_gains:
                rows["gain_pos_norm"].append(
                    float(np.linalg.norm(g[0:3])) if g is not None else np.nan
                )
                rows["gain_vel_norm"].append(
                    float(np.linalg.norm(g[3:6])) if g is not None else np.nan
                )
            if has_fs:
                for i, lbl in enumerate(labels):
                    rows[f"fs_ratio_{lbl}"].append(
                        float(f[i]) if f is not None else np.nan
                    )
        table = pa.table(rows).replace_schema_metadata({b"generator": b"nyx_tpu_torch"})
        pq.write_table(table, str(path), compression="zstd")
        return str(path)

    @classmethod
    def from_parquet(cls, path, template) -> "ODSolution":
        """Import estimates exported by to_parquet (solution/import.rs).
        `template` is a Spacecraft providing the frame/constants."""
        import pyarrow.parquet as pq

        table = pq.read_table(str(path))
        labels = ["x", "y", "z", "vx", "vy", "vz", "cr", "cd", "prop_mass"]
        n = table.num_rows
        epochs = np.asarray(table["epoch_tai_s"], dtype=np.float64)
        vecs = np.stack(
            [np.asarray(table[lbl], dtype=np.float64) for lbl in labels], axis=-1
        )
        iu = np.triu_indices(STATE_DIM)
        sol = cls()
        for k in range(n):
            cov = np.zeros((STATE_DIM, STATE_DIM))
            for a, b in zip(*iu):
                v = float(table[f"covar_{labels[a]}_{labels[b]}"][k].as_py())
                cov[a, b] = cov[b, a] = v
            epoch = Epoch.from_tai_seconds_j2000(float(epochs[k]))
            nominal = template.set_vector(epoch, vecs[k])
            est = KfEstimate(
                nominal=nominal,
                state_deviation=np.zeros(STATE_DIM),
                covar=cov,
                covar_bar=cov.copy(),
                stm=np.eye(STATE_DIM),
                predicted=bool(table["predicted"][k].as_py()),
            )
            sol.append(est, None)
        # filter-smoother consistency ratios round-trip when present
        if "fs_ratio_x" in table.column_names:
            fs_cols = np.stack(
                [
                    np.asarray(table[f"fs_ratio_{lbl}"], dtype=np.float64)
                    for lbl in labels
                ],
                axis=-1,
            )
            sol.filter_smoother_ratios = [
                None if np.all(np.isnan(row)) else row for row in fs_cols
            ]
        return sol

    def __str__(self):
        return (
            f"ODSolution: {len(self)} estimates, {self.accepted} accepted / "
            f"{self.rejected} rejected measurements"
        )


def _expand_local(est: KfEstimate, local_frame: str) -> np.ndarray:
    cov = est.covar.copy()
    cov[0:6, 0:6] = est.covar_in_frame(local_frame)
    return cov
