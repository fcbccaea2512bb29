"""Plotting helpers (matplotlib on the Agg backend).

Port of nyx_tpu/plots.py, the counterpart of the reference's Python plot
helpers (nyx-py/nyx_space/plots/{md,od}.py, which use plotly). Each
function takes the port's objects (`Trajectory`, `ODSolution`, `Porkchop`)
and returns the matplotlib Figure; pass `show=False` in headless
environments and save with `fig.savefig(...)`. The plots' data are host
numpy arrays; the RIC frames come from `cosmic.orbit.ric_dcm` on CPU
tensors, and `plot_groundtrack` runs `Trajectory.groundtrack` on `device`
(the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .cosmic.orbit import ric_dcm


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _ric(r, v) -> np.ndarray:
    """The RIC DCM [3, 3] at a host state (cosmic/orbit.py::ric_dcm)."""
    f64 = dict(dtype=torch.float64)
    return ric_dcm(torch.as_tensor(np.asarray(r), **f64),
                   torch.as_tensor(np.asarray(v), **f64)).numpy()


def plot_traj(traj, title: str = "Trajectory", step=300.0, show=True):
    """3D trajectory plot (plots/md.py plot_traj)."""
    plt = _plt()
    ts = np.arange(float(traj.ts[0]), float(traj.ts[-1]) + 1e-9, float(step))
    rs = np.stack([traj.interpolate(t)[:3] for t in ts])
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot(rs[:, 0], rs[:, 1], rs[:, 2], lw=0.8)
    ax.scatter(*rs[0], color="green", label="start")
    ax.scatter(*rs[-1], color="red", label="end")
    ax.set_xlabel("x (km)")
    ax.set_ylabel("y (km)")
    ax.set_zlabel("z (km)")
    ax.set_title(title)
    ax.legend()
    if show:
        plt.show()
    return fig


def plot_orbital_elements(traj, parameters=("sma", "ecc", "inc", "raan", "aop", "ta"),
                          step=300.0, title="Orbital elements", show=True):
    """Osculating-element time series (plots/plot_orbital_elements.py)."""
    plt = _plt()
    n = len(parameters)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2.2 * n), sharex=True)
    if n == 1:
        axes = [axes]
    for ax, p in zip(axes, parameters):
        ts, vals = traj.sample_values(p, step)
        ax.plot(ts / 3600.0, vals, lw=0.8)
        ax.set_ylabel(p)
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("hours past start")
    fig.suptitle(title)
    if show:
        plt.show()
    return fig


def plot_groundtrack(traj, body_frame=None, step=120.0, title="Ground track",
                     show=True, *, device="cuda"):
    """Latitude against longitude of the sub-satellite points."""
    plt = _plt()
    ts, lat, lon, alt = traj.groundtrack(body_frame, step, device=device)
    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.scatter(lon, lat, s=1)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_xlabel("longitude (deg)")
    ax.set_ylabel("latitude (deg)")
    ax.grid(alpha=0.3)
    ax.set_title(title)
    if show:
        plt.show()
    return fig


def plot_covar(od_solution, indices=(0, 1, 2), labels=("x", "y", "z"),
               sigmas: float = 3.0, title="Covariance", show=True):
    """Sigma envelopes over the solution (plots/od.py plot_covar)."""
    plt = _plt()
    ests = od_solution.estimates
    t0 = ests[0].epoch.to_tai_seconds()
    ts = np.array([e.epoch.to_tai_seconds() - t0 for e in ests]) / 3600.0
    fig, axes = plt.subplots(len(indices), 1, figsize=(8, 2.2 * len(indices)),
                             sharex=True)
    if len(indices) == 1:
        axes = [axes]
    for ax, i, lbl in zip(axes, indices, labels):
        sig = np.array([np.sqrt(e.covar[i, i]) for e in ests]) * sigmas
        ax.fill_between(ts, -sig, sig, alpha=0.3)
        ax.set_ylabel(f"{sigmas:g} sigma {lbl} (km)")
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("hours past start")
    fig.suptitle(title)
    if show:
        plt.show()
    return fig


def plot_residuals(od_solution, title="Residuals", show=True):
    """Prefit/postfit residuals + rejection markers (plots/od.py
    plot_residuals)."""
    plt = _plt()
    res = [r for r in od_solution.residuals if r is not None]
    t0 = res[0].epoch.to_tai_seconds()
    ts = np.array([r.epoch.to_tai_seconds() - t0 for r in res]) / 3600.0
    ratios = np.array([r.ratio for r in res])
    rejected = np.array([r.rejected for r in res])
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.scatter(ts[~rejected], ratios[~rejected], s=6, label="accepted")
    if rejected.any():
        ax.scatter(ts[rejected], ratios[rejected], s=10, color="red",
                   marker="x", label="rejected")
    ax.axhline(3.0, color="gray", ls="--", lw=0.8)
    ax.set_xlabel("hours past start")
    ax.set_ylabel("residual ratio (sigma)")
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title(title)
    if show:
        plt.show()
    return fig


def plot_od_dashboard(od_solution, truth_traj=None, title="OD dashboard",
                      show=True):
    """Residual ratios + position sigmas (+ RIC error vs a truth
    trajectory) in one figure — the reference's od-dashboard view
    (examples/06 od-dashboard.png)."""
    plt = _plt()
    n_rows = 3 if truth_traj is not None else 2
    fig, axes = plt.subplots(n_rows, 1, figsize=(8, 3 * n_rows), sharex=True)
    res = [r for r in od_solution.residuals if r is not None]
    t0 = od_solution.estimates[0].epoch.to_tai_seconds()
    tr = np.array([r.epoch.to_tai_seconds() - t0 for r in res]) / 3600.0
    ratios = np.array([r.ratio for r in res])
    rejected = np.array([r.rejected for r in res])
    ax = axes[0]
    ax.scatter(tr[~rejected], ratios[~rejected], s=5, label="accepted")
    if rejected.any():
        ax.scatter(tr[rejected], ratios[rejected], s=8, color="red",
                   marker="x", label="rejected")
    ax.axhline(3.0, color="gray", ls="--", lw=0.8)
    ax.set_ylabel("ratio (sigma)")
    ax.legend(loc="upper right")
    ax.grid(alpha=0.3)

    te = np.array([
        e.epoch.to_tai_seconds() - t0 for e in od_solution.estimates
    ]) / 3600.0
    sig = np.stack([
        np.sqrt(np.diag(e.covar)[:3]) for e in od_solution.estimates
    ])
    ax = axes[1]
    for j, lbl in enumerate(("x", "y", "z")):
        ax.semilogy(te, sig[:, j] * 1e3, label=f"sigma {lbl}")
    ax.set_ylabel("position sigma (m)")
    ax.legend(loc="upper right")
    ax.grid(alpha=0.3)

    if truth_traj is not None:
        errs = []
        for e in od_solution.estimates:
            truth = truth_traj.at(e.epoch)
            dcm = _ric(truth.orbit.r_km, truth.orbit.v_km_s)
            errs.append(dcm @ (
                np.asarray(e.state().orbit.r_km)
                - np.asarray(truth.orbit.r_km)
            ))
        errs = np.stack(errs) * 1e3
        ax = axes[2]
        for j, lbl in enumerate(("radial", "in-track", "cross-track")):
            ax.plot(te, errs[:, j], label=lbl)
        ax.set_ylabel("RIC error (m)")
        ax.legend(loc="upper right")
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("hours past start")
    fig.suptitle(title)
    if show:
        plt.show()
    return fig


def plot_kalman_gains(od_solution, title="Kalman gains", show=True):
    """Per-step gain magnitudes, one panel per measurement type
    (plots/od.py kalman_gains)."""
    plt = _plt()
    steps, gains = [], []
    t0 = od_solution.estimates[0].epoch.to_tai_seconds()
    for e, g in zip(od_solution.estimates, od_solution._aligned(od_solution.gains)):
        if g is not None:
            steps.append((e.epoch.to_tai_seconds() - t0) / 3600.0)
            gains.append(np.asarray(g))
    if not gains:
        raise ValueError(
            "no gains recorded (time-update-only solution, or smoothed)"
        )
    n_types = gains[0].shape[1]
    ts = np.asarray(steps)
    fig, axes = plt.subplots(n_types, 1, figsize=(8, 2.5 * n_types),
                             sharex=True, squeeze=False)
    for j in range(n_types):
        ax = axes[j][0]
        # position- and velocity-block gain norms for measurement type j
        ax.semilogy(ts, [np.linalg.norm(g[0:3, j]) for g in gains],
                    label="position block")
        ax.semilogy(ts, [np.linalg.norm(g[3:6, j]) for g in gains],
                    label="velocity block")
        ax.set_ylabel(f"|K| type {j}")
        ax.grid(alpha=0.3)
        ax.legend(loc="upper right")
    axes[-1][0].set_xlabel("hours past start")
    fig.suptitle(title)
    if show:
        plt.show()
    return fig


def plot_filter_smoother_ratios(od_solution, labels=("x", "y", "z", "vx", "vy", "vz"),
                                title="Filter-smoother consistency", show=True):
    """ODTK filter-smoother consistency test ratios from a smoothed
    solution (plots/od.py filter_smoother_ratios); |R| <= 3 everywhere
    means the filter and smoother agree."""
    plt = _plt()
    t0 = od_solution.estimates[0].epoch.to_tai_seconds()
    ts, rows = [], []
    for e, f in zip(
        od_solution.estimates,
        od_solution._aligned(od_solution.filter_smoother_ratios),
    ):
        if f is not None:
            ts.append((e.epoch.to_tai_seconds() - t0) / 3600.0)
            rows.append(np.asarray(f)[: len(labels)])
    if not rows:
        raise ValueError("no ratios — call ODSolution.smooth() first")
    rows = np.stack(rows)
    fig, ax = plt.subplots(figsize=(8, 4))
    for j, lbl in enumerate(labels):
        ax.plot(ts, rows[:, j], lw=0.8, label=lbl)
    for y in (-3.0, 3.0):
        ax.axhline(y, color="gray", ls="--", lw=0.8)
    ax.set_xlabel("hours past start")
    ax.set_ylabel("consistency ratio")
    ax.grid(alpha=0.3)
    ax.legend(loc="upper right", ncols=3)
    ax.set_title(title)
    if show:
        plt.show()
    return fig


def plot_orbital_element_uncertainty(od_solution, sigmas: float = 3.0,
                                     title="Orbital element uncertainty",
                                     show=True):
    """Keplerian-element sigma envelopes over the solution
    (plots/od.py orbital_element_uncertainty, via keplerian_covar)."""
    plt = _plt()
    labels = ("sma (km)", "ecc", "inc (deg)", "raan (deg)", "aop (deg)",
              "ta (deg)")
    t0 = od_solution.estimates[0].epoch.to_tai_seconds()
    ts = np.array([
        e.epoch.to_tai_seconds() - t0 for e in od_solution.estimates
    ]) / 3600.0
    sig = np.stack([
        np.sqrt(np.maximum(np.diag(e.keplerian_covar()), 0.0))
        for e in od_solution.estimates
    ]) * sigmas
    fig, axes = plt.subplots(3, 2, figsize=(9, 7), sharex=True)
    for j, lbl in enumerate(labels):
        ax = axes[j // 2][j % 2]
        ax.semilogy(ts, np.maximum(sig[:, j], 1e-16), lw=0.8)
        ax.set_ylabel(f"{sigmas:g} sigma {lbl}")
        ax.grid(alpha=0.3)
    for ax in axes[-1]:
        ax.set_xlabel("hours past start")
    fig.suptitle(title)
    if show:
        plt.show()
    return fig


def plot_ric_diff(traj, other, step=300.0, title="RIC difference", show=True):
    """Position/velocity RIC deltas of `traj` vs `other` over their common
    span (plots/md.py ric_diff)."""
    plt = _plt()
    t_lo = max(float(traj.ts[0]), float(other.ts[0]))
    t_hi = min(float(traj.ts[-1]), float(other.ts[-1]))
    ts = np.arange(t_lo, t_hi + 1e-9, float(step))
    drs, dvs = [], []
    for t in ts:
        y = traj.interpolate(t)
        yo = other.interpolate(t)
        dcm = _ric(yo[0:3], yo[3:6])
        drs.append(dcm @ (y[0:3] - yo[0:3]))
        dvs.append(dcm @ (y[3:6] - yo[3:6]))
    drs = np.stack(drs) * 1e3  # m
    dvs = np.stack(dvs) * 1e6  # mm/s
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    hours = (ts - ts[0]) / 3600.0
    for j, lbl in enumerate(("radial", "in-track", "cross-track")):
        axes[0].plot(hours, drs[:, j], lw=0.8, label=lbl)
        axes[1].plot(hours, dvs[:, j], lw=0.8, label=lbl)
    axes[0].set_ylabel("position delta (m)")
    axes[1].set_ylabel("velocity delta (mm/s)")
    axes[1].set_xlabel("hours past start")
    for ax in axes:
        ax.grid(alpha=0.3)
        ax.legend(loc="upper right")
    fig.suptitle(title)
    if show:
        plt.show()
    return fig


def residual_autocorr(x, max_lag: int = 50) -> np.ndarray:
    """Normalized autocorrelation of a residual series up to `max_lag`
    (plots/od.py autocorr): white residuals decay to ~0 immediately."""
    x = np.asarray(x, dtype=np.float64)
    x = x - np.mean(x)
    var = np.dot(x, x)
    if var == 0.0 or len(x) < 2:
        return np.zeros(min(max_lag, len(x)))
    n = min(max_lag, len(x) - 1)
    return np.array([
        np.dot(x[: len(x) - k], x[k:]) / var for k in range(n)
    ])


def plot_residual_autocorr(od_solution, max_lag: int = 50,
                           title="Residual autocorrelation", show=True):
    """Prefit-ratio autocorrelation with the white-noise 95% band."""
    plt = _plt()
    res = od_solution.accepted_residuals()
    ratios = np.array([r.ratio for r in res])
    ac = residual_autocorr(ratios, max_lag)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.stem(np.arange(len(ac)), ac)
    band = 1.96 / np.sqrt(max(len(ratios), 1))
    for y in (-band, band):
        ax.axhline(y, color="gray", ls="--", lw=0.8)
    ax.set_xlabel("lag")
    ax.set_ylabel("autocorrelation")
    ax.grid(alpha=0.3)
    ax.set_title(title)
    if show:
        plt.show()
    return fig


def plot_porkchop(pc, metric="c3_km2_s2", title="Porkchop", show=True,
                  levels=20):
    """Contour plot of a tools.porkchop.Porkchop grid."""
    plt = _plt()
    t0 = pc.dep_epochs[0].to_tai_seconds()
    xs = [
        (e.to_tai_seconds() - t0) / 86_400.0 for e in pc.arr_epochs
    ]
    ys = [
        (e.to_tai_seconds() - t0) / 86_400.0 for e in pc.dep_epochs
    ]
    grid = getattr(pc, metric)
    fig, ax = plt.subplots(figsize=(7, 5))
    cs = ax.contourf(xs, ys, grid, levels=levels, cmap="viridis")
    fig.colorbar(cs, ax=ax, label=metric)
    ax.set_xlabel("arrival (days past first departure)")
    ax.set_ylabel("departure (days past first departure)")
    ax.set_title(title)
    if show:
        plt.show()
    return fig
