"""Carrying tables, states, arcs, estimates and trajectories from the JAX
package into the port.

These take numpy arrays and plain numbers only, so this module imports
neither JAX nor `nyx_tpu`. Tests use them to hold the port against the
reference on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .cosmic.frames import Frame, Frames
from .cosmic.orbit import Orbit
from .cosmic.spacecraft import GuidanceMode, Spacecraft, Thruster
from .dynamics.gravity import Harmonics
from .ephem.almanac import EphemTable
from .md.trajectory import Trajectory
from .od.estimate import KfEstimate
from .od.msr import TrackingDataArc
from .time import Epoch


def harmonics_from_tables(xs, diag, N: int, M: int, mu: float, radius: float,
                          precision: str, j2: float, j3: float,
                          frame: Frame = Frames.IAU_EARTH) -> Harmonics:
    """The port's Harmonics from the reference object's `_tables` (xs,
    diag, N, M), its constants `mu` and `radius` as they are, and the
    body-fixed `frame` its coefficients live in (an Earth field's
    IAU_EARTH unless given), so both compute from identical rows."""
    xs = {k: np.asarray(v) for k, v in xs.items()}
    return Harmonics(
        _tables=(xs, np.asarray(diag), int(N), int(M)),
        mu_km3_s2=float(mu),
        radius_km=float(radius),
        max_degree=int(N),
        max_order=int(M),
        frame=frame,
        precision=precision,
        j2=float(j2),
        j3=float(j3),
    )


def ephem_table_from_numpy(t0: float, intlen: float, coeffs, bodies, *, device) -> EphemTable:
    """An EphemTable from the reference table's arrays."""
    return EphemTable(
        t0=float(t0),
        intlen=float(intlen),
        coeffs=torch.tensor(np.asarray(coeffs), dtype=torch.float64, device=device),
        bodies=tuple(int(b) for b in bodies),
    )


def states_from_numpy(y0, *, device) -> torch.Tensor:
    """Injected initial states [B, 9] as a float64 tensor on `device`."""
    y0 = np.asarray(y0, dtype=np.float64)
    if y0.ndim != 2 or y0.shape[1] != 9:
        raise ValueError(f"initial states must be [B, 9], got {y0.shape}")
    return torch.as_tensor(y0, dtype=torch.float64, device=device)


def spacecraft_from_numpy(vector, epoch_tai_s: float, frame: Frame = Frames.EME2000, *,
                          dry_mass_kg: float = 0.0, srp_area_m2: float = 0.0,
                          drag_area_m2: float = 0.0, thruster=None,
                          mode: int = GuidanceMode.Coast) -> Spacecraft:
    """A Spacecraft from its 9-state vector and TAI epoch (s past J2000);
    `thruster` is (thrust N, Isp s) or None, `mode` its guidance mode."""
    vector = np.asarray(vector, dtype=np.float64)
    orbit = Orbit(vector[0:3].copy(), vector[3:6].copy(),
                  Epoch.from_tai_seconds_j2000(float(epoch_tai_s)), frame)
    sc = Spacecraft(orbit, dry_mass_kg=dry_mass_kg, srp_area_m2=srp_area_m2,
                    drag_area_m2=drag_area_m2,
                    thruster=None if thruster is None else Thruster(*map(float, thruster)),
                    mode=int(mode))
    return sc.set_vector(orbit.epoch, vector)


def tracking_arc_from_numpy(trackers, types, epochs_tai_s, tracker_idx, values,
                            force_reject: bool = False) -> TrackingDataArc:
    """A TrackingDataArc from the reference arc's tracker names, type tags,
    epochs [M], tracker indices [M] and values [M, T] (NaN = absent)."""
    return TrackingDataArc(
        trackers=tuple(str(t) for t in trackers),
        types=tuple(str(t) for t in types),
        epochs_tai_s=np.asarray(epochs_tai_s, dtype=np.float64).copy(),
        tracker_idx=np.asarray(tracker_idx, dtype=np.int64).copy(),
        values=np.asarray(values, dtype=np.float64).copy(),
        force_reject=bool(force_reject),
    )


def kf_estimate_from_numpy(nominal_vector, covar, epoch_tai_s: float,
                           frame: Frame = Frames.EME2000, **spacecraft) -> KfEstimate:
    """A KfEstimate from the reference estimate's nominal 9-state vector,
    covariance [9, 9] and TAI epoch; `spacecraft` takes the masses and
    areas of `spacecraft_from_numpy`."""
    return KfEstimate.from_covar(
        spacecraft_from_numpy(nominal_vector, epoch_tai_s, frame, **spacecraft), covar)


def kf_estimates_from_numpy(nominal_vectors, covars, epoch_tai_s: float,
                            frame: Frame = Frames.EME2000, **spacecraft) -> list:
    """KfEstimates at one epoch from the reference estimates' nominal
    vectors [B, 9] and covariances [B, 9, 9] (an ensemble of filters)."""
    return [kf_estimate_from_numpy(v, c, epoch_tai_s, frame, **spacecraft)
            for v, c in zip(np.asarray(nominal_vectors), np.asarray(covars))]


def trajectory_from_numpy(epoch0_tai_s: float, ts, ys, frame: Frame = Frames.EME2000,
                          **spacecraft) -> Trajectory:
    """A Trajectory from the reference trajectory's start epoch (TAI), node
    times [K] (s after it) and states [K, N]; its template spacecraft is
    the first node's."""
    ys = np.asarray(ys, dtype=np.float64)
    template = spacecraft_from_numpy(ys[0, :9], epoch0_tai_s, frame, **spacecraft)
    return Trajectory(template.epoch, np.asarray(ts, dtype=np.float64).copy(), ys.copy(), template)
