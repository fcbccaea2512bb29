"""Conical shadow model (torch port of nyx_tpu/cosmic/eclipse.py).

Fraction of the solar disk occulted by one or more shadow bodies, from the
overlap of apparent disks. Batched, at the dtype of the inputs; branches are
selected on masked inputs so every branch stays finite.

`ShadowModel` queries a trajectory for eclipses: `compute`, the state of one
orbit, on the host; `percentages`, the occulted fraction at a regular grid
of the trajectory's samples, batched on a device from one Chebyshev table of
the Sun and the shadow bodies; and `find_eclipse_events`, the entries and
exits, each bisected 30 times on the trajectory's interpolant. Where no
almanac is given, `default_almanac()` serves, as in the reference: the SPK
files it finds, else the analytic series.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import NAIF, RADIUS_BY_NAIF, MeanRadius
from ..xmath import norm as _norm


def _safe_arccos(x):
    """arccos with a finite gradient as |x| -> 1 (the double-where trick)."""
    inside = torch.abs(x) < 1.0 - 1e-12
    xs = torch.where(inside, x, 0.0)
    edge = torch.where(x > 0.0, 0.0, torch.full_like(x, math.pi))
    return torch.where(inside, torch.arccos(xs), edge)


def _safe_sqrt(x):
    good = x > 1e-300
    return torch.where(good, torch.sqrt(torch.where(good, x, 1.0)), 0.0)


def _apparent_overlap_fraction(ang, r_sun_app, r_occ_app):
    """Fraction of the Sun's apparent disk covered by the occulter's disk."""
    eps = 1e-30
    full = r_occ_app >= r_sun_app + 0.0
    no_overlap = ang >= r_sun_app + r_occ_app
    contained = ang <= torch.abs(r_occ_app - r_sun_app)
    partial = (~no_overlap) & (~contained)
    # circle-circle intersection (lens) area, masked to the partial branch
    d = torch.where(partial, torch.clamp(ang, min=eps), 1.0)
    r1, r2 = r_sun_app, r_occ_app
    d1 = (d * d + r1 * r1 - r2 * r2) / (2 * d)
    d2 = d - d1
    a1 = r1 * r1 * _safe_arccos(d1 / torch.clamp(r1, min=eps)) - d1 * _safe_sqrt(
        r1 * r1 - d1 * d1
    )
    a2 = r2 * r2 * _safe_arccos(d2 / torch.clamp(r2, min=eps)) - d2 * _safe_sqrt(
        r2 * r2 - d2 * d2
    )
    lens = a1 + a2
    sun_area = math.pi * r1 * r1
    frac_partial = torch.clamp(lens / torch.clamp(sun_area, min=eps), 0.0, 1.0)

    frac_contained = torch.where(
        full, 1.0, torch.clamp((r2 * r2) / torch.clamp(r1 * r1, min=eps), 0.0, 1.0)
    )
    return torch.where(
        no_overlap, 0.0, torch.where(contained, frac_contained, frac_partial)
    )


def occultation_percentage(r_sc_to_sun, r_sc_to_occ, occ_radius_km, sun_radius_km=MeanRadius.SUN):
    """Occulted fraction of the Sun [0..1]. Inputs [..., 3] km from spacecraft."""
    d_sun = _norm(r_sc_to_sun)
    d_occ = _norm(r_sc_to_occ)
    r_sun_app = torch.arcsin(torch.clamp(sun_radius_km / d_sun, 0.0, 1.0 - 1e-12))
    r_occ_app = torch.arcsin(torch.clamp(occ_radius_km / d_occ, 0.0, 1.0 - 1e-12))
    cosang = torch.sum(r_sc_to_sun * r_sc_to_occ, dim=-1) / (d_sun * d_occ)
    ang = _safe_arccos(cosang)
    frac = _apparent_overlap_fraction(ang, r_sun_app, r_occ_app)
    # a body only occults the Sun when it is closer than the Sun
    return torch.where(d_occ < d_sun, frac, 0.0)


def illumination_factor(r_sc_to_sun, occulters):
    """k in [0..1]: 1 fully lit, 0 umbra. `occulters`: list of
    (r_sc_to_body [...,3], radius_km). Max occultation wins."""
    occ = torch.zeros(
        r_sc_to_sun.shape[:-1], dtype=r_sc_to_sun.dtype, device=r_sc_to_sun.device
    )
    for r_occ, radius in occulters:
        occ = torch.maximum(occ, occultation_percentage(r_sc_to_sun, r_occ, radius))
    return 1.0 - occ


class EclipseState:
    """An occultation: the occulted fraction of the Sun's disk in [0, 1]."""

    def __init__(self, percentage: float):
        self.percentage = float(percentage)

    @property
    def is_umbra(self) -> bool:
        return self.percentage >= 1.0 - 1e-9

    @property
    def is_penumbra(self) -> bool:
        return 0.0 < self.percentage < 1.0

    @property
    def is_visible(self) -> bool:
        return self.percentage <= 1e-9

    def __str__(self):
        if self.is_umbra:
            return "Umbra"
        if self.is_visible:
            return "Visibilis"
        return f"Penumbra {self.percentage * 100:.2f}%"


class ShadowModel:
    """The largest occultation over a list of shadow bodies (NAIF ids)."""

    def __init__(self, shadow_bodies, almanac=None):
        self.shadow_bodies = tuple(shadow_bodies)
        self.almanac = almanac

    @classmethod
    def cislunar(cls, almanac=None) -> "ShadowModel":
        return cls((NAIF.EARTH, NAIF.MOON), almanac)

    def _almanac(self):
        if self.almanac is None:
            from ..ephem.almanac import default_almanac

            self.almanac = default_almanac()
        return self.almanac

    def compute(self, orbit, almanac=None) -> EclipseState:
        """The eclipse state of one Orbit, on the host (float64 on the CPU)."""
        alm = almanac or self._almanac()
        center = orbit.frame.center
        t_tdb = orbit.epoch.to_tdb_seconds()
        r = np.asarray(orbit.r_km, dtype=np.float64)
        r_sun = torch.from_numpy(alm.position(NAIF.SUN, center, t_tdb) - r)
        pct = 0.0
        for body in self.shadow_bodies:
            r_occ = -r if body == center else alm.position(body, center, t_tdb) - r
            pct = max(pct, float(occultation_percentage(r_sun, torch.from_numpy(r_occ),
                                                        RADIUS_BY_NAIF[body])))
        return EclipseState(pct)

    def percentages(self, traj, step_s: float = 60.0, *, device="cuda"):
        """(seconds past the trajectory's start [K], occulted fraction [K])
        every `step_s` along `traj`, computed on `device` as numpy."""
        alm = self._almanac()
        center = traj.template.frame.center
        ts = np.arange(float(traj.ts[0]), float(traj.ts[-1]) + 1e-9, step_s)
        rs = traj.interpolate_many(ts)[:, :3]
        epoch0 = traj.epoch0
        table = alm.build_table([NAIF.SUN] + [b for b in self.shadow_bodies if b != center], center,
                                epoch0 + float(ts[0]), epoch0 + float(ts[-1]), device=device)
        k = dict(dtype=torch.float64, device=device)
        r = torch.as_tensor(rs, **k)
        tt = torch.as_tensor(epoch0.to_tdb_seconds() + ts, **k)
        r_sun = table.position(table.index_of(NAIF.SUN), tt) - r
        pct = torch.zeros(len(ts), **k)
        for body in self.shadow_bodies:
            r_occ = -r if body == center else table.position(table.index_of(body), tt) - r
            pct = torch.maximum(pct, occultation_percentage(r_sun, r_occ, RADIUS_BY_NAIF[body]))
        return ts, pct.cpu().numpy()

    def find_eclipse_events(self, traj, threshold: float = 1e-6, step_s: float = 60.0, *,
                            device="cuda"):
        """[(epoch, "entry" or "exit")]: where the occulted fraction crosses
        `threshold` between two samples of `percentages`, each bisected 30
        times with `compute` on the trajectory's interpolant."""
        ts, pct = self.percentages(traj, step_s, device=device)
        inside = pct > threshold
        out = []
        for i in range(len(ts) - 1):
            if inside[i] == inside[i + 1]:
                continue
            lo, hi = ts[i], ts[i + 1]
            for _ in range(30):
                mid = 0.5 * (lo + hi)
                state = traj.template.set_vector(traj.epoch0 + float(mid), traj.interpolate(mid)[:9])
                if (self.compute(state.orbit).percentage > threshold) == bool(inside[i]):
                    lo = mid
                else:
                    hi = mid
            out.append((traj.epoch0 + float(0.5 * (lo + hi)), "exit" if inside[i] else "entry"))
        return out
