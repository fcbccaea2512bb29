"""Conical shadow model (torch port of nyx_tpu/cosmic/eclipse.py).

Fraction of the solar disk occulted by one or more shadow bodies, from the
overlap of apparent disks. Batched, at the dtype of the inputs; branches are
selected on masked inputs so every branch stays finite.
"""

from __future__ import annotations

import math

import torch

from ..constants import MeanRadius
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
