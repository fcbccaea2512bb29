"""Integration error estimators, GMAT-compatible.

Torch port of `RSSCartesianStep`, the default control of
nyx_tpu/propagators/error_ctrl.py (the other six are not ported yet). It
takes the error estimate, the candidate state and the current state
(trailing state axis) and returns one error per lane; only the first six
entries (position, velocity) feed it.
"""

from __future__ import annotations

import math

import torch

from ..xmath import norm as _norm

REL_ERR_THRESH = 0.1


def _rss_step_block(err, cand, cur):
    mag = _norm(cand - cur)
    e = _norm(err)
    return torch.where(mag > math.sqrt(REL_ERR_THRESH), e / mag, e)


def rss_cartesian_step(err, cand, cur):
    er = _rss_step_block(err[..., 0:3], cand[..., 0:3], cur[..., 0:3])
    ev = _rss_step_block(err[..., 3:6], cand[..., 3:6], cur[..., 3:6])
    return torch.maximum(er, ev)


class ErrorControl:
    """Named error controls; values are the estimator functions."""

    RSSCartesianStep = staticmethod(rss_cartesian_step)  # default, as GMAT
