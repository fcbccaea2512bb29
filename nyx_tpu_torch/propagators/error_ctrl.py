"""Integration error estimators, GMAT-compatible.

Torch port of the seven error controls of
nyx_tpu/propagators/error_ctrl.py (the reference's error_ctrl.rs:30-150).
Each takes the error estimate, the candidate state and the current state
(trailing state axis) and returns one error per lane. Only the first six
entries (position, velocity) feed the Cartesian controls; the others
read every entry of the state they are given.
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


def _rss_state_block(err, cand, cur):
    mag = 0.5 * _norm(cand + cur)
    e = _norm(err)
    return torch.where(mag > REL_ERR_THRESH, e / mag, e)


def rss_cartesian_step(err, cand, cur):
    er = _rss_step_block(err[..., 0:3], cand[..., 0:3], cur[..., 0:3])
    ev = _rss_step_block(err[..., 3:6], cand[..., 3:6], cur[..., 3:6])
    return torch.maximum(er, ev)


def rss_cartesian_state(err, cand, cur):
    er = _rss_state_block(err[..., 0:3], cand[..., 0:3], cur[..., 0:3])
    ev = _rss_state_block(err[..., 3:6], cand[..., 3:6], cur[..., 3:6])
    return torch.maximum(er, ev)


def rss_step(err, cand, cur):
    return _rss_step_block(err, cand, cur)


def rss_state(err, cand, cur):
    return _rss_state_block(err, cand, cur)


def largest_error(err, cand, cur):
    delta = cand - cur
    e = torch.where(delta > REL_ERR_THRESH, torch.abs(err / delta), torch.abs(err))
    return torch.amax(e, dim=-1)


def largest_state(err, cand, cur):
    mag = torch.sum(0.5 * torch.abs(cand + cur), dim=-1)
    e = torch.sum(torch.abs(err), dim=-1)
    return torch.where(mag > REL_ERR_THRESH, e / mag, e)


def largest_step(err, cand, cur):
    mag = torch.sum(torch.abs(cand - cur), dim=-1)
    e = torch.sum(torch.abs(err), dim=-1)
    return torch.where(mag > math.sqrt(REL_ERR_THRESH), e / mag, e)


class ErrorControl:
    """Named error controls; values are the estimator functions."""

    RSSCartesianStep = staticmethod(rss_cartesian_step)  # default, as GMAT
    RSSCartesianState = staticmethod(rss_cartesian_state)
    RSSStep = staticmethod(rss_step)
    RSSState = staticmethod(rss_state)
    LargestError = staticmethod(largest_error)
    LargestState = staticmethod(largest_state)
    LargestStep = staticmethod(largest_step)
