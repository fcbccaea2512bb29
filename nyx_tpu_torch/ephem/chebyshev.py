"""Chebyshev fitting (host, numpy) and evaluation (device, torch).

Port of nyx_tpu/ephem/chebyshev.py: `fit_chebyshev` is copied unchanged;
`eval_chebyshev` is the Clenshaw recurrence on torch tensors, and
`eval_chebyshev_deriv` its derivative in tau.
"""

from __future__ import annotations

import numpy as np
import torch


def fit_chebyshev(fn, t0: float, intlen: float, n_records: int, degree: int) -> np.ndarray:
    """Fit `fn(t)->[...,k]` with per-interval Chebyshev polynomials.

    Returns coeffs [n_records, k, degree+1], interpolating at the
    Chebyshev-Gauss-Lobatto nodes through the discrete cosine relation.
    """
    N = degree
    j = np.arange(N + 1)
    nodes = np.cos(np.pi * j / N)  # [1 .. -1]
    recs = []
    for i in range(n_records):
        mid = t0 + (i + 0.5) * intlen
        half = 0.5 * intlen
        ts = mid + half * nodes
        vals = np.asarray(fn(ts))  # [N+1, k]
        # c_m = (2/N) * sum'' f(x_j) cos(pi m j / N)  ('' = halve endpoints)
        w = np.ones(N + 1)
        w[0] = w[-1] = 0.5
        fw = vals * w[:, None]
        m = np.arange(N + 1)
        cosmat = np.cos(np.pi * np.outer(m, j) / N)
        c = (2.0 / N) * (cosmat @ fw)  # [N+1, k]
        c[0] *= 0.5
        c[-1] *= 0.5
        recs.append(c.T)  # [k, N+1]
    return np.stack(recs)


def eval_chebyshev(coeffs, tau):
    """Clenshaw evaluation. coeffs [..., k, D], tau [...] in [-1,1] -> [..., k]."""
    D = coeffs.shape[-1]
    x2 = 2.0 * tau[..., None]
    b1 = torch.zeros_like(coeffs[..., 0])
    b2 = torch.zeros_like(b1)
    for n in range(D - 1, 0, -1):
        b1, b2 = coeffs[..., n] + x2 * b1 - b2, b1
    return coeffs[..., 0] + tau[..., None] * b1 - b2


def eval_chebyshev_deriv(coeffs, tau):
    """d/dtau of `eval_chebyshev`: sum_n c_n n U_{n-1}(tau) by the
    second-kind Clenshaw recurrence (T_n' = n U_{n-1})."""
    D = coeffs.shape[-1]
    x2 = 2.0 * tau[..., None]
    b1 = torch.zeros_like(coeffs[..., 0])
    b2 = torch.zeros_like(b1)
    for n in range(D - 1, 0, -1):
        b1, b2 = n * coeffs[..., n] + x2 * b1 - b2, b1
    return b1
