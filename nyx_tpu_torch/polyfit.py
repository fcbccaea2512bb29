"""Polynomials: evaluation, derivative, fitting helpers.

Counterpart of the reference's `polyfit` module (polyfit/polynomial.rs:29,
248): fixed-size `Polynomial` with coefficients in INCREASING order of
degree (the reference's convention), `CommonPolynomial`
(Constant/Linear/Quadratic) used by finite-burn angle profiles, and
Lagrange/Hermite fitting helpers. Port of nyx_tpu/polyfit.py:
`Polynomial`, `CommonPolynomial` and `lagrange` are the reference's host
numpy code (a `Polynomial` evaluates Horner's rule on a float or a tensor);
`hermite_eval` runs in torch float64 on its inputs' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Polynomial:
    """Coefficients low-order-first: p(t) = c0 + c1 t + c2 t^2 + ...
    (polynomial.rs:29)."""

    coefficients: Tuple[float, ...]

    @classmethod
    def from_most_significant(cls, coeffs: Sequence[float]) -> "Polynomial":
        return cls(tuple(reversed([float(c) for c in coeffs])))

    @property
    def order(self) -> int:
        return len(self.coefficients) - 1

    def eval(self, t):
        # Horner, low-order-first storage
        acc = 0.0
        for c in reversed(self.coefficients):
            acc = acc * t + c
        return acc

    def deriv(self, t):
        acc = 0.0
        n = len(self.coefficients)
        for k in range(n - 1, 0, -1):
            acc = acc * t + k * self.coefficients[k]
        return acc

    def derivative(self) -> "Polynomial":
        return Polynomial(
            tuple(k * c for k, c in enumerate(self.coefficients))[1:]
            or (0.0,)
        )

    def coeff_in_order(self, order: int) -> float:
        """(polynomial.rs coeff_in_order)."""
        if order >= len(self.coefficients):
            raise IndexError(f"polynomial has no order-{order} coefficient")
        return self.coefficients[order]

    def __str__(self):
        terms = [
            f"{c:+.6g}{'' if k == 0 else f' t^{k}' if k > 1 else ' t'}"
            for k, c in enumerate(self.coefficients)
        ]
        return "P(t) = " + " ".join(terms)


class CommonPolynomial:
    """Constant/Linear/Quadratic constructors (polynomial.rs:248), stored
    most-significant-first in the reference's enum payloads."""

    @staticmethod
    def Constant(a: float) -> Polynomial:
        return Polynomial((a,))

    @staticmethod
    def Linear(a: float, b: float) -> Polynomial:
        """a t + b."""
        return Polynomial((b, a))

    @staticmethod
    def Quadratic(a: float, b: float, c: float) -> Polynomial:
        """a t^2 + b t + c."""
        return Polynomial((c, b, a))


def lagrange(xs: Sequence[float], ys: Sequence[float]) -> Polynomial:
    """Exact Lagrange interpolating polynomial through the points."""
    coeffs = np.polyfit(np.asarray(xs), np.asarray(ys), len(xs) - 1)
    return Polynomial.from_most_significant(coeffs)


def hermite_eval(xs, ys, ydots, t):
    """Hermite interpolation of value+derivative samples at t; returns
    (value, derivative) — the kernel behind trajectory interpolation
    (md/trajectory/interpolatable.rs hermite). Float64 tensors on the
    device of `xs` (or of `t`, or the CPU), by divided differences on
    doubled nodes, the reference's table column by column."""
    dev = next((a.device for a in (xs, t) if isinstance(a, torch.Tensor)), torch.device("cpu"))
    f64 = dict(dtype=torch.float64, device=dev)
    xs, ys, ydots, t = (a.to(**f64) if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a, dtype=np.float64), **f64) for a in (xs, ys, ydots, t))
    n = xs.shape[0]
    z = torch.repeat_interleave(xs, 2)
    cols = []
    c0 = torch.repeat_interleave(ys, 2)
    cols.append(c0)
    c1 = torch.zeros(2 * n, **f64)
    c1[1::2] = ydots
    c1[2::2] = (ys[1:] - ys[:-1]) / (xs[1:] - xs[:-1])
    cols.append(c1)
    for j in range(2, 2 * n):
        cj = torch.zeros(2 * n, **f64)
        cj[j:] = (cols[j - 1][j:] - cols[j - 1][j - 1:-1]) / (z[j:] - z[:2 * n - j])
        cols.append(cj)
    # Newton-form evaluation + derivative
    val = cols[2 * n - 1][2 * n - 1]
    dval = torch.zeros((), **f64)
    for k in range(2 * n - 2, -1, -1):
        dval = dval * (t - z[k]) + val
        val = val * (t - z[k]) + cols[k][k]
    return val, dval
