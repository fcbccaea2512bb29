"""Measurement noise models.

Host-side numpy copy of nyx_tpu/od/noise.py:21-135: `WhiteNoise`,
`GaussMarkov`, `StochasticNoise` (white + optional Gauss-Markov bias, with
the DSN default magnitudes) and `NoiseState`. Sampling draws from a
caller-provided `numpy.random.Generator`, so a simulated arc is
deterministic in one seed and draws the reference's numbers for the same
schedule; the variances are plain floats that the filter's R uses. The
link-budget helpers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class WhiteNoise:
    """Zero-mean white noise of constant sigma."""

    sigma: float

    def covariance(self) -> float:
        return self.sigma**2

    def sample(self, rng: np.random.Generator) -> float:
        return rng.normal(0.0, self.sigma)


@dataclass
class GaussMarkov:
    """First-order Gauss-Markov bias process: over dt the exact update
    x' = e^(-dt/tau) x + N(0, s^2 (1 - e^(-2 dt/tau))), s the steady-state
    sigma `process_noise`."""

    tau_s: float
    process_noise: float

    def covariance(self) -> float:
        return self.process_noise**2

    def init_sample(self, rng: np.random.Generator) -> float:
        return rng.normal(0.0, self.process_noise)

    def advance(self, bias: float, dt_s: float, rng: np.random.Generator) -> float:
        if dt_s <= 0.0:
            return bias
        phi = np.exp(-dt_s / self.tau_s)
        s = self.process_noise * np.sqrt(max(0.0, 1.0 - phi * phi))
        return phi * bias + rng.normal(0.0, s)


@dataclass
class StochasticNoise:
    """White noise + optional Gauss-Markov bias."""

    white_noise: Optional[WhiteNoise] = None
    bias: Optional[GaussMarkov] = None

    @classmethod
    def default_range_km(cls) -> "StochasticNoise":
        # DSN defaults: 2 m white, 5 km / 12.5 d GM bias
        return cls(white_noise=WhiteNoise(2.0e-3),
                   bias=GaussMarkov(tau_s=12.5 * 86400.0, process_noise=5.0))

    @classmethod
    def default_doppler_km_s(cls) -> "StochasticNoise":
        # 3 mm/s white, 50 m/s GM
        return cls(white_noise=WhiteNoise(3.0e-6),
                   bias=GaussMarkov(tau_s=12.5 * 86400.0, process_noise=50.0e-3))

    def covariance(self) -> float:
        """Total variance used in the filter's R (white + bias steady state)."""
        c = 0.0
        if self.white_noise is not None:
            c += self.white_noise.covariance()
        if self.bias is not None:
            c += self.bias.covariance()
        return max(c, 1e-32)


class NoiseState:
    """Per-device running bias states for measurement simulation."""

    def __init__(self, noises: dict, rng: np.random.Generator):
        self.noises = noises
        self.bias = {}
        self.last_epoch_s = {}
        for mtype, n in noises.items():
            if n is not None and n.bias is not None:
                self.bias[mtype] = n.bias.init_sample(rng)
                self.last_epoch_s[mtype] = None

    def sample(self, mtype: str, t_s: float, rng: np.random.Generator) -> float:
        n = self.noises.get(mtype)
        if n is None:
            return 0.0
        out = 0.0
        if n.white_noise is not None:
            out += n.white_noise.sample(rng)
        if n.bias is not None:
            prev_t = self.last_epoch_s.get(mtype)
            dt = 0.0 if prev_t is None else t_s - prev_t
            self.bias[mtype] = n.bias.advance(self.bias[mtype], dt, rng)
            self.last_epoch_s[mtype] = t_s
            out += self.bias[mtype]
        return out
