"""Measurement noise models.

Host-side numpy copy of nyx_tpu/od/noise.py: `WhiteNoise`, `GaussMarkov`,
`StochasticNoise` (white + optional Gauss-Markov bias, with the DSN default
magnitudes) and `NoiseState` (:21-135), and the link-budget noises
(:130-216, the reference's od/noise/link_specific.rs): `SN0`, `CN0`,
`CarrierFreq`, `ChipRate`, `WhiteNoise.from_pr_n0` and
`StochasticNoise.from_hardware_range_km` / `from_hardware_doppler_km_s`.
Sampling draws from a caller-provided `numpy.random.Generator`, so a
simulated arc is deterministic in one seed and draws the reference's numbers
for the same schedule; the variances are plain floats that the filter's R
uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional

import numpy as np

from ..constants import SPEED_OF_LIGHT_KM_S as _SPEED_OF_LIGHT_KM_S

_TAU = 2.0 * np.pi


class SN0:
    """Signal-power-to-noise-density ratio, in Hz (not dB-Hz)."""

    Strong = 10.0 ** 6.5  # 65 dB-Hz
    Average = 10.0 ** 5  # 50 dB-Hz
    Poor = 10.0 ** 4  # 40 dB-Hz

    @staticmethod
    def from_db_hz(db: float) -> float:
        return 10.0 ** (db / 10.0)


class CN0:
    """Carrier-power-to-noise-density ratio, in Hz."""

    Strong = 10.0 ** 7  # 70 dB-Hz
    Average = 10.0 ** 5.5  # 55 dB-Hz
    Poor = 10.0 ** 4.5  # 45 dB-Hz

    @staticmethod
    def from_db_hz(db: float) -> float:
        return 10.0 ** (db / 10.0)


class CarrierFreq:
    """Typical carrier frequencies, Hz."""

    SBand = 2.2e9
    XBand = 8.4e9
    KaBand = 32e9


class ChipRate:
    """Typical ranging chip rates, chip/s."""

    Lowest = 1e3
    Low = 1e5
    StandardT4B = 1e6
    High = 1e7
    VeryHigh = 2.5e7


@dataclass(frozen=True)
class WhiteNoise:
    """Zero-mean white noise of constant sigma."""

    sigma: float

    def covariance(self) -> float:
        return self.sigma**2

    def sample(self, rng: np.random.Generator) -> float:
        return rng.normal(0.0, self.sigma)

    @staticmethod
    def from_pr_n0(pr_n0: float, bandwidth_hz: float) -> "WhiteNoise":
        """sigma = c / (2 B sqrt(Pr/N0)), km."""
        return WhiteNoise(_SPEED_OF_LIGHT_KM_S / (2.0 * bandwidth_hz * np.sqrt(pr_n0)))


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

    ZERO: ClassVar["StochasticNoise"]  # no noise; set below

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

    @classmethod
    def default_angle_deg(cls) -> "StochasticNoise":
        return cls(white_noise=WhiteNoise(1.0e-2))

    @classmethod
    def zero(cls) -> "StochasticNoise":
        """A perfect (noiseless) measurement."""
        return cls(white_noise=WhiteNoise(0.0))

    @staticmethod
    def from_hardware_range_km(allan_deviation, integration_time_s,
                               chip_rate=None, s_n0=None) -> "StochasticNoise":
        """Range noise from the clock (Allan deviation over the integration
        time) and the thermal noise (chip rate, S/N0), root-sum-squared; no
        atmosphere (~10 cm one-sigma more)."""
        chip_rate = ChipRate.StandardT4B if chip_rate is None else chip_rate
        s_n0 = SN0.Average if s_n0 is None else s_n0
        sigma_thermal = _SPEED_OF_LIGHT_KM_S / (_TAU * chip_rate * np.sqrt(2.0 * s_n0))
        sigma_clock = _SPEED_OF_LIGHT_KM_S * allan_deviation * integration_time_s / np.sqrt(3.0)
        return StochasticNoise(white_noise=WhiteNoise(float(np.hypot(sigma_clock, sigma_thermal))))

    @staticmethod
    def from_hardware_doppler_km_s(allan_deviation, integration_time_s,
                                   carrier=None, c_n0=None) -> "StochasticNoise":
        """Doppler noise from the clock and the carrier's thermal noise."""
        carrier = CarrierFreq.XBand if carrier is None else carrier
        c_n0 = CN0.Average if c_n0 is None else c_n0
        sigma_thermal = _SPEED_OF_LIGHT_KM_S / (
            _TAU * carrier * np.sqrt(2.0 * c_n0 * integration_time_s))
        sigma_clock = _SPEED_OF_LIGHT_KM_S * allan_deviation
        return StochasticNoise(white_noise=WhiteNoise(float(np.hypot(sigma_clock, sigma_thermal))))

    def covariance(self) -> float:
        """Total variance used in the filter's R (white + bias steady state)."""
        c = 0.0
        if self.white_noise is not None:
            c += self.white_noise.covariance()
        if self.bias is not None:
            c += self.bias.covariance()
        return max(c, 1e-32)


StochasticNoise.ZERO = StochasticNoise(white_noise=WhiteNoise(0.0))


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
