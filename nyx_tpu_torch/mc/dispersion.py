"""State dispersions: per-parameter distributions for Monte Carlo.

Counterpart of the reference's `Dispersion`/`StateDispersion`
(mc/generator.rs:27-66, mc/dispersion.rs:29).

Copied from nyx_tpu/mc/dispersion.py (plain Python).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StateDispersion:
    """Normal dispersion of one StateParameter (1-sigma unless noted)."""

    parameter: str
    std_dev: float
    mean: float = 0.0

    @classmethod
    def zero_mean(cls, parameter: str, std_dev: float) -> "StateDispersion":
        return cls(parameter, std_dev)

    @classmethod
    def from_3std_dev(cls, parameter: str, three_sigma: float) -> "StateDispersion":
        return cls(parameter, three_sigma / 3.0)
