"""Orbit determination: one- and two-way tracking simulation, and the staged
batched filters (the CKF, with Gauss-Newton iterations, and the segmented
reference-update EKF)."""

from .estimate import KfEstimate, SpacecraftUncertainty
from .ground_station import GroundStation
from .kalman import ProcessNoise
from .msr import Measurement, MeasurementType, TrackingDataArc
from .noise import GaussMarkov, NoiseState, StochasticNoise, WhiteNoise
from .scan_filter import ScanKalmanOD, ScanODResult
from .simulator import Scheduler, Strand, TrackingArcSim, TrkConfig

__all__ = [
    "GaussMarkov",
    "GroundStation",
    "KfEstimate",
    "Measurement",
    "MeasurementType",
    "NoiseState",
    "ProcessNoise",
    "ScanKalmanOD",
    "ScanODResult",
    "Scheduler",
    "SpacecraftUncertainty",
    "StochasticNoise",
    "Strand",
    "TrackingArcSim",
    "TrackingDataArc",
    "TrkConfig",
    "WhiteNoise",
]
