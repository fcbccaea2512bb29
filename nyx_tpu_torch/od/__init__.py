"""Orbit determination: one- and two-way tracking simulation by ground
stations (on the spacecraft's body or, through centre-offset tables, on
another) and by interlink transmitters, and the staged batched filters (the
CKF, with Gauss-Newton iterations, and the segmented reference-update EKF)."""

from .estimate import KfEstimate, Residual, SpacecraftUncertainty
from .ground_station import GroundStation, TerrainMask
from .interlink import DeviceTrajectory, InterlinkTxSpacecraft
from .kalman import ProcessNoise
from .msr import Measurement, MeasurementType, TrackingDataArc
from .noise import GaussMarkov, NoiseState, StochasticNoise, WhiteNoise
from .scan_filter import ScanKalmanOD, ScanODResult
from .simulator import Cadence, Scheduler, Strand, TrackingArcSim, TrkConfig

__all__ = [
    "Cadence",
    "DeviceTrajectory",
    "GaussMarkov",
    "GroundStation",
    "InterlinkTxSpacecraft",
    "KfEstimate",
    "Measurement",
    "MeasurementType",
    "NoiseState",
    "ProcessNoise",
    "Residual",
    "ScanKalmanOD",
    "ScanODResult",
    "Scheduler",
    "SpacecraftUncertainty",
    "StochasticNoise",
    "Strand",
    "TerrainMask",
    "TrackingArcSim",
    "TrackingDataArc",
    "TrkConfig",
    "WhiteNoise",
]
