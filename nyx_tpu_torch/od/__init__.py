"""Orbit determination: one- and two-way tracking simulation by ground
stations (on the spacecraft's body or, through centre-offset tables, on
another), by interlink transmitters and by GNSS position devices; the
staged batched filters (the CKF, with Gauss-Newton iterations, and the
segmented reference-update EKF); the per-measurement host loop
(`KalmanODProcess`) with its solution, smoother and statistics; batch least
squares; ground-point PNT; and CCSDS TDM files (importing this package
attaches `TrackingDataArc.to_tdm` and `from_tdm`)."""

from . import tdm as _tdm  # noqa: F401  (attaches TrackingDataArc.to_tdm / from_tdm)
from .blse import BatchLeastSquares, BLSSolution, BLSSolver
from .estimate import KfEstimate, Residual, SpacecraftUncertainty
from .ground_station import GroundStation, TerrainMask
from .groundpnt import GroundAsset, GroundPntProcess, GroundPntSim
from .interlink import DeviceTrajectory, InterlinkTxSpacecraft
from .kalman import KalmanFilter, KalmanVariant, ProcessNoise, ProcessNoise3D
from .msr import Measurement, MeasurementType, TrackingDataArc
from .noise import GaussMarkov, NoiseState, StochasticNoise, WhiteNoise
from .position import PositionDevice
from .process import KalmanODProcess, SpacecraftKalmanOD, SpacecraftKalmanScalarOD
from .scan_filter import ScanKalmanOD, ScanODResult
from .simulator import Cadence, Scheduler, Strand, TrackingArcSim, TrkConfig
from .solution import ODSolution

__all__ = [
    "BLSSolution",
    "BLSSolver",
    "BatchLeastSquares",
    "Cadence",
    "DeviceTrajectory",
    "GaussMarkov",
    "GroundAsset",
    "GroundPntProcess",
    "GroundPntSim",
    "GroundStation",
    "InterlinkTxSpacecraft",
    "KalmanFilter",
    "KalmanODProcess",
    "KalmanVariant",
    "KfEstimate",
    "Measurement",
    "MeasurementType",
    "NoiseState",
    "ODSolution",
    "PositionDevice",
    "ProcessNoise",
    "ProcessNoise3D",
    "Residual",
    "ScanKalmanOD",
    "ScanODResult",
    "Scheduler",
    "SpacecraftKalmanOD",
    "SpacecraftKalmanScalarOD",
    "SpacecraftUncertainty",
    "StochasticNoise",
    "Strand",
    "TerrainMask",
    "TrackingArcSim",
    "TrackingDataArc",
    "TrkConfig",
    "WhiteNoise",
]
