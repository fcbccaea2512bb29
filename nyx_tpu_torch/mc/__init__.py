"""Monte Carlo: dispersions, the ensemble runs (full state and Encke
deviations, on one device or sharded over a mesh), their results, and the
seeded delta-v error helpers."""

from .dispersion import StateDispersion
from .helpers import dv_execution_error, dv_pointing_error, unit_vector_from_seed
from .montecarlo import MonteCarlo
from .multivariate import MvnSpacecraft
from .results import Results

__all__ = [
    "StateDispersion",
    "MvnSpacecraft",
    "MonteCarlo",
    "Results",
    "unit_vector_from_seed",
    "dv_pointing_error",
    "dv_execution_error",
]
