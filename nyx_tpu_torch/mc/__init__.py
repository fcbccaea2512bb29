"""Monte Carlo: dispersions, the ensemble runs (full state and Encke
deviations) and their results. The reference's `mc/helpers.py`
(`unit_vector_from_seed`, `dv_pointing_error`, `dv_execution_error`) is not
ported yet."""

from .dispersion import StateDispersion
from .montecarlo import MonteCarlo
from .multivariate import MvnSpacecraft
from .results import Results

__all__ = ["StateDispersion", "MvnSpacecraft", "MonteCarlo", "Results"]
