from .dispersion import StateDispersion
from .montecarlo import MonteCarlo
from .multivariate import MvnSpacecraft
from .results import Results

__all__ = ["StateDispersion", "MvnSpacecraft", "MonteCarlo", "Results"]
