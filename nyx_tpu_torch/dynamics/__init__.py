from .drag import AtmDensity, Drag
from .gravity import Harmonics
from .orbital import OrbitalDynamics
from .spacecraft_dyn import SpacecraftDynamics
from .srp import SolarPressure

__all__ = [
    "OrbitalDynamics",
    "Harmonics",
    "SpacecraftDynamics",
    "Drag",
    "AtmDensity",
    "SolarPressure",
]
