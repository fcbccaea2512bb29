from .drag import AtmDensity, Drag
from .gravity import Harmonics
from .guidance import GuidanceLaw, LocalFrame, Ruggiero
from .orbital import OrbitalDynamics, PointMasses
from .spacecraft_dyn import SpacecraftDynamics
from .srp import SolarPressure

__all__ = [
    "OrbitalDynamics",
    "PointMasses",
    "Harmonics",
    "SpacecraftDynamics",
    "Drag",
    "AtmDensity",
    "SolarPressure",
    "GuidanceLaw",
    "LocalFrame",
    "Ruggiero",
]
