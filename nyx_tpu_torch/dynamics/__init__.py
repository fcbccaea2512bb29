from .drag import AtmDensity, Drag
from .gravity import Harmonics
from .guidance import (
    GuidanceLaw,
    ImpulsiveManeuver,
    Kluever,
    LocalFrame,
    Maneuver,
    ManeuverSequence,
    ParametricManeuver,
    Ruggiero,
    ThrustDirectionReplay,
)
from .orbital import OrbitalDynamics, PointMasses
from .sequence import (
    DiscreteEvent,
    DynamicsConfig,
    Phase,
    PhysicalProperties,
    PropagatorConfig,
    SpacecraftSequence,
)
from .solid_tides import SolidTides, TidalPerturber
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
    "SolidTides",
    "TidalPerturber",
    "GuidanceLaw",
    "LocalFrame",
    "Ruggiero",
    "Kluever",
    "Maneuver",
    "ManeuverSequence",
    "ImpulsiveManeuver",
    "ThrustDirectionReplay",
    "ParametricManeuver",
    "PhysicalProperties",
    "DiscreteEvent",
    "DynamicsConfig",
    "PropagatorConfig",
    "Phase",
    "SpacecraftSequence",
]
