from .frames import Frame, Frames
from .orbit import Orbit
from .spacecraft import Spacecraft

__all__ = ["Frame", "Frames", "Orbit", "Spacecraft"]
