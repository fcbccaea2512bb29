from .trajectory import Trajectory
from .param import StateParameter
from .events import Event
from .objective import Objective

__all__ = ["Trajectory", "StateParameter", "Event", "Objective"]
