"""nyx_tpu_torch: the PyTorch/CUDA port of nyx_tpu.

Batched orbit propagation and Monte Carlo on torch tensors, with the Pines
gravity recursion as a hand-written CUDA kernel for NVIDIA Hopper
(`csrc/pines.cu`). The module tree mirrors `nyx_tpu`; this package imports
torch and numpy only, never JAX or `nyx_tpu`.

States are float64 tensors on an explicit device; positions in km,
velocities in km/s, epochs in TAI/TDB seconds past J2000.
"""

__version__ = "0.2.0"

from .time import Epoch, Duration, Unit  # noqa: E402
from .constants import GM  # noqa: E402
from .cosmic.frames import Frame, Frames  # noqa: E402
from .cosmic.orbit import Orbit  # noqa: E402
from .cosmic.spacecraft import GuidanceMode, Spacecraft, Thruster  # noqa: E402
from .cosmic.bplane import BPlane, BPlaneTarget, try_achieve_b_plane  # noqa: E402
from .cosmic.eclipse import EclipseState, ShadowModel  # noqa: E402
from .propagators import IntegratorOptions, Propagator  # noqa: E402
from .md.events import Event  # noqa: E402
from .md.objective import Objective  # noqa: E402
from .md.param import StateParameter  # noqa: E402
from .md.trajectory import Trajectory  # noqa: E402
from .tracing import annotate, enable_logging, profile_trace  # noqa: E402

__all__ = [
    "annotate",
    "enable_logging",
    "profile_trace",
    "Epoch",
    "Duration",
    "Unit",
    "GM",
    "Frame",
    "Frames",
    "Orbit",
    "Spacecraft",
    "Thruster",
    "GuidanceMode",
    "BPlane",
    "BPlaneTarget",
    "try_achieve_b_plane",
    "EclipseState",
    "ShadowModel",
    "IntegratorOptions",
    "Propagator",
    "Event",
    "Objective",
    "StateParameter",
    "Trajectory",
]
