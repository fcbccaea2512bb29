"""nyx_tpu_torch: the PyTorch/CUDA port of nyx_tpu.

Batched orbit propagation and Monte Carlo on torch tensors, with the Pines
gravity recursion as a hand-written CUDA kernel for NVIDIA Hopper
(`csrc/pines.cu`). The module tree mirrors `nyx_tpu`; this package imports
torch and numpy only, never JAX or `nyx_tpu`.

States are float64 tensors on an explicit device; positions in km,
velocities in km/s, epochs in TAI/TDB seconds past J2000.
"""

from .cosmic.bplane import BPlane, BPlaneTarget, try_achieve_b_plane
from .cosmic.frames import Frame, Frames
from .cosmic.orbit import Orbit
from .cosmic.spacecraft import Spacecraft
from .propagators import IntegratorOptions, Propagator
from .time import Duration, Epoch

__all__ = [
    "Epoch",
    "Duration",
    "Frame",
    "Frames",
    "Orbit",
    "Spacecraft",
    "BPlane",
    "BPlaneTarget",
    "try_achieve_b_plane",
    "IntegratorOptions",
    "Propagator",
]
