"""Tools: Lambert solvers and porkchop scans (torch port of nyx_tpu/tools/,
the reference's nyx-core/src/tools/)."""

from .lambert import LambertInput, LambertSolution, TransferKind, gooding, izzo, lambert_izzo_rv
from .porkchop import Porkchop, porkchop, porkchop_grid

__all__ = [
    "LambertInput",
    "LambertSolution",
    "TransferKind",
    "gooding",
    "izzo",
    "lambert_izzo_rv",
    "Porkchop",
    "porkchop",
    "porkchop_grid",
]
