from .error_ctrl import ErrorControl
from .options import IntegratorOptions
from .propagator import Propagator
from .tableaus import IntegratorMethod

__all__ = ["IntegratorMethod", "IntegratorOptions", "ErrorControl", "Propagator"]
