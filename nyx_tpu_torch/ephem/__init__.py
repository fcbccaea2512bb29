from .almanac import Almanac, EphemTable, default_almanac
from .daf import BPC, DAF, SPK

__all__ = ["Almanac", "EphemTable", "default_almanac", "DAF", "SPK", "BPC"]
