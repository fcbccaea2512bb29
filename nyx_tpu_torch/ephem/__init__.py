from .almanac import Almanac, EphemTable

__all__ = ["Almanac", "EphemTable"]
