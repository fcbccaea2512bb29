from .gravity import GravityFieldData

__all__ = ["GravityFieldData"]
